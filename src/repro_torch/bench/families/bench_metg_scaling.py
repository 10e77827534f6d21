"""Paper Figures 4/5 (§V-D/E): weak-scaling efficiency vs granularity.

Fixed work per rank (``width_per_rank`` graph columns), rank count swept
over {1, 2, 4, 8} (``ctx.ranks`` narrows it) in this process: the rank
count is a backend option (``torch-csp[ranks=N]``, ``bench.scaling``).
Each (backend, ranks) cell runs the ordinary METG sweep; the assembled
``kind="metg_scaling"`` artifact records per-rank elapsed, weak-scaling
efficiency ``T(1)/T(n)``, and the efficiency-vs-granularity contour —
the paper's scaling study compressed against the overhead floor.

Backends: only those whose ``CommPlan`` paths are multi-rank
(``torch-csp``/``torch-pipeline``, each also in ``comm=onesided`` mode,
plus the ``torch-auto`` planner, which on the wall clock has no rank
option and raises).  Single-device backends would measure nothing under a
rank sweep.
"""
from __future__ import annotations

from typing import List

from ..scaling import RANKS, SCALING_BACKENDS, ScalingSpec

from .common import BenchContext, Row

# artifact-friendly scenario labels (spec option brackets make ugly slugs)
_LABELS = {
    "torch-csp": "torch-csp",
    "torch-csp[comm=onesided]": "torch-csp.onesided",
    "torch-pipeline": "torch-pipeline",
    "torch-pipeline[comm=onesided]": "torch-pipeline.onesided",
    "torch-auto": "torch-auto",
}


def _label(backend: str) -> str:
    return _LABELS.get(backend, backend.replace("[", ".").replace("]", ""))


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    backends = [b for b in SCALING_BACKENDS if ctx.wants_backend(b)]
    if not backends:
        # zero cells exiting 0 would green-light a typo'd --backends
        # filter; name both sides of the mismatch
        raise ValueError(
            f"--backends filter {ctx.backends!r} matches none of this "
            f"family's backends {list(SCALING_BACKENDS)}")
    rows: List[Row] = []
    for be in backends:
        spec = ScalingSpec(name=f"metg_scaling.{_label(be)}", backend=be,
                           ranks=ctx.ranks or RANKS)
        res = ctx.run_scaling(spec)
        for c in res.cells:
            rows.append(Row(
                f"{spec.name}.r{c['ranks']}",
                c["elapsed_s"] * 1e6,
                f"width={c['width']};weak_eff={c['weak_efficiency']:.3f};"
                f"granularity_us={c['granularity_s'] * 1e6:.2f}"))
    return rows
