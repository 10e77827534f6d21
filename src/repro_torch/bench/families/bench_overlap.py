"""Paper Figure 11: efficiency vs task granularity for varying payloads.

Spread pattern, 5 deps/task, 4 concurrent graphs (through ``run_many``);
``output_bytes`` sweeps the communication volume per dependency.  Compares
the CSP backend (strict compute/communicate alternation, like MPI) against
the whole-graph captured backend (``cuda-graph``, the counterpart of the
reference's ``xla-static``) — the paper's
asynchronous-systems-win-under-communication finding.  Thin wrapper over
``repro_torch.bench``.
"""
from __future__ import annotations

from typing import List

from .common import BenchContext, Row, metg_for

BYTES = [16, 4096, 65536]


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    rows: List[Row] = []
    for be in ("torch-csp", "cuda-graph"):
        for ob in BYTES:
            res = metg_for(ctx, be, "spread",
                           name=f"overlap.{be}.bytes{ob}",
                           radix=5, num_graphs=4, output_bytes=ob,
                           iterations_hi=4096, n_points=6, height=24)
            for p in sorted(res.points, key=lambda p: -p.iterations):
                rows.append(Row(
                    f"overlap.{be}.bytes{ob}.iters{p.iterations}",
                    p.granularity * 1e6,
                    f"eff={p.efficiency:.3f}"))
            rows.append(Row(f"overlap.{be}.bytes{ob}.METG",
                            (res.metg or float("nan")) * 1e6,
                            f"peak={res.peak_rate:.4g}"))
    return rows
