"""Paper Figure 9: METG(50%) per backend per dependence pattern.

Patterns as in §V-C: (a) stencil, (b) nearest with 5 deps, (c) spread with
5 deps, (d) 4 concurrent nearest graphs (task parallelism, executed
concurrently through ``Backend.run_many``).  All backends run all cases —
the O(m+n) property in action.  Thin wrapper over ``repro_torch.bench``.
"""
from __future__ import annotations

from typing import List

from ...backends import backend_names

from .common import BenchContext, Row, metg_for

CASES = [
    ("stencil", {}, 1),
    ("nearest", {"radix": 5}, 1),
    ("spread", {"radix": 5}, 1),
    ("nearest_x4", {"radix": 5}, 4),
]


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    backends = [b for b in backend_names() if ctx.wants_backend(b)]
    if not backends:
        raise ValueError(
            f"--backends filter {ctx.backends!r} matches none of the "
            f"registered backends {backend_names()}")
    rows: List[Row] = []
    for be in backends:
        hi = 1024 if be == "torch-host" else 4096
        for case, kw, ngraphs in CASES:
            pattern = "nearest" if case == "nearest_x4" else case
            res = metg_for(ctx, be, pattern, name=f"metg.{be}.{case}",
                           num_graphs=ngraphs, iterations_hi=hi,
                           n_points=6, **kw)
            metg_us = (res.metg or float("nan")) * 1e6
            rows.append(Row(f"metg.{be}.{case}", metg_us,
                            f"peak_flops_per_s={res.peak_rate:.4g}"))
    return rows
