"""Paper Figure 10: METG vs dependencies per task (nearest, radix 0..9).

The paper's headline: the 0->3 dependency step costs MPI 12x; dynamic
systems are hit hardest.  Here the same sweep contrasts the eager
timestep loop (torch-scan) and message passing (torch-csp) with per-task
host dispatch (torch-host).  Thin wrapper over ``repro_torch.bench``.
"""
from __future__ import annotations

from typing import List

from .common import BenchContext, Row, metg_for

RADII = [0, 1, 3, 5, 7, 9]


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    rows: List[Row] = []
    for be, hi in (("torch-scan", 4096), ("torch-csp", 4096),
                   ("torch-host", 1024)):
        base = None
        for r in RADII:
            res = metg_for(ctx, be, "nearest",
                           name=f"metg_deps.{be}.radix{r}",
                           radix=r, iterations_hi=hi, n_points=6, width=10)
            metg_us = (res.metg or float("nan")) * 1e6
            if r == 0:
                base = metg_us
            ratio = metg_us / base if base else float("nan")
            rows.append(Row(f"metg_deps.{be}.radix{r}", metg_us,
                            f"ratio_vs_radix0={ratio:.2f}"))
    return rows
