"""Paper Figure 12: efficiency under load imbalance.

Task durations scaled by a deterministic uniform factor (paper §V-G);
nearest pattern, 5 deps, 4 concurrent graphs.  The timestep-loop backend
(``torch-scan``) executes masked full-length loops (cannot exploit short tasks — the
BSP/MPI analogue); host dispatch (``torch-host``) runs true per-task durations and recovers
part of the imbalance, the paper's asynchronous-scheduling benefit.

Efficiency here is relative to each backend's own balanced peak (the
balanced scenario's ``peak_rate`` pins the imbalanced sweep's baseline),
so the derived column isolates the imbalance penalty.  Thin wrapper over
``repro_torch.bench``.
"""
from __future__ import annotations

from typing import List

from .common import BenchContext, Row, metg_for


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    rows: List[Row] = []
    for be, hi in (("torch-scan", 4096), ("torch-host", 512)):
        base = metg_for(ctx, be, "nearest", name=f"imbalance.{be}.balanced",
                        radix=5, num_graphs=4, iterations_hi=hi,
                        n_points=5, height=16)
        imb = metg_for(ctx, be, "nearest", name=f"imbalance.{be}.imbalanced",
                       radix=5, num_graphs=4, iterations_hi=hi,
                       n_points=5, height=16, imbalance=1.0,
                       peak_rate=base.peak_rate)
        for p in sorted(imb.points, key=lambda p: -p.iterations):
            rows.append(Row(
                f"imbalance.{be}.iters{p.iterations}",
                p.granularity * 1e6, f"eff_vs_balanced_peak={p.efficiency:.3f}"))
        best_imb = max((p.rate for p in imb.points), default=0.0)
        rows.append(Row(
            f"imbalance.{be}.summary",
            (imb.metg or float("nan")) * 1e6,
            f"balanced_peak={base.peak_rate:.4g};imb_best={best_imb:.4g};"
            f"peak_retained={best_imb / base.peak_rate:.3f}"))
    return rows
