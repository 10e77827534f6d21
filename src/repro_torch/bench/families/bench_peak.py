"""Paper Figures 2/6 (compute) and 8 (memory): peak rate vs problem size.

Sweeps task duration at fixed graph shape and reports achieved FLOP/s
(compute kernel) and B/s (memory kernel, constant working set) — the
100%-efficiency baselines every METG below is measured against.  Thin
wrapper over ``repro_torch.bench`` scenarios with an explicit sweep schedule.
"""
from __future__ import annotations

from typing import List

from ..metg import geometric_iterations
from ..scenario import ScenarioSpec, SweepControls

from .common import BenchContext, Row


def _sweep(ctx: BenchContext, kernel: str, iterations_hi: int,
           **graph_kw) -> List[Row]:
    spec = ScenarioSpec(
        name=f"peak.{kernel}",
        backend="torch-scan",
        pattern="stencil",
        kernel=kernel,
        width=8,
        height=32,
        graph_kw=tuple(sorted(graph_kw.items())),
        sweep=SweepControls(
            schedule=tuple(geometric_iterations(iterations_hi, 4, 4.0))),
    )
    res = ctx.run(spec).metg
    unit = "flops" if kernel == "compute" else "bytes"
    rows = [
        Row(f"peak_{kernel}.iters{p.iterations}",
            p.granularity * 1e6,
            f"rate_{unit}_per_s={p.rate:.4g};eff={p.efficiency:.3f}")
        for p in res.points
    ]
    rows.append(Row(f"peak_{kernel}.PEAK", 0.0,
                    f"peak_{unit}_per_s={res.peak_rate:.4g};"
                    f"metg50_us={(res.metg or 0) * 1e6:.2f}"))
    return rows


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    rows = _sweep(ctx, "compute", 65536)
    rows += _sweep(ctx, "memory", 2048, span_bytes=16 * 1024,
                   scratch_bytes=1 << 20)
    return rows
