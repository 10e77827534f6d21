"""Paper Figure 14 / Table 6: predicting the scaling limit from METG.

The paper's claim: one full-size run plus the METG curve predicts where
strong scaling stops (within ~2x in node count, ~1.3x in time).  The
1-core analogue: strong-scaling a fixed total problem over n virtual
workers shrinks per-task granularity as work/n; the efficiency-limited
wall-time floor is METG(50%) x tasks.  We predict the largest useful n
from (one big run + METG), then measure where the actual curve crosses
the floor, and report the factor of separation — Table 6's statistic.

Both measurements are ``repro_torch.bench`` scenarios: the METG curve is the
standard geometric sweep, and the strong-scaling curve is the same graph
family swept over the per-worker task sizes ``TOTAL/n``.
"""
from __future__ import annotations

from typing import List

from ..scenario import ScenarioSpec, SweepControls

from .common import BenchContext, Row

TOTAL_ITERS = 16384  # total work per column-task-chain
HEIGHT = 32
NS = [1, 2, 4, 8, 16, 32, 64, 128, 256]


def _spec(name: str, schedule) -> ScenarioSpec:
    return ScenarioSpec(
        name=name, backend="torch-scan", pattern="stencil", kernel="compute",
        width=8, height=HEIGHT,
        sweep=SweepControls(schedule=tuple(schedule)),
    )


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    rows: List[Row] = []

    # METG curve (measured in place, same shape)
    metg_res = ctx.run(_spec("metg_validation.curve",
                             (4096, 1024, 256, 64, 16, 4, 1))).metg
    metg = metg_res.metg or 0.0
    num_tasks = metg_res.points[0].num_tasks if metg_res.points else 8 * HEIGHT

    # "strong scaling": n virtual workers -> per-task work TOTAL/n
    scaling = ctx.run(_spec("metg_validation.strong_scaling",
                            [max(1, TOTAL_ITERS // n) for n in NS])).metg
    walls = {p.iterations: p.wall_time for p in scaling.points}
    actual = {}
    for n in NS:
        iters = max(1, TOTAL_ITERS // n)
        if iters not in walls:  # smoke mode truncates the schedule
            continue
        actual[n] = walls[iters] / n  # per-worker wall share (ideal parallel)
        rows.append(Row(f"metg_validation.actual.n{n}", actual[n] * 1e6,
                        f"iters_per_task={iters}"))

    # prediction: ideal time = t(1)/n; limit floor = METG x per-chain tasks
    t1 = actual.get(1)
    if t1 is None and actual:  # smoke: estimate serial time from largest task
        # actual[n] = wall(TOTAL/n)/n and wall(i) ~ i (compute-dominant),
        # so t(1) = wall(TOTAL) ~ wall(TOTAL/n0) * n0 = actual[n0] * n0^2
        n0 = min(actual)
        t1 = actual[n0] * n0 * n0
    floor = metg * num_tasks / 8  # per-column-chain share
    pred_n = (t1 / floor) if (t1 and floor > 0) else float("inf")
    # measured crossing: first n whose actual per-worker time <= floor
    meas_n = None
    for n in sorted(actual):
        if actual[n] <= floor * 1.05:
            meas_n = n
            break
    meas_n = meas_n or (max(actual) if actual else NS[-1])
    sep = max(pred_n, meas_n) / max(min(pred_n, meas_n), 1e-9)
    rows.append(Row("metg_validation.summary", metg * 1e6,
                    f"pred_limit_n={pred_n:.1f};measured_limit_n={meas_n};"
                    f"separation_factor={sep:.2f}"))
    return rows
