"""Study: load-imbalance mitigation vs schedule (paper §V-G, Fig. 12/13).

Imbalance-factor sweep at fixed task granularity for ``torch-host``
under its two executor schedules: static column ownership vs greedy
work stealing (``schedule="steal"``).  Derived metric: mitigation factor
= observed rate / the same schedule's balanced rate — see
``repro_torch.bench.studies``.

On the synthetic timer (``workers=4`` plus a per-iteration rate that
makes task work dominate dispatch overhead) the wavefront makespans are
deterministic, so the artifacts show the stealing schedule's strictly
better mitigation factor at imbalance=2.0, as the reference's do.  Thin wrapper over ``repro_torch.bench.studies``.
"""
from __future__ import annotations

from typing import List

from ..studies import (IMBALANCE_FACTORS,
                                 IMBALANCE_SECONDS_PER_ITERATION,
                                 IMBALANCE_VARIANTS, STUDY_WORKERS,
                                 imbalance_spec, mitigation_curve,
                                 study_timer)

from .common import BenchContext, Row


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    timer = study_timer(
        ctx.timer, workers=STUDY_WORKERS,
        seconds_per_iteration=IMBALANCE_SECONDS_PER_ITERATION)
    rows: List[Row] = []
    results = {}
    for schedule in IMBALANCE_VARIANTS:
        for imb in (0.0,) + IMBALANCE_FACTORS:
            spec = imbalance_spec(schedule=schedule, imbalance=imb)
            results[(imb, schedule)] = ctx.run(spec, timer=timer)
    curve = mitigation_curve(results)
    for pt in curve:
        rows.append(Row(
            f"metg_imbalance.torch-host.{pt.variant}.imb{pt.x}",
            pt.elapsed_s * 1e6,
            f"mitigation={pt.metric:.3f}"))
    by_key = {(pt.x, pt.variant): pt.metric for pt in curve}
    for imb in IMBALANCE_FACTORS:
        static, steal = by_key[(imb, "static")], by_key[(imb, "steal")]
        rows.append(Row(
            f"metg_imbalance.torch-host.advantage.imb{imb}",
            0.0,
            f"steal_over_static={steal / static:.3f}"))
    return rows
