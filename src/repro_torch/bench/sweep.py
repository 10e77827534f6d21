"""Scenario execution: spec -> sweep points -> efficiency curve -> METG.

``run_scenario`` is the one entry point the benchmark scripts (and tests)
call: it resolves the spec (smoke ceilings), walks the iteration schedule,
asks the ``Timer`` for the wall time of each point's concurrent graph list,
and reduces the points to a ``METGResult``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .metg import METGResult, SweepPoint, compute_metg, sweep_point
from .scenario import ScenarioSpec
from .timers import Timer, WallClockTimer, timer_config


@dataclass
class ScenarioResult:
    """One scenario's measured sweep, ready for the artifact writer."""

    spec: ScenarioSpec      # the *resolved* spec that was measured
    timer: str              # timer name ("wallclock" | "synthetic" | ...)
    metg: METGResult
    # the timer's actual parameters — authoritative over spec.sweep's
    # warmup/repeats/percentile when a timer override was supplied
    timer_config: Dict[str, object] = field(default_factory=dict)

    @property
    def points(self) -> List[SweepPoint]:
        return self.metg.points

    @property
    def peak_rate(self) -> float:
        return self.metg.peak_rate

    @property
    def metg_s(self) -> Optional[float]:
        return self.metg.metg


def run_scenario(
    spec: ScenarioSpec,
    timer: Optional[Timer] = None,
    peak_rate: Optional[float] = None,
) -> ScenarioResult:
    """Measure one scenario under ``timer`` (default: wall clock).

    ``peak_rate`` pins the 100 %-efficiency baseline externally (e.g. the
    balanced peak when measuring an imbalance penalty); by default the
    sweep self-normalizes against its own best rate.
    """
    spec = spec.resolved()
    if timer is None:
        timer = WallClockTimer(warmup=spec.sweep.warmup,
                               repeats=spec.sweep.repeats,
                               percentile=spec.sweep.percentile)
    points: List[SweepPoint] = []
    for iters in spec.sweep.iteration_schedule():
        graphs = spec.graphs(iters)
        wall = timer.measure(spec.backend, graphs)
        points.append(sweep_point(graphs, iters, wall, cores=spec.cores))
    result = compute_metg(points, threshold=spec.sweep.threshold,
                          peak_rate=peak_rate)
    return ScenarioResult(spec=spec, timer=timer.name, metg=result,
                          timer_config=timer_config(timer))
