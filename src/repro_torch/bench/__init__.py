"""METG measurement on the port (paper §IV-V).

- ``metg``     — the pure metric math: sweep points, efficiency curves,
                 METG crossover (a copy of the reference's)
- ``scenario`` — declarative ``ScenarioSpec`` / ``SweepControls``
- ``timers``   — the ``Timer`` protocol and the wall clock
- ``sweep``    — ``run_scenario``: spec + timer -> ``ScenarioResult``

Multi-graph scenarios (``ngraphs >= 2``) execute concurrently through
``Backend.run_many``.
"""
from .metg import (METGResult, SweepPoint, compute_metg, efficiency_curve,
                   geometric_iterations, observed_peak, run_sweep,
                   sweep_point, time_run)
from .scenario import ScenarioSpec, SweepControls
from .timers import Timer, WallClockTimer
from .sweep import ScenarioResult, run_scenario

__all__ = [
    "METGResult",
    "SweepPoint",
    "compute_metg",
    "efficiency_curve",
    "geometric_iterations",
    "observed_peak",
    "run_sweep",
    "sweep_point",
    "time_run",
    "ScenarioSpec",
    "SweepControls",
    "Timer",
    "WallClockTimer",
    "ScenarioResult",
    "run_scenario",
]
