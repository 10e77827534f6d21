"""Declarative benchmark scenarios: what to measure, as plain data.

A ``ScenarioSpec`` names one cell of the paper's measurement space —
dependence pattern x kernel x payload x imbalance x number of concurrent
graphs x backend — plus the sweep controls (``SweepControls``) that decide
how task granularity is swept.  Specs compile to runnable graph lists via
``core.make_graph``/``replicate`` and are executed by
``bench.sweep.run_scenario`` under a pluggable ``Timer``.

Smoke mode is a *spec parameter* (``SweepControls.smoke``), not ambient
state: ``resolved()`` returns the spec a smoke run actually measures
(tiny schedule, one repeat, shallow graphs), so CI and full sweeps share
one code path and the artifact records which controls were in force.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..core.graph import TaskGraph, make_graph, replicate
from .metg import geometric_iterations

# smoke-mode ceilings: declarative, so sweeps are reproducible from the spec
SMOKE_ITERATIONS_HI = 64
SMOKE_N_POINTS = 3
SMOKE_HEIGHT = 8


@dataclass(frozen=True)
class SweepControls:
    """How task granularity is swept and timed for one scenario."""

    iterations_hi: int = 4096
    iterations_lo: int = 1
    n_points: int = 7
    repeats: int = 3          # timed repetitions per point (wall-clock timer)
    warmup: int = 1           # untimed runs before timing (compile/caches)
    percentile: float = 0.0   # 0 => best-of-repeats; else percentile of samples
    threshold: float = 0.5    # METG efficiency threshold (paper: 50 %)
    schedule: Optional[Tuple[int, ...]] = None  # explicit iteration list
    smoke: bool = False       # CI mode: shrink the sweep to a token size

    def __post_init__(self):
        if self.iterations_lo < 1:
            raise ValueError("iterations_lo must be >= 1")
        if self.iterations_hi < self.iterations_lo:
            raise ValueError(
                f"iterations_hi ({self.iterations_hi}) must be >= "
                f"iterations_lo ({self.iterations_lo})")
        if self.n_points < 1:
            raise ValueError("n_points must be >= 1")
        if self.schedule is not None and (
                not self.schedule or any(s < 1 for s in self.schedule)):
            raise ValueError("schedule must be a non-empty list of "
                             "iteration counts >= 1")

    def resolved(self) -> "SweepControls":
        """The controls actually used (smoke ceilings applied)."""
        if not self.smoke:
            return self
        schedule = self.schedule
        if schedule is not None:
            capped: List[int] = []
            for s in schedule:
                v = min(int(s), SMOKE_ITERATIONS_HI)
                if v not in capped:
                    capped.append(v)
            schedule = tuple(capped[:SMOKE_N_POINTS])
        return dataclasses.replace(
            self,
            iterations_hi=min(self.iterations_hi, SMOKE_ITERATIONS_HI),
            # cap the floor too: replace() re-validates hi >= lo
            iterations_lo=min(self.iterations_lo, SMOKE_ITERATIONS_HI),
            n_points=min(self.n_points, SMOKE_N_POINTS),
            repeats=1,
            warmup=min(self.warmup, 1),
            schedule=schedule,
        )

    def iteration_schedule(self) -> List[int]:
        """Task durations to sweep, largest first."""
        c = self.resolved()
        if c.schedule is not None:
            return list(c.schedule)
        factor = max(2.0, c.iterations_hi ** (1.0 / max(c.n_points - 1, 1)))
        return geometric_iterations(c.iterations_hi, c.iterations_lo,
                                    factor)[: c.n_points]


@dataclass(frozen=True)
class ScenarioSpec:
    """One measurement scenario: graph family x backend x sweep controls."""

    name: str
    backend: str = "torch-scan"
    pattern: str = "stencil"
    kernel: str = "compute"
    width: int = 8
    height: int = 32
    output_bytes: int = 16
    imbalance: float = 0.0
    ngraphs: int = 1          # concurrent task graphs (paper Fig 9d)
    cores: int = 1            # granularity = wall * cores / tasks
    graph_kw: Tuple[Tuple[str, object], ...] = ()  # radix/seed/span_bytes/...
    sweep: SweepControls = field(default_factory=SweepControls)

    def __post_init__(self):
        if not self.name:
            raise ValueError("scenario needs a name (artifact key)")
        if self.ngraphs < 1:
            raise ValueError("ngraphs must be >= 1")

    @property
    def slug(self) -> str:
        """Filesystem-safe scenario key: BENCH_<slug>.json."""
        return re.sub(r"[^A-Za-z0-9_.-]+", "-", self.name)

    def resolved(self) -> "ScenarioSpec":
        """The spec a run actually measures (smoke ceilings applied)."""
        if not self.sweep.smoke:
            return self
        return dataclasses.replace(
            self,
            height=min(self.height, SMOKE_HEIGHT),
            sweep=self.sweep.resolved(),
        )

    # -- compilation to runnable graphs -------------------------------------
    def graph(self, iterations: int) -> TaskGraph:
        return make_graph(
            width=self.width,
            height=self.height,
            pattern=self.pattern,
            kernel=self.kernel,
            iterations=iterations,
            output_bytes=self.output_bytes,
            imbalance=self.imbalance,
            **dict(self.graph_kw),
        )

    def graphs(self, iterations: int) -> List[TaskGraph]:
        """The concurrent graph list ``run_many`` executes."""
        return replicate(self.graph(iterations), self.ngraphs)

    def make_backend(self):
        from ..backends import get_backend  # deferred: imports torch

        return get_backend(self.backend)

    def with_smoke(self, smoke: bool = True) -> "ScenarioSpec":
        return dataclasses.replace(
            self, sweep=dataclasses.replace(self.sweep, smoke=smoke))
