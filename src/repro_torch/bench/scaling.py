"""Weak-scaling study (paper §V-D/E): METG efficiency as ranks grow.

The port's copy of the reference's ``repro.bench.scaling``.  The one
Task Bench headline the single-device families cannot reproduce is the
scaling study: *fixed work per rank*, rank count swept, and the
efficiency-vs-granularity contour compressing against the overhead floor
as ranks (and therefore communication) grow.

``ScalingSpec``
    One weak-scaling cell series: a backend, a per-rank problem shape
    (``width_per_rank`` columns per rank — the graph at ``n`` ranks is
    ``n`` times wider), and the rank sweep (default ``{1, 2, 4, 8}``).

``run_scaling``
    Runs every rank count in this process and assembles the
    ``kind="metg_scaling"`` artifact: per-rank elapsed, weak-scaling
    efficiency ``T(1)/T(n)`` (ideal 1.0 — work per rank is constant), and
    the per-granularity contour.  JAX fixes its device count at process
    start, so the reference relaunches a child process per rank count; in
    the port the rank count is a backend option (``torch-csp[ranks=N]``),
    so no relaunch is needed.

Determinism: under the ``SyntheticTimer`` a cell charges the rank-count
model (``SyntheticTimer.ranks``, a pure function of ``(graph, ranks, spec
string)``), so the artifact equals the reference's with the backend
names mapped and is machine-independent; under the wall clock a cell runs
the backend with ``ranks=n`` — ``n`` rank processes for ``torch-csp`` and
``torch-pipeline`` — and records the ranks the backend ran.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .scenario import ScenarioSpec, SweepControls
from .studies import _guarded_ratio
from .sweep import run_scenario
from .timers import SyntheticTimer, Timer, WallClockTimer

RANKS: Tuple[int, ...] = (1, 2, 4, 8)

# the backends whose paths are actually multi-rank (torch-scan /
# cuda-graph / torch-host execute on one device whatever the rank count,
# so a rank sweep over them measures nothing)
SCALING_BACKENDS: Tuple[str, ...] = (
    "torch-csp",
    "torch-csp[comm=onesided]",
    "torch-pipeline",
    "torch-pipeline[comm=onesided]",
    "torch-auto",
)

WIDTH_PER_RANK = 4
# largest-first, spanning coarse (compute-bound, eff ~ 1) down to the
# overhead floor; the smoke resolution keeps the sub-64 points so even a
# smoke run has a 3-point contour
SCALING_SCHEDULE: Tuple[int, ...] = (4096, 256, 16, 1)
# a mid-size payload so the synthetic model's cross-rank comm term is
# visible against the compute term inside the rank sweep
SCALING_OUTPUT_BYTES = 4096
SCALING_SECONDS_PER_BYTE = 4e-9
SCALING_SECONDS_PER_RENDEZVOUS = 2e-6


@dataclass(frozen=True)
class ScalingSpec:
    """One weak-scaling series: fixed work per rank, swept rank count."""

    name: str
    backend: str = "torch-csp"
    pattern: str = "stencil"
    kernel: str = "compute"
    width_per_rank: int = WIDTH_PER_RANK
    height: int = 16
    output_bytes: int = SCALING_OUTPUT_BYTES
    ranks: Tuple[int, ...] = RANKS
    sweep: SweepControls = field(
        default_factory=lambda: SweepControls(schedule=SCALING_SCHEDULE,
                                              repeats=3))

    def __post_init__(self):
        if not self.name:
            raise ValueError("scaling scenario needs a name (artifact key)")
        if self.width_per_rank < 1:
            raise ValueError("width_per_rank must be >= 1")
        if not self.ranks or any(int(n) < 1 for n in self.ranks):
            raise ValueError("ranks must be a non-empty list of counts >= 1")
        if list(self.ranks) != sorted(set(int(n) for n in self.ranks)):
            raise ValueError(
                f"ranks must be strictly ascending, got {self.ranks}")
        if self.ranks[0] != 1:
            raise ValueError(
                "ranks must include 1 (the weak-scaling efficiency "
                "reference T(1) every other rank normalizes against)")

    @property
    def slug(self) -> str:
        return re.sub(r"[^A-Za-z0-9_.-]+", "-", self.name)

    def scenario_for(self, nranks: int, smoke: bool = False,
                     backend: Optional[str] = None) -> ScenarioSpec:
        """The per-rank scenario: ``nranks`` times wider, same work/rank
        (on ``backend`` where given, else the series' own)."""
        if nranks not in self.ranks:
            raise ValueError(f"rank count {nranks} not in {self.ranks}")
        return ScenarioSpec(
            name=f"{self.name}.r{nranks}",
            backend=backend or self.backend,
            pattern=self.pattern,
            kernel=self.kernel,
            width=self.width_per_rank * nranks,
            height=self.height,
            output_bytes=self.output_bytes,
            sweep=self.sweep,
        ).with_smoke(smoke)


def scaling_timer(timer: Optional[Timer]) -> Optional[Timer]:
    """Specialize a ``SyntheticTimer`` with the scaling-study comm rates.

    The per-rank ``ranks`` knob is applied per cell (``run_rank_cell``);
    other timers pass through unchanged — the study is then a real
    multi-rank measurement.
    """
    if not isinstance(timer, SyntheticTimer):
        return timer
    return dataclasses.replace(
        timer,
        seconds_per_byte=SCALING_SECONDS_PER_BYTE,
        seconds_per_rendezvous=SCALING_SECONDS_PER_RENDEZVOUS)


def rank_backend(backend: str, nranks: int) -> str:
    """``backend`` pinned to ``nranks`` ranks (``torch-csp[ranks=4]``).

    Only a backend with a ``ranks`` option can be: on the wall clock a
    rank sweep over any other would time the same run at every count.
    """
    from ..backends.base import (backend_option_signature,
                                 parse_backend_spec, with_options)

    base, kw = parse_backend_spec(backend)
    if "ranks" not in backend_option_signature(base):
        raise ValueError(
            f"metg_scaling on the wall clock needs a backend with a ranks "
            f"option, got {backend!r}")
    if kw.get("ranks", nranks) != nranks:
        raise ValueError(f"{backend!r} fixes its ranks; the rank sweep "
                         f"sets them")
    return with_options(backend, ranks=nranks)


def run_rank_cell(spec: ScalingSpec, nranks: int, smoke: bool,
                  timer: Optional[Timer]) -> Dict:
    """Measure one (spec, rank count) cell.

    ``timer``: a ``SyntheticTimer`` (charged the rank model at ``nranks``)
    or the wall clock (``None`` or a ``WallClockTimer``; the backend runs
    ``nranks`` ranks).
    """
    if isinstance(timer, SyntheticTimer):
        timer = dataclasses.replace(timer, ranks=nranks)
        result = run_scenario(spec.scenario_for(nranks, smoke=smoke),
                              timer=timer)
        devices = nranks
    elif timer is None or isinstance(timer, WallClockTimer):
        sc = spec.scenario_for(nranks, smoke=smoke,
                               backend=rank_backend(spec.backend, nranks))
        if timer is None:
            sweep = sc.resolved().sweep
            timer = WallClockTimer(warmup=sweep.warmup, repeats=sweep.repeats,
                                   percentile=sweep.percentile)
        result = run_scenario(sc, timer=timer)
        be = timer._backends[sc.backend]
        devices = getattr(be, "ndev", None) or be.ranks
    else:
        raise ValueError(
            f"metg_scaling cannot run under timer {timer.name!r}; use the "
            f"synthetic fake clock or the wall clock")
    return {
        "ranks": nranks,
        "width": result.spec.width,
        "devices": devices,
        "timer": result.timer,
        "timer_config": dict(result.timer_config),
        "sweep": _sweep_doc(result.spec.sweep),
        "points": [
            {
                "iterations": p.iterations,
                "num_tasks": p.num_tasks,
                "wall_time_s": p.wall_time,
                "granularity_s": p.granularity,
                "efficiency": p.efficiency,
            }
            for p in sorted(result.points, key=lambda p: -p.iterations)
        ],
    }


def _sweep_doc(sweep: SweepControls) -> Dict:
    doc = dataclasses.asdict(sweep)
    doc["schedule"] = (list(sweep.schedule)
                       if sweep.schedule is not None else None)
    return doc


def scaling_artifact(spec: ScalingSpec, cells: List[Dict],
                     smoke: bool) -> Dict:
    """Assemble the ``kind="metg_scaling"`` artifact from rank cells."""
    from .artifact import SCHEMA_VERSION, _canonical_backend

    cells = sorted(cells, key=lambda c: c["ranks"])
    base = {p["iterations"]: p["wall_time_s"]
            for p in cells[0]["points"]} if cells else {}
    out_cells = []
    for c in cells:
        points = []
        for p in c["points"]:
            ref = base.get(p["iterations"])
            points.append({**p, "weak_efficiency": _guarded_ratio(
                ref if ref is not None else float("nan"),
                p["wall_time_s"])})
        head = points[0] if points else {}
        out_cells.append({
            "ranks": c["ranks"],
            "width": c["width"],
            "devices": c["devices"],
            "elapsed_s": head.get("wall_time_s", 0.0),
            "granularity_s": head.get("granularity_s", 0.0),
            "weak_efficiency": head.get("weak_efficiency", 0.0),
            "points": points,
        })
    ref_sweep = cells[0]["sweep"] if cells else _sweep_doc(
        spec.scenario_for(spec.ranks[0], smoke=smoke).resolved().sweep)
    return {
        "schema": SCHEMA_VERSION,
        "kind": "metg_scaling",
        "scenario": {
            "name": spec.name,
            "backend": _canonical_backend(spec.backend),
            "pattern": spec.pattern,
            "kernel": spec.kernel,
            "width_per_rank": spec.width_per_rank,
            "height": spec.height,
            "output_bytes": spec.output_bytes,
            "ranks": [c["ranks"] for c in cells] or list(spec.ranks),
            "sweep": ref_sweep,
        },
        "timer": cells[0]["timer"] if cells else "wallclock",
        "timer_config": cells[0]["timer_config"] if cells else {},
        "cells": out_cells,
    }


@dataclass
class ScalingResult:
    """One assembled weak-scaling series, ready for the artifact writer."""

    spec: ScalingSpec
    doc: Dict

    @property
    def cells(self) -> List[Dict]:
        return self.doc["cells"]

    def cell(self, nranks: int) -> Dict:
        for c in self.cells:
            if c["ranks"] == nranks:
                return c
        raise KeyError(f"no cell for ranks={nranks}")


def run_scaling(spec: ScalingSpec, timer: Optional[Timer] = None,
                smoke: bool = False) -> ScalingResult:
    """Measure one weak-scaling series, every rank count in this process."""
    from .artifact import validate_artifact

    timer = scaling_timer(timer)
    cells = [run_rank_cell(spec, n, smoke, timer) for n in spec.ranks]
    doc = validate_artifact(scaling_artifact(spec, cells, smoke))
    return ScalingResult(spec=spec, doc=doc)


def write_scaling_json(result: ScalingResult, outdir: str) -> str:
    """Write ``BENCH_<scenario>.json`` (validated); returns the path."""
    from .artifact import write_artifact_doc

    return write_artifact_doc(result.doc, result.spec.slug, outdir)
