"""Minimum Effective Task Granularity — the paper's §IV metric.

METG(e) for a workload is the smallest *average task granularity* (wall time
x cores / #tasks) at which the workload still achieves at least fraction
``e`` of its best observed rate (FLOP/s for compute kernels, B/s for memory
kernels).

The harness sweeps task duration (kernel iterations) from large to small at
fixed graph shape and hardware (paper: "measured in place"), replots the
points on (granularity, efficiency) axes and log-interpolates the 50 %
crossing, exactly as paper Figures 2-3 construct it.

This module is pure math over ``SweepPoint`` records: it imports nothing
from the rest of the package.  Measurement — how wall times are produced —
lives in ``bench.timers`` and ``bench.sweep``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


@dataclass
class SweepPoint:
    iterations: int
    wall_time: float  # seconds, best of repeats
    num_tasks: int
    useful_work: float  # FLOPs or bytes
    granularity: float = 0.0  # seconds per task (x cores)
    rate: float = 0.0  # work / second
    efficiency: float = 0.0  # rate / peak_rate


@dataclass
class METGResult:
    metg: Optional[float]  # seconds; None if curve never crosses
    threshold: float
    peak_rate: float
    points: List[SweepPoint] = field(default_factory=list)

    def csv_rows(self) -> List[str]:
        rows = []
        for p in sorted(self.points, key=lambda p: -p.iterations):
            rows.append(
                f"{p.iterations},{p.wall_time:.6e},{p.granularity:.6e},"
                f"{p.rate:.6e},{p.efficiency:.4f}"
            )
        return rows


def time_run(fn: Callable[[], None], repeats: int = 3) -> float:
    """Best-of-N wall time of fn() (fn must block until complete)."""
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_point(graphs: Sequence, iterations: int, wall: float,
                cores: int = 1) -> SweepPoint:
    """Build the sweep point for one measured execution of ``graphs``.

    The single definition of granularity (wall x cores / #tasks) and
    useful work, shared by the legacy callable API (``run_sweep``) and the
    scenario harness (``bench.sweep.run_scenario``).
    """
    num_tasks = sum(g.num_tasks for g in graphs)
    work = sum(g.total_useful_work() for g in graphs)
    return SweepPoint(
        iterations=iterations,
        wall_time=wall,
        num_tasks=num_tasks,
        useful_work=work,
        granularity=wall * cores / num_tasks,
    )


def run_sweep(
    make_runner: Callable[[int], Callable[[], None]],
    graphs_at: Callable[[int], Sequence],
    iterations_list: Sequence[int],
    cores: int = 1,
    repeats: int = 3,
) -> List[SweepPoint]:
    """Measure wall time for each task duration in the sweep.

    ``make_runner(iters)`` returns a zero-arg callable that executes the
    workload to completion (compile/warmup must happen before timing: the
    harness invokes the runner once untimed).  ``graphs_at(iters)`` returns
    the ``TaskGraph`` list the runner executes (consulted for task counts
    and useful work only).
    """
    points = []
    for iters in iterations_list:
        graphs = list(graphs_at(iters))
        runner = make_runner(iters)
        runner()  # warmup / compile
        wall = time_run(runner, repeats=repeats)
        points.append(sweep_point(graphs, iters, wall, cores=cores))
    return points


def observed_peak(points: Sequence[SweepPoint]) -> float:
    """The 100 %-efficiency baseline: best rate in the sweep (paper §V-A).

    The single definition of self-normalization, shared by
    ``efficiency_curve`` and ``compute_metg``.  Points must have ``rate``
    filled in.
    """
    return max((p.rate for p in points), default=0.0)


def efficiency_curve(
    points: Sequence[SweepPoint],
    peak_rate: Optional[float] = None,
) -> List[SweepPoint]:
    """Replot sweep points on (granularity, efficiency) axes.

    Returns fresh ``SweepPoint`` copies with ``rate`` and ``efficiency``
    filled in; ``peak_rate`` defaults to ``observed_peak`` of the sweep
    itself (the empirically-achieved peak is the 100 % baseline).
    """
    pts = [SweepPoint(**vars(p)) for p in points]
    for p in pts:
        p.rate = p.useful_work / p.wall_time if p.wall_time > 0 else 0.0
    if peak_rate is None:
        peak_rate = observed_peak(pts)
    for p in pts:
        p.efficiency = p.rate / peak_rate if peak_rate > 0 else 0.0
    return pts


def compute_metg(
    points: Sequence[SweepPoint],
    threshold: float = 0.5,
    peak_rate: Optional[float] = None,
) -> METGResult:
    """Build the efficiency curve and find the threshold crossing."""
    pts = efficiency_curve(points, peak_rate=peak_rate)
    if peak_rate is None:
        peak_rate = observed_peak(pts)
    if peak_rate <= 0:
        return METGResult(metg=None, threshold=threshold, peak_rate=0.0, points=pts)

    # The smallest granularity still >= threshold; if the next smaller
    # point dips below, log-interpolate the crossing (robust to small
    # non-monotonicity from timing noise).
    ordered = sorted(pts, key=lambda p: -p.granularity)
    above = [p for p in ordered if p.efficiency >= threshold]
    if not above:
        return METGResult(metg=None, threshold=threshold,
                          peak_rate=peak_rate, points=pts)
    prev = above[-1]  # smallest granularity at/above threshold
    metg: Optional[float] = prev.granularity
    below = [p for p in ordered
             if p.granularity < prev.granularity and p.efficiency < threshold]
    if below:
        p = below[0]  # largest-granularity point below threshold
        if prev.efficiency > p.efficiency and p.granularity > 0:
            lo_g, hi_g = math.log(p.granularity), math.log(prev.granularity)
            lo_e, hi_e = p.efficiency, prev.efficiency
            frac = (threshold - lo_e) / (hi_e - lo_e)
            metg = math.exp(lo_g + frac * (hi_g - lo_g))
    return METGResult(metg=metg, threshold=threshold, peak_rate=peak_rate, points=pts)


def geometric_iterations(hi: int, lo: int = 1, factor: float = 2.0) -> List[int]:
    """Sweep schedule: hi, hi/f, ... down to lo (deduplicated)."""
    if not 1 <= lo <= hi:
        raise ValueError(f"need 1 <= lo <= hi, got lo={lo}, hi={hi}")
    out, x = [], float(hi)
    while x >= lo:
        v = max(lo, int(round(x)))
        if not out or v != out[-1]:
            out.append(v)
        x /= factor
    if out[-1] != lo:
        out.append(lo)
    return out
