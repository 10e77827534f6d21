"""Timers: how a scenario's wall time is produced.

The ``Timer`` protocol and ``WallClockTimer``, copied from the reference's
``repro.bench.timers`` with backend names resolved in the port's registry.
``WallClockTimer`` prepares the backend's concurrent program once and times
repeated blocking executions: a runner returns numpy, which waits for the
device, so each sample covers the device's work.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Protocol, Sequence, runtime_checkable

from ..core.graph import TaskGraph


@runtime_checkable
class Timer(Protocol):
    """Produces the wall time of one complete multi-graph execution."""

    name: str

    def measure(self, backend_name: str, graphs: Sequence[TaskGraph]) -> float:
        """Seconds for one blocking execution of ``graphs`` (concurrently)."""
        ...


def timer_config(timer: Timer) -> Dict[str, object]:
    """The timer's public parameters, for the result record.

    A custom (non-dataclass) Timer may expose its own ``config()`` dict;
    otherwise its settings are unrecorded (empty dict).
    """
    if hasattr(timer, "config") and callable(timer.config):
        return dict(timer.config())
    if dataclasses.is_dataclass(timer):
        return {f.name: getattr(timer, f.name)
                for f in dataclasses.fields(timer)
                if f.repr and f.name != "name"}
    return {}


def cached_backend(cache: Dict[str, object], backend_name: str):
    """Per-timer backend cache (one backend object per spec string)."""
    if backend_name not in cache:
        from ..backends import get_backend

        cache[backend_name] = get_backend(backend_name)
    return cache[backend_name]


def pick_sample(samples: Sequence[float], percentile: float) -> float:
    """Select the reported time: <=0 -> min (best-of-N), else percentile."""
    if not samples:
        raise ValueError("no timing samples")
    if percentile <= 0:
        return min(samples)
    ordered = sorted(samples)
    idx = max(0, min(len(ordered) - 1,
                     math.ceil(percentile / 100.0 * len(ordered)) - 1))
    return ordered[idx]


@dataclass
class WallClockTimer:
    """Times real backend executions (prepare once, run repeatedly)."""

    warmup: int = 1
    repeats: int = 3
    percentile: float = 0.0  # 0 => best-of-repeats
    name: str = field(default="wallclock", init=False)
    _backends: Dict[str, object] = field(default_factory=dict, repr=False)

    def measure(self, backend_name: str, graphs: Sequence[TaskGraph]) -> float:
        runner = cached_backend(self._backends, backend_name).prepare_many(graphs)
        for _ in range(max(self.warmup, 0)):
            runner()
        samples: List[float] = []
        for _ in range(max(self.repeats, 1)):
            t0 = time.perf_counter()
            runner()
            samples.append(time.perf_counter() - t0)
        return pick_sample(samples, self.percentile)
