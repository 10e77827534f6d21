"""What the benchmark reads from ``torch.profiler`` and CUDA events.

The traced measurements, all made once the measured window has closed
(the window's own runs are timed by CUDA events in ``harness.run_cell``):

``kernel_seconds``
    one hand-written kernel alone: its launches with the cell's arguments
    captured as one CUDA graph and replayed between CUDA events, before the
    profiler first runs in the process (after a profile, a captured graph's
    replay has been seen to run 1-13 % slower for the rest of the process);
``profile_runs``
    the run loop itself (the runner called back to back) with the device
    under the profiler for a short slice, each run's call and return taken
    by the host's clock: the device's busy time and idle gaps, the device
    operations that took the most time, and what the host was doing
    during each gap.  ``torch.profiler`` on the H100 has dropped some
    kernels' records, so nothing here counts launches or times one kernel.

The reductions take plain tuples, so they are tested without a card.
"""
from __future__ import annotations

import re
import time
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

TOP = 10
KERNEL_LAUNCHES = 200
KERNEL_REPLAYS = 5


class Ev(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    device: bool


class Slice(NamedTuple):
    """The reduction of one profiled slice of the run loop."""
    window_s: float  # first run's start to the last run's end
    busy_s: float  # union of device operations inside the window
    device_ops: List[Tuple[str, float]]  # by total seconds, longest first
    idle_gaps: List[Tuple[str, float]]  # longest first, by host activity


def short_name(name: str) -> str:
    """A device operation's name without a kernel's argument list, its
    ``(anonymous namespace)`` or return type, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k] if k else name
                break
    return re.sub(r"^void ", "", name).strip()[:120]


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def kineto_events(prof) -> List[Ev]:
    """The events of a finished profile as ``Ev``, in the clock of
    ``time.time_ns``.  Profile no host annotation: the profiler draws each
    ``record_function`` range on the device's timeline too, as if it were
    device work."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [Ev(e.name(), e.start_ns(), e.end_ns(), e.device_type() == cuda)
            for e in prof.profiler.kineto_results.events()]


def host_activity(runs: Sequence[Tuple[int, int]], device: Sequence[Ev]
                  ) -> List[Tuple[str, int, int]]:
    """What the host was doing around each run, as labelled spans:
    ``program`` from a run's call to the end of the last device operation
    the run started (launching it, then waiting for it), ``copy_out`` from
    there to the run's return (the copy's return and the numpy output),
    ``between_runs`` from one run's return to the next's call."""
    spans = []
    for k, (s, e) in enumerate(runs):
        ends = [d.end_ns for d in device if s <= d.start_ns <= e]
        c = min(max(max(ends, default=e), s), e)
        spans += [("program", s, c), ("copy_out", c, e)]
        if k + 1 < len(runs):
            spans.append(("between_runs", e, runs[k + 1][0]))
    return spans


def reduce_slice(events: Sequence[Ev], runs: Sequence[Tuple[int, int]]
                 ) -> Slice:
    """Busy time, top device operations and labelled idle gaps of a slice.

    ``runs`` are the host's (call, return) times of each run, in the
    profiler's clock (``time.time_ns``); the window is the first call to
    the last return."""
    if not runs:
        raise ValueError("the profiled slice holds no run")
    w0, w1 = runs[0][0], runs[-1][1]
    dev = [e for e in events if e.device and e.end_ns > w0 and e.start_ns < w1]
    busy = union([(max(e.start_ns, w0), min(e.end_ns, w1)) for e in dev])
    totals: Dict[str, float] = {}
    for e in dev:
        key = short_name(e.name)
        totals[key] = totals.get(key, 0.0) + (e.end_ns - e.start_ns) / 1e9
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    spans = host_activity(runs, dev)
    labelled = []
    for g0, g1 in gaps:
        overlap: Dict[str, int] = {}
        for label, s, e in spans:
            o = min(g1, e) - max(g0, s)
            if o > 0:
                overlap[label] = overlap.get(label, 0) + o
        label = max(overlap, key=overlap.get) if overlap else "between_runs"
        labelled.append((label, (g1 - g0) / 1e9))
    labelled.sort(key=lambda x: -x[1])
    return Slice((w1 - w0) / 1e9, sum(e - s for s, e in busy) / 1e9, ops,
                 labelled[:TOP])


def profile_runs(run: Callable[[], object], min_seconds: float,
                 min_runs: int, sink: list) -> Slice:
    """Profile the device while the run loop runs for ``min_runs`` runs and
    ``min_seconds`` at least; each run's output is appended to ``sink``.
    Only the device is traced: recording the host's operations too raised
    ``cuda-fused``'s idle share in the slice from the ~3 % its unprofiled
    runs leave to 11-15 %."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    runs = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0, n = time.perf_counter(), 0
        while n < min_runs or time.perf_counter() - t0 < min_seconds:
            start = time.time_ns()
            sink.append(run())
            runs.append((start, time.time_ns()))
            n += 1
        torch.cuda.synchronize()
    return reduce_slice(kineto_events(prof), runs)


def kernel_seconds(call: Callable[[], object],
                   launches: int = KERNEL_LAUNCHES,
                   replays: int = KERNEL_REPLAYS) -> float:
    """Device seconds a launch of ``call``: ``launches`` calls captured as
    one CUDA graph (a graph of that kernel's nodes alone, as ``cuda-graph``
    replays them), the graph replayed ``replays`` times between two CUDA
    events, after one replay that is not timed."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            call()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / (launches * replays)
    del graph
    return seconds
