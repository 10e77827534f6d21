"""Passes of the run loop with the program's own recorder on
(``repro_torch.trace``), and what the per-layer metrics ``host_launch_us``,
``k3_wait_share`` and ``idle_host_share`` read from them.

The readers run after the measured window, the kernels timed alone and the
profiled slice, and before the witness run, so each pass comes after
everything the other metrics read.  A pass runs at most once a cell, the
first time a reader asks for it:

``pass_a``
    the run loop, unprofiled, for ``SLICE_S`` and ``SLICE_RUNS`` at least:
    the program's spans and K3's counters;
``pass_b``
    the same under the profiler as ``trace.profile_runs`` sets it up (the
    device alone): the device's timeline, whose idle gaps the program's
    own spans attribute (``idle_by_host``).

Each pass's outputs are held to the reference as the window's are
(``reference.compare``), and a mismatch raises: K3's traced instance is
judged too.  On the CPU, or where the program has no recorder, a pass is
None and so is every reader.  The reductions take plain tuples, so they
are tested without a card: a span is ``(name, start_ns, end_ns, parent,
run)``, ``parent`` the index of the enclosing span or -1; a counter
``(name, span, run, values)``.
"""
from __future__ import annotations

import importlib
import statistics
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from portbench import harness, trace

SLICE_S = 0.25
SLICE_RUNS = 2
HOST = ("launch", "copy", "run", "between_runs")  # idle the host caused


class Pass(NamedTuple):
    spans: List[tuple]
    counters: List[tuple]
    events: Optional[List[trace.Ev]]  # pass B's device timeline


class IdleSplit(NamedTuple):
    window_s: float  # the first run's start to the last run's end
    idle_s: float  # the window less the union of device operations
    by_activity: Dict[str, float]  # idle seconds by what the host was in


def pass_a(ctx) -> Optional[Pass]:
    if not hasattr(ctx, "recorded_a"):
        ctx.recorded_a = _record(ctx, profiled=False)
    return ctx.recorded_a


def pass_b(ctx) -> Optional[Pass]:
    if not hasattr(ctx, "recorded_b"):
        ctx.recorded_b = _record(ctx, profiled=True)
    return ctx.recorded_b


def _record(ctx, profiled: bool) -> Optional[Pass]:
    if ctx.device.type != "cuda":
        return None
    try:
        program_trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    outputs, prof = [], None
    with program_trace.recording() as rec:
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _run_loop(ctx.loop.run, outputs)
                torch.cuda.synchronize()
        else:
            _run_loop(ctx.loop.run, outputs)
    _judge(ctx, outputs)
    return Pass(list(rec.spans), list(rec.counters),
                trace.kineto_events(prof) if profiled else None)


def _run_loop(run, sink: list) -> None:
    t0, n = time.perf_counter(), 0
    while n < SLICE_RUNS or time.perf_counter() - t0 < SLICE_S:
        sink.append(run())
        n += 1


def _judge(ctx, outputs) -> None:
    """Raise unless every output of the pass equals the reference's wave."""
    name = ctx.cell.config["reference"]
    ref = harness.load_module(
        ctx.cell.root / harness.PKG / "reference" / f"{name}.py",
        "reference_" + name)
    got = ref.compare(ref.final_wave(ctx.graph).numpy(), outputs,
                      ctx.loop.ngraphs)
    bad = {k: v for k, v in got.items() if v > ref.LIMITS[k]}
    if bad:
        raise RuntimeError(f"a run with the program's recorder on differs "
                           f"from the reference: {bad}")


def runs(spans: Sequence[tuple]) -> List[Tuple[int, List[tuple]]]:
    """Each ``run`` span's index and its child spans, in order."""
    children: Dict[int, List[tuple]] = {}
    for sp in spans:
        children.setdefault(sp[3], []).append(sp)
    return [(k, children.get(k, [])) for k, sp in enumerate(spans)
            if sp[0] == "run" and sp[3] == -1]


def launch_us(spans: Sequence[tuple]) -> Optional[float]:
    """The mean ``launch`` span of a run, in us."""
    took = [(c[2] - c[1]) / 1e3 for _, kids in runs(spans) for c in kids
            if c[0] == "launch"]
    return statistics.fmean(took) if took else None


def wait_share(counters: Sequence[tuple]) -> Optional[float]:
    """K3's cycles in the dependency combine (its polls and their sum)
    over its cycles from each task's start to its signal store, summed over
    every CTA of every launch, in %."""
    total = {"k3.wait_cycles": 0, "k3.task_cycles": 0}
    for name, _, _, values in counters:
        if name in total:
            total[name] += sum(values)
    if total["k3.task_cycles"] <= 0:
        return None
    return 100.0 * total["k3.wait_cycles"] / total["k3.task_cycles"]


def coverage(spans: Sequence[tuple]) -> List[float]:
    """For each run, the share of its span that ``launch``, ``wait`` and
    ``copy`` cover."""
    out = []
    for k, kids in runs(spans):
        s, e = spans[k][1], spans[k][2]
        inner = sum(c[2] - c[1] for c in kids
                    if c[0] in ("launch", "wait", "copy"))
        out.append(inner / (e - s) if e > s else 1.0)
    return out


def activities(spans: Sequence[tuple]) -> List[Tuple[str, int, int]]:
    """What the host was in from the first run's start to the last run's
    end, as labelled intervals that tile it: a run's ``launch``, ``wait``
    and ``copy`` (its child spans), ``run`` for the rest of a run, and
    ``between_runs``."""
    out: List[Tuple[str, int, int]] = []
    for k, kids in runs(spans):
        s, e = spans[k][1], spans[k][2]
        if out and s > out[-1][2]:
            out.append(("between_runs", out[-1][2], s))
        at = s
        for c in sorted(kids, key=lambda c: c[1]):
            cs, ce = max(c[1], at), min(c[2], e)
            if cs > at:
                out.append(("run", at, cs))
            if ce > cs:
                out.append((c[0], cs, ce))
                at = ce
        if e > at:
            out.append(("run", at, e))
    return out


def idle_by_host(spans: Sequence[tuple], events: Sequence[trace.Ev]
                 ) -> Optional[IdleSplit]:
    """The device's idle time in the runs' window, split by what the host
    was in (``activities``): idle in ``wait`` is the device's own, idle in
    ``launch``, ``copy``, the rest of a run or between runs the host's."""
    acts = activities(spans)
    if not acts:
        return None
    w0, w1 = acts[0][1], acts[-1][2]
    busy = trace.union([(max(e.start_ns, w0), min(e.end_ns, w1))
                        for e in events
                        if e.device and e.end_ns > w0 and e.start_ns < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    split: Dict[str, float] = {}
    j = 0
    for label, s, e in acts:
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < e:
            o = min(e, idle[k][1]) - max(s, idle[k][0])
            if o > 0:
                split[label] = split.get(label, 0.0) + o / 1e9
            k += 1
    return IdleSplit((w1 - w0) / 1e9, sum(b - a for a, b in idle) / 1e9,
                     split)


def host_share(split: IdleSplit) -> Optional[float]:
    """The idle the host caused over the window, in %."""
    if split is None or split.window_s <= 0:
        return None
    host = sum(v for k, v in split.by_activity.items() if k in HOST)
    return 100.0 * host / split.window_s
