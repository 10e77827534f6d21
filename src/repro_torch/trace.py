"""Spans and counters of the port's runner and kernels, kept only while
``recording()`` is on.

A span is one stretch of the host's work: a name, its start and end, the
span it was opened inside and the run it belongs to.  A span opened while
no other is open starts a run, and every span opened inside it carries
that run's id.  Both ends are stamped with ``time.time_ns()``, the clock
``torch.profiler`` puts its device events in, so spans and device
operations share one timeline.

A counter is a named integer a kernel keeps on the device, one per row of
a buffer the kernel's wrapper asks for (``device_counters``), registered
under the span open at the time.  The buffers are read back when
recording ends, after one synchronise: nothing is synchronised or copied
on the hot path.

Off, the default, ``span`` checks a module flag and returns one shared
no-op context: it allocates and records nothing.  Recording is for the
thread that turns it on, the one that calls the runner.

    with trace.recording() as rec:
        runner()
    rec.spans, rec.counters            # plain tuples, once it has ended

What the port records:

* ``run``, and inside it ``launch`` (the program's call, until the host has
  issued the work), ``wait`` (until the device has finished it) and
  ``copy`` (the copy to the host and the numpy split):
  ``backends/base.py``, ``StackedProgramBackend``'s runners;
* ``fused.check``, ``fused.alloc``, ``fused.launch`` (the library call) in
  ``backends/megakernel.py::taskbench_fused``, and K3's counters
  ``K3_COUNTERS`` there, one row per CTA (``kernels/csrc/fused.cu``);
* ``graph.replay`` in ``backends/dataflow.py::CapturedProgram``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index in ``Recording.spans`` of the enclosing span, or -1
    run: int  # index of the run's outermost span


class Counter(NamedTuple):
    name: str
    span: int  # index of the span open when the buffer was asked for
    run: int
    values: Tuple[int, ...]  # one per row of the buffer (K3: per CTA)


class Recording:
    """What one ``recording()`` kept: ``spans`` in the order they opened,
    ``counters`` in the order their buffers were asked for; both filled
    when recording ends."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: List[Counter] = []
        # a span's fields by index, in flat lists: recording makes no
        # container a span, which would feed the garbage collector
        self._names: List[str] = []
        self._starts: List[int] = []
        self._ends: List[int] = []
        self._parents: List[int] = []
        self._runs: List[int] = []
        self._open: List[int] = []
        self._device: List[Tuple[Sequence[str], torch.Tensor, int, int]] = []

    def _finish(self) -> None:
        for dev in {t.device for _, t, _, _ in self._device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.spans = [Span(*f) for f in zip(self._names, self._starts,
                                            self._ends, self._parents,
                                            self._runs)]
        self.counters = [
            Counter(name, sid, run, tuple(column))
            for names, buf, sid, run in self._device
            for name, column in zip(names, buf.cpu().T.tolist())]
        self._device.clear()


_ACTIVE: Optional[Recording] = None
_OFF = contextlib.nullcontext()


class _Open:
    """One span while it is open."""

    __slots__ = ("rec", "name", "id")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        parent = rec._open[-1] if rec._open else -1
        self.id = len(rec._names)
        rec._names.append(self.name)
        rec._parents.append(parent)
        rec._runs.append(rec._runs[parent] if parent >= 0 else self.id)
        rec._ends.append(0)
        rec._open.append(self.id)
        rec._starts.append(time.time_ns())
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rec._ends[self.id] = end
        self.rec._open.pop()
        return False


def active() -> bool:
    """Whether recording is on."""
    return _ACTIVE is not None


def span(name: str):
    """A context that records the span ``name`` while recording is on."""
    rec = _ACTIVE
    if rec is None:
        return _OFF
    return _Open(rec, name)


def wait(device: torch.device) -> None:
    """The runner's ``wait`` span: while recording, an event recorded on
    ``device``'s current stream and synchronised, so the copy after it only
    copies.  Off, nothing: the copy waits for the device itself."""
    rec = _ACTIVE
    if rec is None:
        return
    with _Open(rec, "wait"):
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            done.synchronize()


def device_counters(names: Sequence[str], rows: int,
                    device: torch.device) -> Optional[torch.Tensor]:
    """While recording: a new ``(rows, len(names))`` int64 buffer on
    ``device``, column k for counter ``names[k]``, registered under the open
    span and read back when recording ends.  It is not zeroed: the kernel
    writes every entry.  Off: None."""
    rec = _ACTIVE
    if rec is None:
        return None
    buf = torch.empty((rows, len(names)), dtype=torch.int64, device=device)
    sid = rec._open[-1] if rec._open else -1
    run = rec._runs[sid] if sid >= 0 else -1
    rec._device.append((tuple(names), buf, sid, run))
    return buf


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record spans and counters for the block; the ``Recording`` yielded
    holds them once the block has ended without raising."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("recording is already on")
    rec = _ACTIVE = Recording()
    try:
        yield rec
    finally:
        _ACTIVE = None
    rec._finish()
