"""Static-dataflow backend ``cuda-graph``: the unrolled schedule, captured once.

Counterpart of ``xla-static``, the analogue of the paper's statically
compiled systems (PaRSEC PTG, Regent control replication, TensorFlow
graphs): the schedule is fixed ahead of time, the per-task runtime overhead
is ~zero and the cost moves to set-up.  The program is ``torch-scan``'s
loop over timesteps (``scanvec._scan``, ``t`` a Python int at each step,
over the same staged inputs), so both backends run the same operations.
XLA unrolls that loop into one compiled program; here it is captured once
as one ``torch.cuda.CUDAGraph``.  A run is one ``cudaGraphLaunch`` from the
host, and the card issues every timestep's kernels (20 for the compute
kind, K1 or K2 among them) itself.

On the card, ``prepare`` and ``prepare_many`` stage the inputs, run the
program once eagerly on a side stream, then capture it on that stream and
instantiate the graph.  The eager run builds the kernel library, loads
every kernel and initialises whatever is lazy, none of which may happen
during a capture.  So the capture sits where the reference compiles, in
``prepare``, outside the runs a ``WallClockTimer`` times.  A run replays
the graph and copies its output to numpy, which waits for the device.  On
the CPU (``device=cpu``) the same program runs eagerly: nothing is
captured, and nothing falls back.

The reference's ``donate`` option is stored and never read, so it has no
counterpart here: the only option is ``device``.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Sequence

import torch

from ..kernels import taskbench_compute, taskbench_memory
from .base import register_backend
from .scanvec import ScanBackend


class CapturedProgram:
    """``program`` captured once as a CUDA graph on ``device``; a call
    replays the graph and returns its output tensors, which every replay
    overwrites.

    ``capture_s`` and ``instantiate_s`` are the host seconds of the capture
    and of the graph's instantiation; ``nodes`` counts, for each kernel
    wrapper of ``counters`` (K1 and K2 unless given), the launches recorded
    by the capture, each a kernel node of the graph (the wrappers' counters
    count at capture, never at replay); ``pool_bytes`` is the device memory
    the graph's private pool holds.  The eager warm-up runs ``program``
    once for real, so a program that updates state in place leaves it
    updated.

    Dead objects are collected before the capture and the collector is
    off during it: an object freed mid-capture can touch the legacy
    default stream (a pinned host buffer that served an asynchronous copy
    records an event there when it is freed), which invalidates the
    capture.
    """

    def __init__(self, program: Callable, device: torch.device,
                 counters: Sequence[Callable] = (taskbench_compute,
                                                 taskbench_memory)):
        # the graph reads the staged inputs the program holds by address:
        # they must live as long as the graph
        self.program = program
        with torch.cuda.device(device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                program()
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            before = [fn.launches for fn in counters]
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            collecting = gc.isenabled()
            gc.disable()
            try:
                t0 = time.perf_counter()
                with torch.cuda.graph(self.graph, stream=stream):
                    self.outputs = program()
                t1 = time.perf_counter()
            finally:
                if collecting:
                    gc.enable()
            self.graph.instantiate()
            self.instantiate_s = time.perf_counter() - t1
            self.capture_s = t1 - t0
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.nodes = {fn.__name__: fn.launches - n
                      for fn, n in zip(counters, before)}

    def __call__(self):
        self.graph.replay()
        return self.outputs


@register_backend("cuda-graph")
class DataflowBackend(ScanBackend):
    paradigm = "static dataflow (PTG/Regent analogue): one captured CUDA graph"

    def _executable(self, program: Callable) -> Callable:
        if self.device.type == "cuda":
            return CapturedProgram(program, self.device)
        return program
