"""Published peaks of the card and the work of each kernel and graph run.

The benchmark states every share against NVIDIA's published figures for one
H100 SXM (dense, no sparsity, at its 700 W limit), never against a rate the
card reports: 67 TFLOP/s of float32 outside the tensor cores and 3.35 TB/s
of HBM3.

Bytes follow one rule for every kernel: each input byte read once and each
output byte written once, counting only what the inputs need.  The memory
kernel's scratch is the task's working set, and Task Bench defines that
kernel by the bytes it moves, so a window that gets at least one
application counts as read once and written once, and a window that gets
none is not counted.  Operations are the body's multiplies and adds, one
each, over every iteration a task runs.

A kernel's bound is the larger of its operations over the float32 peak and
its bytes over the HBM peak.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

from portbench.reference.taskbench import memory_geometry

FP32_PEAK_FLOPS = 67e12
HBM_PEAK_BYTES_S = 3.35e12

TILE_ELEMS = 8 * 128
F32 = 4
I32 = 4


class Work(NamedTuple):
    ops: float
    bytes: float

    @property
    def bound_s(self) -> float:
        return max(self.ops / FP32_PEAK_FLOPS, self.bytes / HBM_PEAK_BYTES_S)


def windows_touched(iterations: int, nwin: int) -> int:
    """Windows of one scratch row that get at least one application."""
    return min(max(iterations, 0), nwin)


def body_ops(graph: Mapping, iterations: int) -> float:
    """Operations of one task's kernel body over its iterations."""
    if graph["kind"] == "compute":
        return 2.0 * TILE_ELEMS * iterations
    if graph["kind"] == "memory":
        return 2.0 * memory_geometry(graph)[0] * iterations
    raise KeyError(graph["kind"])


def body_bytes(graph: Mapping, iterations: int) -> float:
    """Bytes one task's memory body needs: its touched windows read and
    written once.  The compute body's tile is 4 KiB of registers."""
    if graph["kind"] != "memory":
        return 0.0
    span, _, nwin = memory_geometry(graph)
    return 2.0 * F32 * span * windows_touched(iterations, nwin)


def k1(graph: Mapping) -> Work:
    """K1 (``taskbench_compute``), one launch a timestep: W tiles read and
    written, W int32 counts read."""
    W, n = int(graph["width"]), int(graph["iterations"])
    return Work(W * body_ops(graph, n), W * (2 * TILE_ELEMS * F32 + I32))


def k2(graph: Mapping) -> Work:
    """K2 (``taskbench_memory``), one launch a timestep over W scratch
    rows: the touched windows read and written, W int32 counts read."""
    W, n = int(graph["width"]), int(graph["iterations"])
    return Work(W * body_ops(graph, n), W * (body_bytes(graph, n) + I32))


def k3(graph: Mapping, ngraphs: int = 1) -> Work:
    """K3 (``taskbench_fused``), one launch a run: the dependency, mask,
    iteration and checksum tables read (int32), the last wave written, and
    every task's body."""
    H, W = int(graph["height"]), int(graph["width"])
    n = int(graph["iterations"])
    radix = int(graph["radix"])
    tables = H * W * (2 * radix + 2) * I32
    payload = max(5, int(graph["output_bytes"]) // 4)
    tasks = H * W
    return Work(ngraphs * tasks * body_ops(graph, n),
                ngraphs * (tables + W * payload * F32
                           + tasks * body_bytes(graph, n)))


def useful_flops(graph: Mapping) -> float:
    """Task Bench's useful work of one graph run, in operations."""
    return int(graph["height"]) * int(graph["width"]) * body_ops(
        graph, int(graph["iterations"]))


def useful_bytes(graph: Mapping) -> float:
    """Task Bench's useful work of one graph run, in bytes."""
    return int(graph["height"]) * int(graph["width"]) * body_bytes(
        graph, int(graph["iterations"]))
