"""Kernel specifications for Task Bench tasks (paper Table 1, §II).

A kernel is *what a task does*; the graph is *when it may do it*.  Kernels are
parameterized by ``iterations`` (task duration), plus kernel-specific knobs
(working-set size for the memory kernel, imbalance for load-imbalance
studies).  ``flops_per_task`` / ``bytes_per_task`` give the useful-work
measures that METG efficiency is computed against.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

# The compute tile: 8 x 128 f32 values, the tile shape of the reference
# package.  The paper's AVX2 kernel uses 64 doubles; here one iteration is
# one multiply and one add over the whole tile.
COMPUTE_TILE = (8, 128)
COMPUTE_TILE_ELEMS = COMPUTE_TILE[0] * COMPUTE_TILE[1]
FLOPS_PER_ELEM_PER_ITER = 2  # a*a + a -> one mul + one add

# MXU variant: one iteration is a 128x128 @ 128x128 matmul.
MXU_DIM = 128
MXU_FLOPS_PER_ITER = 2 * MXU_DIM**3


@dataclass(frozen=True)
class KernelSpec:
    kind: str = "compute"  # compute | memory | compute_mxu | empty
    iterations: int = 16
    # memory kernel: bytes touched per iteration and total working set
    span_bytes: int = 64 * 1024
    scratch_bytes: int = 4 * 1024 * 1024
    # imbalance: task duration multiplied by U[1-imbalance, 1] per task,
    # deterministic in (t, i, seed) -- paper §V-G uses U[0, 1).
    imbalance: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("compute", "compute_mxu", "memory", "empty"):
            raise ValueError(f"unknown kernel kind {self.kind!r}")
        if self.kind == "memory" and self.span_bytes > self.scratch_bytes:
            raise ValueError("span_bytes must be <= scratch_bytes")

    def with_iterations(self, iterations: int) -> "KernelSpec":
        return replace(self, iterations=iterations)

    @property
    def flops_per_task(self) -> float:
        if self.kind == "compute":
            return float(self.iterations * COMPUTE_TILE_ELEMS * FLOPS_PER_ELEM_PER_ITER)
        if self.kind == "compute_mxu":
            return float(self.iterations * MXU_FLOPS_PER_ITER)
        return 0.0

    @property
    def bytes_per_task(self) -> float:
        if self.kind == "memory":
            return float(self.iterations * self.span_bytes * 2)  # read + write
        return 0.0

    def useful_work(self) -> float:
        """The quantity efficiency is measured in (FLOPs or bytes)."""
        return self.flops_per_task if self.kind.startswith("compute") else self.bytes_per_task
