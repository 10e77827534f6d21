"""Reference (numpy) kernel bodies for the oracle executor.

These define the *semantics* each backend must reproduce.  Elementwise
kernels (compute, memory) are bitwise-reproducible in float32; the MXU
kernel involves a matmul whose reduction order differs across backends, so
its result slot is compared with tolerance (see validate.py).

The adaptation of the paper's kernels (paper Listing 1):

* paper compute kernel: 64-wide AVX2 ``A = A*A + A`` -> here a (8,128) f32
  tile iterating ``A = A*A - 1`` (bounded orbit, one multiply and one
  subtract per element per iteration, never contracted into an FMA).
* paper memory kernel: sequential AVX2 read/write over a constant working
  set -> here a window walk over a scratch vector, constant working set as
  iterations shrink (paper §II).
"""
from __future__ import annotations

import numpy as np

from .kernel_spec import COMPUTE_TILE, MXU_DIM, KernelSpec

COMPUTE_START = np.float32(0.5)
# x <- x^2 - 1 from 0.5 falls onto the superstable {0, -1} 2-cycle:
# bounded (no overflow), never subnormal (a decaying orbit would hit the
# CPU denormal penalty and corrupt the FLOP/s baseline), and error-
# CONTRACTING (1-ulp FMA-contraction differences between backends are
# squashed instead of amplified — a chaotic orbit breaks reproducibility)
COMPUTE_C = np.float32(1.0)
MEM_SCALE = np.float32(1.0001)
MEM_BIAS = np.float32(1.0)


def mxu_weight() -> np.ndarray:
    """Deterministic small-valued 128x128 weight for the MXU kernel."""
    i = np.arange(MXU_DIM)
    w = ((np.add.outer(i * 131, i * 31) % 17).astype(np.float32) - 8.0) / 32.0
    return w


def run_kernel_ref(kernel: KernelSpec, iterations: int) -> float:
    if kernel.kind == "empty":
        return 0.0
    if kernel.kind == "compute":
        a = COMPUTE_START
        for _ in range(iterations):
            a = np.float32(a * a - COMPUTE_C)
        return float(a)
    if kernel.kind == "compute_mxu":
        b = np.full((MXU_DIM, MXU_DIM), 0.25, dtype=np.float32)
        w = mxu_weight()
        inv = np.float32(1.0 / MXU_DIM)
        for _ in range(iterations):
            b = (b @ w) * inv + b * np.float32(0.5)
        return float(b[0, 0])
    if kernel.kind == "memory":
        span = max(1, kernel.span_bytes // 4)
        size = max(span, kernel.scratch_bytes // 4)
        size -= size % span  # whole number of windows
        nwin = size // span
        x = np.full(size, 1.0, dtype=np.float32)
        for k in range(iterations):
            w = (k % nwin) * span
            x[w : w + span] = x[w : w + span] * MEM_SCALE + MEM_BIAS
        return float(x[0])
    raise ValueError(kernel.kind)
