"""Task Bench kernel bodies in plain PyTorch, and the column dispatcher.

Counterpart of ``repro.kernels.bodies``: the three Task Bench inner loops
(compute / compute_mxu / memory) as step functions, one masked iteration
loop, and ``run_kernel_columns``, the task-kernel body every backend runs.

On a CUDA tensor ``run_kernel_columns`` sends the compute kind to the
hand-written kernel K1 (``kernels.compute``) and the memory kind to K2
(``kernels.memory``); on a CPU tensor those wrappers run their plain
versions.  ``plain=True`` keeps to the plain bodies on any device: that is
the reference the fused kernel K3 is held against on the card.

Numerics: every step is one float32 operation per PyTorch op, so nothing is
contracted into an FMA and the compute and memory kinds are bitwise equal
to the numpy oracle (``core.kernel_ref``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.kernel_ref import COMPUTE_C, MEM_BIAS, MEM_SCALE, mxu_weight
from ..core.kernel_spec import COMPUTE_TILE, MXU_DIM, KernelSpec

# seeds the kernel state with ``start + acc * FOLD_BLOCK``: rounds to
# exactly ``start`` in float32 (acc < 2^20 keeps the increment below half
# an ulp of every start value used) but keeps the state a function of the
# run-time dependency checksum, so no kernel loop can be folded away
FOLD_BLOCK = 2.0**-46

# python floats holding the exact float32 constants of the oracle
_COMPUTE_C = float(COMPUTE_C)
_MEM_SCALE = float(MEM_SCALE)
_MEM_BIAS = float(MEM_BIAS)
_MXU_INV = float(1.0 / MXU_DIM)


def compute_step(a: torch.Tensor) -> torch.Tensor:
    """One paper compute-kernel iteration: A = A*A - C."""
    return a * a - _COMPUTE_C


def memory_step(a: torch.Tensor) -> torch.Tensor:
    """One paper memory-kernel window update: read-scale-write."""
    return a * _MEM_SCALE + _MEM_BIAS


def mxu_step(b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One MXU-kernel iteration: batched matmul, scaled back into orbit."""
    return torch.matmul(b, w) * _MXU_INV + b * 0.5


def masked_loop(step_fn: Callable, state: torch.Tensor, iters: torch.Tensor,
                max_iters: int) -> torch.Tensor:
    """``max_iters`` steps with a per-column keep-old mask (static mode).

    ``iters`` may be ``(W,)`` or ``(W, 1)``; ``state`` has leading W.
    Column ``w`` ends after ``min(iters[w], max_iters)`` steps.
    """
    keep_shape = (state.shape[0],) + (1,) * (state.ndim - 1)
    iters = iters.reshape(keep_shape)
    for k in range(max_iters):
        state = torch.where(k < iters, step_fn(k, state), state)
    return state


def memory_geometry(kernel: KernelSpec) -> Tuple[int, int, int]:
    """(span, size, nwin) in f32 elements for the memory kernel's window
    walk — the single definition shared with ``core.kernel_ref``'s math."""
    span = max(1, kernel.span_bytes // 4)
    size = max(span, kernel.scratch_bytes // 4)
    size -= size % span  # whole number of windows
    return span, size, size // span


def run_kernel_columns(kernel: KernelSpec, iters_col: torch.Tensor,
                       seed_col: torch.Tensor, max_iters: int,
                       mxu_w: Optional[torch.Tensor] = None,
                       plain: bool = False) -> torch.Tensor:
    """The shared task-kernel body in column-vector form.

    ``iters_col``/``seed_col`` are ``(W, 1)`` int32 / float32; returns
    ``(W, 1)`` f32 results.  ``mxu_w`` is the (128, 128) weight on the
    seed's device (built from ``mxu_weight()`` when None).
    """
    from . import compute, memory  # the kernel modules build on this one

    width = seed_col.shape[0]

    if kernel.kind == "empty":
        # No work; preserve the data dependency so scheduling is honest.
        return seed_col * 0.0

    if kernel.kind == "compute":
        tile = (0.5 + seed_col[:, :, None]).expand((width,) + COMPUTE_TILE)
        fn = (compute.taskbench_compute_plain if plain
              else compute.taskbench_compute)
        out = fn(tile.contiguous(), iters_col.reshape(width).to(torch.int32),
                 max_iters)
        return out[:, 0, 0:1]

    if kernel.kind == "compute_mxu":
        b = (0.25 + seed_col[:, :, None]).expand(width, MXU_DIM, MXU_DIM)
        if mxu_w is None:
            mxu_w = torch.as_tensor(mxu_weight(), device=seed_col.device)
        out = masked_loop(lambda k, bb: mxu_step(bb, mxu_w), b, iters_col,
                          max_iters)
        return out[:, 0, 0:1]

    if kernel.kind == "memory":
        span, size, _ = memory_geometry(kernel)
        x = (1.0 + seed_col).expand(width, size).contiguous()
        # the masked walk over max_iters steps is the walk of
        # min(iters, max_iters) steps: K2's per-row iteration count
        reps = iters_col.reshape(width).clamp(0, max_iters).to(torch.int32)
        fn = (memory.taskbench_memory_plain if plain
              else memory.taskbench_memory)
        return fn(x, reps, span)[:, 0:1]

    raise ValueError(kernel.kind)
