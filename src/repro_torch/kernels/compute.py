"""K1, the Task Bench compute kernel: wrapper, plain version, its loop.

Counterpart of ``repro.kernels.compute.taskbench_compute`` (the Pallas TPU
kernel ``_compute_kernel``).  The CUDA kernel is ``csrc/compute.cu``; its
header says what bounds it on the H100 and how its design answers that.
The compute step and the keep-masked loop every plain body runs
(``masked_loop``) live here, and ``kernels.bodies`` re-exports them.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.kernel_ref import COMPUTE_C
from ..core.kernel_spec import COMPUTE_TILE
from . import _build
from ._cost import Cost, costed, nbytes

# the python float holding the exact float32 constant of the oracle
_COMPUTE_C = float(COMPUTE_C)


def compute_step(a: torch.Tensor) -> torch.Tensor:
    """One paper compute-kernel iteration: A = A*A - C."""
    return a * a - _COMPUTE_C


def masked_loop(step_fn: Callable, state: torch.Tensor, iters: torch.Tensor,
                max_iters: int, dynamic: bool = False) -> torch.Tensor:
    """Run the kernel loop with per-column iteration counts.

    Static mode: ``max_iters`` steps with a per-column keep-old mask, so
    column ``w`` ends after ``min(iters[w], max_iters)`` steps — what
    vectorized runtimes must do, and why they cannot exploit load
    imbalance (paper §V-G).  Dynamic mode: ``max_iters`` steps with no
    mask, where the caller passes the trip count ``max(iters)`` as a host
    int (the reference traces ``jnp.max(iters)``; reading it from a device
    tensor here would sync) — per-task systems genuinely run fewer
    iterations for short tasks.  Values are bitwise identical.

    ``iters`` may be ``(W,)`` or ``(W, 1)``; ``state`` has leading W.
    """
    if dynamic:
        for k in range(max_iters):
            state = step_fn(k, state)
        return state
    keep_shape = (state.shape[0],) + (1,) * (state.ndim - 1)
    iters = iters.reshape(keep_shape)
    for k in range(max_iters):
        state = torch.where(k < iters, step_fn(k, state), state)
    return state


def compute_cost(tiles, iters, max_iters: int) -> Cost:
    """K1's declared cost: tiles read and written and iters read once; two
    operations an element a step, ``max_iters`` steps (the most a column
    runs)."""
    W = tiles.shape[0]
    elems = nbytes(tiles) // tiles.dtype.itemsize // max(W, 1)
    return Cost(0.0, 2 * nbytes(tiles) + nbytes(iters),
                2.0 * W * elems * max_iters)


@costed(compute_cost)
def taskbench_compute_plain(tiles: torch.Tensor, iters: torch.Tensor,
                            max_iters: int) -> torch.Tensor:
    """The plain PyTorch version: ``max_iters`` keep-masked steps."""
    return masked_loop(lambda k, a: compute_step(a), tiles, iters, max_iters)


def _check(tiles: torch.Tensor, iters: torch.Tensor, max_iters: int) -> None:
    if tiles.dtype != torch.float32 or tiles.ndim != 3 \
            or tuple(tiles.shape[1:]) != COMPUTE_TILE:
        raise ValueError(f"tiles must be float32 (W, 8, 128), got "
                         f"{tiles.dtype} {tuple(tiles.shape)}")
    if iters.dtype != torch.int32 or tuple(iters.shape) != tiles.shape[:1]:
        raise ValueError(f"iters must be int32 ({tiles.shape[0]},), got "
                         f"{iters.dtype} {tuple(iters.shape)}")
    if iters.device != tiles.device:
        raise ValueError(f"iters on {iters.device}, tiles on {tiles.device}")
    if not (tiles.is_contiguous() and iters.is_contiguous()):
        raise ValueError("tiles and iters must be contiguous")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")


@_build.kernel("K1", compute_cost, "compute")
def taskbench_compute(tiles: torch.Tensor, iters: torch.Tensor,
                      max_iters: int) -> torch.Tensor:
    """(W, 8, 128) f32 tiles after ``min(iters[w], max_iters)`` steps each.

    A CPU tensor runs the plain version; a CUDA tensor launches K1 on the
    current stream (and counts the launch in ``taskbench_compute.launches``).
    """
    _check(tiles, iters, max_iters)
    if _build.runs_plain("K1", tiles.device):
        return taskbench_compute_plain(tiles, iters, max_iters)
    out = torch.empty_like(tiles)
    _build.launch("K1", "taskbench_compute_launch",
                  tiles.data_ptr(), iters.data_ptr(), out.data_ptr(),
                  tiles.shape[0], int(max_iters), device=tiles.device)
    return out
