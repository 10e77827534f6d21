"""K2, the Task Bench memory kernel: wrapper, plain version, its step.

Counterpart of ``repro.kernels.memory.taskbench_memory`` (the Pallas TPU
kernel ``_memory_kernel``).  The CUDA kernel is ``csrc/memory.cu``; its
header says what bounds it on the H100 and how its design answers that.

Besides the reference's ``(size,)`` scratch with an int iteration count,
the kernel takes a ``(C, size)`` scratch with a ``(C,)`` int32 count per
row: the same function applied row by row, the form a timestep's
per-column scratch needs (``kernels.bodies.run_kernel_columns``).
The memory step lives here, and ``kernels.bodies`` re-exports it.
"""
from __future__ import annotations

from typing import Union

import torch

from ..core.kernel_ref import MEM_BIAS, MEM_SCALE
from . import _build
from ._cost import Cost, costed, data_sum, nbytes

# python floats holding the exact float32 constants of the oracle
_MEM_SCALE = float(MEM_SCALE)
_MEM_BIAS = float(MEM_BIAS)


def memory_step(a: torch.Tensor) -> torch.Tensor:
    """One paper memory-kernel window update: read-scale-write."""
    return a * _MEM_SCALE + _MEM_BIAS


def _window_reps(iterations: torch.Tensor, nwin: int) -> torch.Tensor:
    """(C, nwin) steps per window: ``its // nwin + (w < its % nwin)``."""
    its = iterations.to(torch.int64).clamp(min=0)[:, None]
    w = torch.arange(nwin, device=iterations.device)[None, :]
    return its // nwin + (w < its % nwin).to(torch.int64)


def memory_cost(x, iterations, span: int) -> Cost:
    """K2's declared cost: the scratch read and written and the counts read
    once; two operations an element of a window a step, the steps of
    every row (this run's counts)."""
    rows = 1 if len(x.shape) == 1 else x.shape[0]
    if isinstance(iterations, torch.Tensor):
        steps, counts = data_sum(iterations), nbytes(iterations)
    else:
        steps, counts = rows * int(iterations), 0
    return Cost(0.0, 2 * nbytes(x) + counts, 2.0 * span * steps)


@costed(memory_cost)
def taskbench_memory_plain(x: torch.Tensor,
                           iterations: Union[int, torch.Tensor],
                           span: int) -> torch.Tensor:
    """The plain PyTorch version: the window walk, reordered per window."""
    size = x.shape[-1]
    rows = x.reshape(-1, size)
    if not isinstance(iterations, torch.Tensor):
        iterations = torch.full((rows.shape[0],), int(iterations),
                                dtype=torch.int32, device=x.device)
    nwin = size // span
    reps = _window_reps(iterations, nwin)[:, :, None]
    win = rows.reshape(rows.shape[0], nwin, span).clone()
    for r in range(int(reps.max()) if reps.numel() else 0):
        win = torch.where(r < reps, memory_step(win), win)
    return win.reshape(x.shape)


def wide_path(span: int, *addresses: int) -> bool:
    """Whether the window walk may move 16-byte words (``wide`` in
    ``csrc/bodies.cuh``): every window starts on a 16-byte boundary.  A
    window starts at a row's address plus a whole number of windows, and
    rows lie whole numbers of windows apart, so that holds when every base
    address is a multiple of 16 and ``span`` (in f32 values) of 4."""
    return span % 4 == 0 and all(a % 16 == 0 for a in addresses)


def _check(x: torch.Tensor, iterations, span: int) -> None:
    if x.dtype != torch.float32 or x.ndim not in (1, 2):
        raise ValueError(f"x must be float32 (size,) or (C, size), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if span < 1 or x.shape[-1] % span:
        raise ValueError(f"size {x.shape[-1]} is not a whole number of "
                         f"windows of span {span}")
    if x.ndim == 1:
        if isinstance(iterations, torch.Tensor):
            raise ValueError("a (size,) scratch takes an int iteration count")
        if iterations < 0:
            raise ValueError(f"iterations must be >= 0, got {iterations}")
        return
    if not isinstance(iterations, torch.Tensor) \
            or iterations.dtype != torch.int32 \
            or tuple(iterations.shape) != x.shape[:1] \
            or not iterations.is_contiguous():
        raise ValueError(f"a (C, size) scratch takes contiguous int32 "
                         f"iterations of shape ({x.shape[0]},)")
    if iterations.device != x.device:
        raise ValueError(f"iterations on {iterations.device}, x on {x.device}")


@_build.kernel("K2", memory_cost, "memory", wide=True)
def taskbench_memory(x: torch.Tensor, iterations: Union[int, torch.Tensor],
                     span: int) -> torch.Tensor:
    """The scratch after the window walk (out of place).

    A CPU tensor runs the plain version; a CUDA tensor launches K2 on the
    current stream (and counts the launch in ``taskbench_memory.launches``,
    and in ``taskbench_memory.wide_launches`` where the walk moves 16-byte
    words, ``wide_path``).
    """
    _check(x, iterations, span)
    if _build.runs_plain("K2", x.device):
        return taskbench_memory_plain(x, iterations, span)
    out = torch.empty_like(x)
    rows = 1 if x.ndim == 1 else x.shape[0]
    per_row = isinstance(iterations, torch.Tensor)
    wide = wide_path(int(span), x.data_ptr(), out.data_ptr())
    _build.launch("K2", "taskbench_memory_launch",
                  x.data_ptr(), iterations.data_ptr() if per_row else None,
                  0 if per_row else int(iterations), out.data_ptr(), rows,
                  x.shape[-1], int(span), int(wide), device=x.device,
                  wide=wide)
    return out
