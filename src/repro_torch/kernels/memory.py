"""K2, the Task Bench memory kernel: wrapper, plain version, launch count.

Counterpart of ``repro.kernels.memory.taskbench_memory`` (the Pallas TPU
kernel ``_memory_kernel``).  The CUDA kernel is ``csrc/memory.cu``; its
header says what bounds it on the H100 and how its design answers that.

Besides the reference's ``(size,)`` scratch with an int iteration count,
the kernel takes a ``(C, size)`` scratch with a ``(C,)`` int32 count per
row: the same function applied row by row, the form a timestep's
per-column scratch needs (``kernels.bodies.run_kernel_columns``).
"""
from __future__ import annotations

from typing import Union

import torch

from . import _build
from ._cost import Cost, costed, data_sum, nbytes
from .bodies import memory_step


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


@costed(memory_cost)
def taskbench_memory(x: torch.Tensor, iterations: Union[int, torch.Tensor],
                     span: int) -> torch.Tensor:
    """The scratch after the window walk (out of place).

    A CPU tensor runs the plain version; a CUDA tensor launches K2 on the
    current stream (and counts the launch in ``taskbench_memory.launches``).
    """
    _check(x, iterations, span)
    if x.device.type == "cpu":
        return taskbench_memory_plain(x, iterations, span)
    if x.device.type != "cuda":
        raise ValueError(f"no memory kernel for device {x.device}")
    out = torch.empty_like(x)
    rows = 1 if x.ndim == 1 else x.shape[0]
    per_row = isinstance(iterations, torch.Tensor)
    lib = _build.library()
    err = lib.taskbench_memory_launch(
        x.data_ptr(), iterations.data_ptr() if per_row else None,
        0 if per_row else int(iterations), out.data_ptr(), rows,
        x.shape[-1], int(span), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "taskbench_memory")
    taskbench_memory.launches += 1
    return out


taskbench_memory.launches = 0
