"""K1, the Task Bench compute kernel: wrapper, plain version, launch count.

Counterpart of ``repro.kernels.compute.taskbench_compute`` (the Pallas TPU
kernel ``_compute_kernel``).  The CUDA kernel is ``csrc/compute.cu``; its
header says what bounds it on the H100 and how its design answers that.
"""
from __future__ import annotations

import torch

from ..core.kernel_spec import COMPUTE_TILE
from . import _build
from ._cost import Cost, costed, nbytes
from .bodies import compute_step, masked_loop


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


@costed(compute_cost)
def taskbench_compute(tiles: torch.Tensor, iters: torch.Tensor,
                      max_iters: int) -> torch.Tensor:
    """(W, 8, 128) f32 tiles after ``min(iters[w], max_iters)`` steps each.

    A CPU tensor runs the plain version; a CUDA tensor launches K1 on the
    current stream (and counts the launch in ``taskbench_compute.launches``).
    """
    _check(tiles, iters, max_iters)
    if tiles.device.type == "cpu":
        return taskbench_compute_plain(tiles, iters, max_iters)
    if tiles.device.type != "cuda":
        raise ValueError(f"no compute kernel for device {tiles.device}")
    out = torch.empty_like(tiles)
    lib = _build.library()
    err = lib.taskbench_compute_launch(
        tiles.data_ptr(), iters.data_ptr(), out.data_ptr(), tiles.shape[0],
        int(max_iters), tiles.device.index,
        torch.cuda.current_stream(tiles.device).cuda_stream)
    _build.check(err, "taskbench_compute")
    taskbench_compute.launches += 1
    return out


taskbench_compute.launches = 0
