"""Persistent fused backend ``cuda-fused``: one launch per task-graph batch.

Counterpart of the single-device ``pallas-fused`` backend.  Every other
backend pays a launch per operation per timestep — the runtime overhead
the paper identifies as the METG floor (§V-C).  This backend removes it:
the whole task graph batch — all timesteps × columns × concurrent graphs,
dependencies included — runs as a *single* launch of K3, the cooperative
CUDA kernel in ``kernels/csrc/fused.cu`` (its header gives the design).

* The timestep loop is inside the kernel, with a grid-wide barrier
  between timesteps; the payload wave is double-buffered in global memory.
* Dependencies are read through the graph's dense dependency table
  (``TaskGraph.dependency_table``), graphs concatenated on the row axis.
* The task body is the same as ``kernels.bodies.run_kernel_columns``, so
  the checksum slots and the elementwise kinds stay bitwise equal.

``taskbench_fused`` is the kernel's wrapper (plain version on a CPU
tensor, K3 on a CUDA tensor), ``taskbench_fused_plain`` its plain PyTorch
version.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import CHECKSUM_MOD, TaskGraph
from ..core.kernel_ref import mxu_weight
from ..core.kernel_spec import COMPUTE_TILE_ELEMS, MXU_DIM, KernelSpec
from ..kernels import _build, bodies
from . import body
from .base import StackedProgramBackend, register_backend

KIND_CODES = {"empty": 0, "compute": 1, "compute_mxu": 2, "memory": 3}


def scratch_elems(kernel: KernelSpec) -> int:
    """f32 values of per-task body state K3 keeps in global memory."""
    if kernel.kind == "compute":
        return COMPUTE_TILE_ELEMS
    if kernel.kind == "compute_mxu":
        return 2 * MXU_DIM * MXU_DIM  # state and next state
    if kernel.kind == "memory":
        return bodies.memory_geometry(kernel)[1]
    return 0


def taskbench_fused_plain(idx: torch.Tensor, mask: torch.Tensor,
                          iters: torch.Tensor, base: torch.Tensor,
                          mxu_w: Optional[torch.Tensor], *,
                          kernel: KernelSpec, ngraphs: int, height: int,
                          payload_elems: int) -> torch.Tensor:
    """The plain PyTorch version of K3: ``(G*W, P)`` final payload wave."""
    G, H = ngraphs, height
    W, R = idx.shape[1], idx.shape[2]
    idx4 = idx.reshape(G, H, W * R).to(torch.int64)
    live = mask.reshape(G, H, W, R) != 0
    its = iters.reshape(G, H, W)
    bases = base.reshape(G, H, W).to(torch.int64)
    combined = torch.zeros(G, W, dtype=torch.int64, device=idx.device)
    for t in range(H):
        picked = torch.gather(combined, 1, idx4[:, t]).reshape(G, W, R)
        acc = (picked * live[:, t]).sum(-1) % CHECKSUM_MOD
        combined = (bases[:, t] + acc) % CHECKSUM_MOD
        seed = acc.to(torch.float32) * bodies.FOLD_BLOCK
        res = bodies.run_kernel_columns(
            kernel, its[:, t].reshape(G * W, 1), seed.reshape(G * W, 1),
            kernel.iterations, mxu_w=mxu_w, plain=True).reshape(G, W)
    cols = torch.arange(W, device=idx.device)
    wave = body.make_payload(H - 1, cols, bases[:, H - 1], combined, res,
                             payload_elems)
    return wave.reshape(G * W, payload_elems)


def _check(idx, mask, iters, base, mxu_w, kernel: KernelSpec, ngraphs: int,
           height: int, payload_elems: int) -> None:
    rows = ngraphs * height
    if idx.ndim != 3 or idx.shape[0] != rows:
        raise ValueError(f"idx must be ({rows}, W, R), got {tuple(idx.shape)}")
    W, R = idx.shape[1], idx.shape[2]
    for name, a, shape in (("idx", idx, (rows, W, R)),
                           ("mask", mask, (rows, W, R)),
                           ("iters", iters, (rows, W, 1)),
                           ("base", base, (rows, W, 1))):
        if a.dtype != torch.int32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != idx.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {idx.device}")
    if kernel.kind == "compute_mxu":
        if mxu_w is None or mxu_w.dtype != torch.float32 \
                or tuple(mxu_w.shape) != (MXU_DIM, MXU_DIM) \
                or mxu_w.device != idx.device or not mxu_w.is_contiguous():
            raise ValueError("compute_mxu needs a contiguous float32 "
                             f"({MXU_DIM}, {MXU_DIM}) weight on {idx.device}")
    if payload_elems < 5 or height < 1 or ngraphs < 1:
        raise ValueError(f"bad payload_elems={payload_elems}, "
                         f"height={height}, ngraphs={ngraphs}")


def taskbench_fused(idx: torch.Tensor, mask: torch.Tensor,
                    iters: torch.Tensor, base: torch.Tensor,
                    mxu_w: Optional[torch.Tensor], *, kernel: KernelSpec,
                    ngraphs: int, height: int,
                    payload_elems: int) -> torch.Tensor:
    """Run ``ngraphs`` stacked graphs for ``height`` timesteps.

    Tables as ``MegakernelBackend._tables`` builds them (on one device);
    returns the ``(G*W, P)`` final payload wave.  A CPU tensor runs the
    plain version; a CUDA tensor launches K3 once on the current stream
    (and counts it in ``taskbench_fused.launches``).
    """
    _check(idx, mask, iters, base, mxu_w, kernel, ngraphs, height,
           payload_elems)
    if idx.device.type == "cpu":
        return taskbench_fused_plain(
            idx, mask, iters, base, mxu_w, kernel=kernel, ngraphs=ngraphs,
            height=height, payload_elems=payload_elems)
    if idx.device.type != "cuda":
        raise ValueError(f"no fused kernel for device {idx.device}")
    G, W, R = ngraphs, idx.shape[1], idx.shape[2]
    dev = idx.device
    # torch.empty, never zeros: a fill would be a second launch, and the
    # kernel writes the t = 0 wave itself
    waves = torch.empty((2, G * W, payload_elems), dtype=torch.float32,
                        device=dev)
    stride = scratch_elems(kernel)
    scratch = (torch.empty((G * W, stride), dtype=torch.float32, device=dev)
               if stride else None)
    span, size, _ = bodies.memory_geometry(kernel)
    lib = _build.library()
    err = lib.taskbench_fused_launch(
        idx.data_ptr(), mask.data_ptr(), iters.data_ptr(), base.data_ptr(),
        None if mxu_w is None else mxu_w.data_ptr(), waves.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stride,
        KIND_CODES[kernel.kind], G, height, W, R, payload_elems,
        kernel.iterations, span, size, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "taskbench_fused")
    taskbench_fused.launches += 1
    return waves[(height - 1) % 2]


taskbench_fused.launches = 0


def tables_from_numpy(tabs: Tuple[np.ndarray, ...], device) -> Tuple:
    """Device tensors ``(idx, mask, iters, base, mxu_w or None)`` from the
    numpy tables of ``MegakernelBackend._tables`` (or the reference
    package's, which are the same arrays).  The dependency columns are
    checked here, on the host, since the kernel indexes with them."""
    idx = tabs[0]
    if idx.size and (idx.min() < 0 or idx.max() >= idx.shape[1]):
        raise ValueError(f"dependency columns outside [0, {idx.shape[1]})")
    out = tuple(torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                device=device) for a in tabs[:4])
    mxu_w = (torch.as_tensor(np.ascontiguousarray(tabs[4], np.float32),
                             device=device) if len(tabs) > 4 else None)
    return out + (mxu_w,)


@register_backend("cuda-fused")
class MegakernelBackend(StackedProgramBackend):
    """Whole-graph fusion below the per-launch dispatch floor."""

    paradigm = "persistent fused kernel (single launch per graph batch)"

    @staticmethod
    def _tables(graphs: Sequence[TaskGraph], radix: int):
        """Host-side static inputs, graphs concatenated on the row axis."""
        idxs, masks, its, bases = [], [], [], []
        for g in graphs:
            idx, mask = g.dependency_table(radix)
            _, iters = body.graph_static_inputs(g)
            idxs.append(idx)
            masks.append(mask.astype(np.int32))
            its.append(iters[..., None])
            bases.append(g.checksum_table().astype(np.int32)[..., None])
        tabs = tuple(np.concatenate(x, axis=0)
                     for x in (idxs, masks, its, bases))
        if graphs[0].kernel.kind == "compute_mxu":
            tabs += (mxu_weight().astype(np.float32),)
        return tabs

    def _staged(self, graphs: List[TaskGraph], radix: int):
        g0 = graphs[0]
        tabs = tables_from_numpy(self._tables(graphs, radix), self.device)
        kw = dict(kernel=g0.kernel, ngraphs=len(graphs), height=g0.height,
                  payload_elems=g0.payload_elems)
        return lambda: taskbench_fused(*tabs, **kw)

    def _build(self, graphs: List[TaskGraph]):
        """Independent graphs: one launch per graph."""
        calls = [self._staged([g], max(1, g.max_radix())) for g in graphs]
        return lambda: [call() for call in calls]

    def _build_stacked(self, graphs: List[TaskGraph]):
        """Concurrent graphs in ONE launch: the graphs share the table row
        axis, so even multi-graph scenarios stay at one launch."""
        if not body.stackable(graphs):
            return None
        g0 = graphs[0]
        call = self._staged(graphs, max(1, max(g.max_radix()
                                               for g in graphs)))
        return lambda: call().reshape(len(graphs), g0.width,
                                      g0.payload_elems)
