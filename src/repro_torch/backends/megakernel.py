"""Persistent fused backend ``cuda-fused``: one launch per task-graph batch.

Counterpart of the single-device ``pallas-fused`` backend.  Every other
backend pays a launch per operation per timestep — the runtime overhead
the paper identifies as the METG floor (§V-C).  This backend removes it:
the whole task graph batch — all timesteps × columns × concurrent graphs,
dependencies included — runs as a *single* launch of K3, the cooperative
CUDA kernel in ``kernels/csrc/fused.cu`` (its header gives the design).

* The timestep loop is inside the kernel, with no barrier across CTAs: a
  task publishes its combined checksum in a tagged 64-bit word of its own
  (one per graph, timestep and column) and waits only on its
  dependencies' words (``kernels/csrc/signal.cuh``).
* Dependencies are read through the graph's dense dependency table
  (``TaskGraph.dependency_table``), graphs concatenated on the row axis.
* The task body is the same as ``kernels.bodies.run_kernel_columns``, so
  the checksum slots and the elementwise kinds stay bitwise equal.

``taskbench_fused`` is the kernel's wrapper (plain version on a CPU
tensor, K3 on a CUDA tensor), ``taskbench_fused_plain`` its plain PyTorch
version.

``cuda-fused[comm=onesided,ranks=N]`` is the multi-rank form (counterpart
of ``pallas-fused[comm=onesided]``; N defaults to the card count, or 1 on
the CPU, as the reference's defaults to its devices): columns are blocked over N ranks by
the one-sided ``CommPlan`` (``dist.collectives``), and each graph runs as
one launch of K4 (``kernels/csrc/onesided.cu``), in which every rank is a
CTA that puts its dependency rows into its consumers' inboxes as tagged
words, each carrying its own readiness, with no barrier across ranks.  The
reference runs one TPU chip per rank; on one card a rank is a CTA, so N is
bounded by the CTAs the card holds at once (``taskbench_onesided_blocks``),
not by a device count.
``taskbench_onesided`` and ``taskbench_onesided_plain`` are K4's wrapper
and plain version.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..core.graph import CHECKSUM_MOD, TaskGraph
from ..core.kernel_ref import mxu_weight
from ..core.kernel_spec import COMPUTE_TILE_ELEMS, MXU_DIM, KernelSpec
from ..dist import collectives as CC
from ..kernels import _build, bodies
from ..kernels._cost import Cost, costed, data_sum, nbytes
from ..kernels.memory import wide_path
from . import body
from .base import StackedProgramBackend, register_backend

KIND_CODES = {"empty": 0, "compute": 1, "compute_mxu": 2, "memory": 3}
# K3's counters while recording (kernels/csrc/fused.cu), summed over each
# CTA's tasks: its warp 0's cycles in the dependency combine (the polls and
# the sum of their values), the cycles from each task's start to its signal
# store, and the tasks that found a dependency not ready at the first poll
K3_COUNTERS = ("k3.wait_cycles", "k3.task_cycles", "k3.late_tasks")


def scratch_elems(kernel: KernelSpec) -> int:
    """f32 values of per-task body state K3 keeps in global memory."""
    if kernel.kind == "compute":
        return COMPUTE_TILE_ELEMS
    if kernel.kind == "compute_mxu":
        return 2 * MXU_DIM * MXU_DIM  # state and next state
    if kernel.kind == "memory":
        return bodies.memory_geometry(kernel)[1]
    return 0


def body_ops(kernel: KernelSpec) -> int:
    """Operations of one iteration of a task's body."""
    if kernel.kind == "compute":
        return 2 * COMPUTE_TILE_ELEMS
    if kernel.kind == "memory":
        return 2 * bodies.memory_geometry(kernel)[0]
    if kernel.kind == "compute_mxu":
        return 2 * MXU_DIM ** 3 + 3 * MXU_DIM ** 2
    return 0


def fused_cost(idx, mask, iters, base, mxu_w, *, kernel: KernelSpec,
               ngraphs: int, height: int, payload_elems: int) -> Cost:
    """K3's declared cost: the tables read and the final wave written
    once; the body's operations for every task's iterations (this run's
    table)."""
    W = idx.shape[1]
    tables = sum(nbytes(t) for t in (idx, mask, iters, base, mxu_w))
    return Cost(0.0, tables + ngraphs * W * payload_elems * 4,
                float(body_ops(kernel) * data_sum(iters)))


@costed(fused_cost)
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


def _check_tables(idx, mask, iters, base, mxu_w, kernel: KernelSpec,
                  height: int, payload_elems: int, *more) -> None:
    """The checks K3 and K4 share: int32 tables, contiguous on ``idx``'s
    device (``mask`` of ``idx``'s shape, ``iters`` and ``base`` of its
    shape with one dependency, then ``more`` (name, table, shape)), the
    compute_mxu weight and the payload and height."""
    cols = tuple(idx.shape[:-1]) + (1,)
    for name, a, shape in (("idx", idx, tuple(idx.shape)),
                           ("mask", mask, tuple(idx.shape)),
                           ("iters", iters, cols), ("base", base, cols),
                           *more):
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
    if payload_elems < 5 or height < 1:
        raise ValueError(f"bad payload_elems={payload_elems}, "
                         f"height={height}")


def _check(idx, mask, iters, base, mxu_w, kernel: KernelSpec, ngraphs: int,
           height: int, payload_elems: int) -> None:
    rows = ngraphs * height
    if ngraphs < 1 or idx.ndim != 3 or idx.shape[0] != rows:
        raise ValueError(f"idx must be ({rows}, W, R) with ngraphs >= 1, "
                         f"got {tuple(idx.shape)}")
    _check_tables(idx, mask, iters, base, mxu_w, kernel, height,
                  payload_elems)


def _body_state(kernel: KernelSpec, tasks: int, dev: torch.device):
    """What K3's and K4's launches share for the task body: the scratch
    (``scratch_elems`` float32 values a task, or None), its stride, the
    memory walk's ``(span, size)`` and whether the walk is wide
    (``_wide``)."""
    stride = scratch_elems(kernel)
    scratch = (torch.empty((tasks, stride), dtype=torch.float32, device=dev)
               if stride else None)
    span, size, _ = bodies.memory_geometry(kernel)
    return scratch, stride, span, size, _wide(kernel, span, scratch)


@_build.kernel("K3", fused_cost, "fused", wide=True)
def taskbench_fused(idx: torch.Tensor, mask: torch.Tensor,
                    iters: torch.Tensor, base: torch.Tensor,
                    mxu_w: Optional[torch.Tensor], *, kernel: KernelSpec,
                    ngraphs: int, height: int,
                    payload_elems: int) -> torch.Tensor:
    """Run ``ngraphs`` stacked graphs for ``height`` timesteps.

    Tables as ``MegakernelBackend._tables`` builds them (on one device);
    returns the ``(G*W, P)`` final payload wave.  A CPU tensor runs the
    plain version; a CUDA tensor launches K3 once on the current stream
    (and counts it in ``taskbench_fused.launches``, and in
    ``taskbench_fused.wide_launches`` where the memory body moves 16-byte
    words, ``_wide``).

    While ``trace.recording()`` is on, the call records the spans
    ``fused.check``, ``fused.alloc`` and ``fused.launch`` (the library
    call), and K3 runs its traced instance, which keeps ``K3_COUNTERS`` a
    CTA in a buffer of ``trace.device_counters``.
    """
    with trace.span("fused.check"):
        _check(idx, mask, iters, base, mxu_w, kernel, ngraphs, height,
               payload_elems)
    if _build.runs_plain("K3", idx.device):
        return taskbench_fused_plain(
            idx, mask, iters, base, mxu_w, kernel=kernel, ngraphs=ngraphs,
            height=height, payload_elems=payload_elems)
    G, W, R = ngraphs, idx.shape[1], idx.shape[2]
    dev = idx.device
    # torch.empty, never zeros: a fill would be a second kernel.  The kernel
    # writes every payload row and counter, and zeroes its signal words
    # itself (a memset on the stream)
    with trace.span("fused.alloc"):
        wave = torch.empty((G * W, payload_elems), dtype=torch.float32,
                           device=dev)
        words = torch.empty((G * height, W), dtype=torch.int64, device=dev)
        scratch, stride, span, size, wide = _body_state(kernel, G * W, dev)
        stats = (trace.device_counters(K3_COUNTERS, fused_blocks(
            G * W, dev.index, wide), dev) if trace.active() else None)
    with trace.span("fused.launch"):
        _build.launch(
            "K3", "taskbench_fused_launch", idx.data_ptr(),
            mask.data_ptr(), iters.data_ptr(), base.data_ptr(),
            None if mxu_w is None else mxu_w.data_ptr(), wave.data_ptr(),
            words.data_ptr(), None if scratch is None else scratch.data_ptr(),
            None if stats is None else stats.data_ptr(), stride,
            KIND_CODES[kernel.kind], G, height, W, R, payload_elems,
            kernel.iterations, span, size, int(wide), device=dev, wide=wide)
    return wave


def _wide(kernel: KernelSpec, span: int, scratch) -> bool:
    """Whether K3's or K4's memory body runs on float4s: a memory body whose
    scratch rows (whole numbers of windows apart) and windows all start on
    16-byte boundaries (``kernels.memory.wide_path``)."""
    return kernel.kind == "memory" and wide_path(span, scratch.data_ptr())


@functools.lru_cache(maxsize=64)
def fused_blocks(tasks: int, device_index: int, wide: bool) -> int:
    """The grid of K3's launch for ``tasks`` = G*W tasks on the card
    ``device_index``, for the instance with the 16-byte memory body where
    ``wide`` (``taskbench_fused_blocks``): fixed for a card, the instance
    and the task count, so queried once."""
    blocks = _build.library().taskbench_fused_blocks(tasks, int(wide),
                                                     device_index)
    if blocks <= 0:
        raise RuntimeError("taskbench_fused_blocks could not query K3's grid")
    return blocks


def onesided_cost(idx, mask, iters, base, send_rows, offsets, mxu_w, *,
                  kernel: KernelSpec, height: int, payload_elems: int
                  ) -> Cost:
    """K4's declared cost: the tables read, every put row written to an
    inbox and read from it once a timestep after the first, the final
    wave written once; the body's operations for every task's iterations
    (this run's table)."""
    ranks, _, local, _ = idx.shape
    n_off, cap = offsets.shape[0], send_rows.shape[2]
    tables = sum(nbytes(t) for t in (idx, mask, iters, base, send_rows,
                                      offsets, mxu_w))
    inbox = 2 * ranks * (height - 1) * n_off * cap * payload_elems * 4
    return Cost(0.0, tables + inbox + ranks * local * payload_elems * 4,
                float(body_ops(kernel) * data_sum(iters)))


@costed(onesided_cost)
def taskbench_onesided_plain(idx: torch.Tensor, mask: torch.Tensor,
                             iters: torch.Tensor, base: torch.Tensor,
                             send_rows: torch.Tensor, offsets: torch.Tensor,
                             mxu_w: Optional[torch.Tensor], *,
                             kernel: KernelSpec, height: int,
                             payload_elems: int) -> torch.Tensor:
    """The plain PyTorch version of K4: ``(ranks*local, P)`` final wave.

    A timestep loop vectorized over ranks: the context of rank r is
    ``[inbox(t-1) | own t-1 wave]``, combined as in
    ``taskbench_fused_plain``; after the body, rank r puts the rows
    ``send_rows[r, oi]`` of its new wave into the inbox of rank
    ``(r + offsets[oi]) % ranks`` for every t < H-1.  Only slot 3 (the
    combined checksum) of a context row is ever read, so the loop carries
    that slot alone.
    """
    ranks, H, local, R = idx.shape
    offs = [int(o) for o in offsets.tolist()]
    cap = send_rows.shape[2]
    dev = idx.device
    idx3 = idx.reshape(ranks, H, local * R).to(torch.int64)
    live = mask != 0
    its = iters.reshape(ranks, H, local)
    bases = base.reshape(ranks, H, local).to(torch.int64)
    inbox = torch.zeros(ranks, len(offs) * cap, dtype=torch.int64,
                        device=dev)
    combined = torch.zeros(ranks, local, dtype=torch.int64, device=dev)
    for t in range(H):
        ctx = torch.cat([inbox, combined], dim=1)
        picked = torch.gather(ctx, 1, idx3[:, t]).reshape(ranks, local, R)
        acc = (picked * live[:, t]).sum(-1) % CHECKSUM_MOD
        combined = (bases[:, t] + acc) % CHECKSUM_MOD
        seed = acc.to(torch.float32) * bodies.FOLD_BLOCK
        res = bodies.run_kernel_columns(
            kernel, its[:, t].reshape(ranks * local, 1),
            seed.reshape(ranks * local, 1), kernel.iterations, mxu_w=mxu_w,
            plain=True).reshape(ranks, local)
        if t < H - 1 and offs:
            # rank d receives offset off's rows from rank (d - off) % ranks
            inbox = torch.cat([
                torch.roll(torch.gather(combined, 1,
                                        send_rows[:, oi].to(torch.int64)),
                           shifts=off, dims=0)
                for oi, off in enumerate(offs)], dim=1)
    cols = torch.arange(ranks * local, device=dev).reshape(ranks, local)
    wave = body.make_payload(H - 1, cols, bases[:, H - 1], combined, res,
                             payload_elems)
    return wave.reshape(ranks * local, payload_elems)


def _check_onesided(idx, mask, iters, base, send_rows, offsets, mxu_w,
                    kernel: KernelSpec, height: int,
                    payload_elems: int) -> None:
    if idx.ndim != 4 or idx.shape[1] != height:
        raise ValueError(f"idx must be (ranks, {height}, local, R), got "
                         f"{tuple(idx.shape)}")
    if offsets.ndim != 1 or send_rows.ndim != 3:
        raise ValueError("offsets must be (n_off,) and send_rows "
                         "(ranks, n_off, cap)")
    n_off = offsets.shape[0]
    send_shape = (idx.shape[0], max(n_off, 1), send_rows.shape[2])
    _check_tables(idx, mask, iters, base, mxu_w, kernel, height,
                  payload_elems, ("send_rows", send_rows, send_shape),
                  ("offsets", offsets, (n_off,)))


@functools.lru_cache(maxsize=None)
def onesided_blocks(device_index: int) -> int:
    """The most ranks (co-resident CTAs) one K4 launch can hold on the card
    ``device_index``: fixed for a card and the kernel, so queried once."""
    limit = _build.library().taskbench_onesided_blocks(device_index)
    if limit <= 0:
        raise RuntimeError("taskbench_onesided_blocks could not query the "
                           "card's co-resident CTAs")
    return limit


@_build.kernel("K4", onesided_cost, "one-sided", wide=True)
def taskbench_onesided(idx: torch.Tensor, mask: torch.Tensor,
                       iters: torch.Tensor, base: torch.Tensor,
                       send_rows: torch.Tensor, offsets: torch.Tensor,
                       mxu_w: Optional[torch.Tensor], *, kernel: KernelSpec,
                       height: int, payload_elems: int) -> torch.Tensor:
    """Run one graph over ``ranks`` ranks for ``height`` timesteps.

    Tables as ``onesided_tables_from_numpy`` stages them; returns the
    ``(ranks*local, P)`` final payload wave, dead columns included.  A CPU
    tensor runs the plain version; a CUDA tensor launches K4 once on the
    current stream (and counts it in ``taskbench_onesided.launches``, and
    in ``taskbench_onesided.wide_launches`` as ``taskbench_fused`` does),
    with one CTA per rank, and raises when the card cannot hold ``ranks``
    CTAs at once.
    """
    _check_onesided(idx, mask, iters, base, send_rows, offsets, mxu_w,
                    kernel, height, payload_elems)
    if _build.runs_plain("K4", idx.device):
        return taskbench_onesided_plain(
            idx, mask, iters, base, send_rows, offsets, mxu_w, kernel=kernel,
            height=height, payload_elems=payload_elems)
    ranks, _, local, R = idx.shape
    n_off, cap = offsets.shape[0], send_rows.shape[2]
    dev = idx.device
    limit = onesided_blocks(dev.index)
    if ranks > limit:
        raise RuntimeError(
            f"ranks={ranks} exceeds the {limit} CTAs K4 can hold co-resident "
            f"on {torch.cuda.get_device_name(dev)} "
            f"(taskbench_onesided_blocks)")
    P = payload_elems
    waves = torch.empty((2, ranks * local, P), dtype=torch.float32,
                        device=dev)
    scratch, stride, span, size, wide = _body_state(kernel, ranks * local,
                                                    dev)
    # one (tag, value) word an element, zeroed by the launch's memset
    inbox = torch.empty((ranks, height, max(n_off * cap, 1), P),
                        dtype=torch.int64, device=dev)
    _build.launch(
        "K4", "taskbench_onesided_launch", idx.data_ptr(),
        mask.data_ptr(), iters.data_ptr(), base.data_ptr(),
        send_rows.data_ptr(), offsets.data_ptr(),
        None if mxu_w is None else mxu_w.data_ptr(), waves.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stride,
        inbox.data_ptr(), KIND_CODES[kernel.kind], ranks, height, local, R,
        P, n_off, cap, kernel.iterations, span, size, int(wide), device=dev,
        wide=wide)
    return waves[(height - 1) % 2]


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


def onesided_tables_from_numpy(offsets: Sequence[int],
                               tabs: Tuple[np.ndarray, ...], device) -> Tuple:
    """Device tensors ``(idx, mask, iters, base, send_rows, offsets, mxu_w
    or None)`` from ``MegakernelBackend._onesided_tables``.  The context
    slots and put rows are checked here, on the host, since the kernel
    indexes with them."""
    idx, send_rows = tabs[0], tabs[4]
    ranks, local = idx.shape[0], idx.shape[2]
    ctx = len(offsets) * send_rows.shape[2] + local
    if idx.size and (idx.min() < 0 or idx.max() >= ctx):
        raise ValueError(f"dependency slots outside [0, {ctx})")
    if send_rows.min() < 0 or send_rows.max() >= local:
        raise ValueError(f"put rows outside [0, {local})")
    if any(not 0 < off < ranks for off in offsets):
        raise ValueError(f"ring offsets outside [1, {ranks})")
    as_int = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32), device=device)
    out = tuple(as_int(a) for a in tabs[:5]) + (as_int(list(offsets)),)
    mxu_w = (torch.as_tensor(np.ascontiguousarray(tabs[5], np.float32),
                             device=device) if len(tabs) > 5 else None)
    return out + (mxu_w,)


@register_backend("cuda-fused")
class MegakernelBackend(StackedProgramBackend):
    """Whole-graph fusion below the per-launch dispatch floor."""

    paradigm = "persistent fused kernel (single launch per graph batch)"
    dispatch_model = "per-launch"

    def __init__(self, device: Optional[str] = None,
                 comm: Optional[str] = None, ranks: Optional[int] = None):
        if comm not in (None, "onesided"):
            raise ValueError(
                f"cuda-fused comm must be 'onesided' (or omitted for the "
                f"single-rank fused kernel), got {comm!r}")
        if comm != "onesided" and ranks is not None:
            raise ValueError(f"cuda-fused ranks={ranks!r} needs "
                             f"comm=onesided")
        super().__init__(device)
        if comm == "onesided":
            if ranks is None:
                # the reference takes its rank count from the devices; here
                # as torch-csp does: the cards, or one rank on the CPU
                ranks = (torch.cuda.device_count()
                         if self.device.type == "cuda" else 1)
            if isinstance(ranks, bool) or not isinstance(ranks, int) \
                    or ranks < 1:
                raise ValueError(f"cuda-fused[comm=onesided] needs ranks, a "
                                 f"positive int, got {ranks!r}")
        self.comm = comm
        self.ranks = ranks

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

    @staticmethod
    def _onesided_tables(graph: TaskGraph, plan: CC.CommPlan):
        """Per-rank static inputs of K4: ``(offsets, (idx, mask, iters,
        base, send_rows[, mxu_w]))``.

        ``idx``/``mask`` ``(ranks, H, local, R)`` are the plan's
        ``local_mats`` in *inbox* coordinates
        ``[ring-offset-major recv slots | local block]``: the put at offset
        ``off`` always lands in slot block ``oi_of[off]``, whatever the
        source rank, where the plan's coordinates are source-rank-major.
        ``send_rows`` ``(ranks, n_off, cap)`` is the local row each put slot
        carries (the reference's one-hot ``sel``, as indices).
        """
        lm = plan.local_mats  # (H, padded, ctx) — plan coords, src-major
        H, padded, _ = lm.shape
        ndev, local, cap = plan.ndev, plan.local, plan.a2a_cap
        sched = plan._onesided_offsets  # empty when no rank reads remotely
        offsets = [off for off, _, _ in sched]
        n_off = len(offsets)
        oi_of = np.zeros(ndev, np.int64)
        oi_of[offsets] = np.arange(n_off)
        radix = max(1, int(lm.sum(-1).max()))
        # every dependency (t, i, c), row-major: c ascends within a row
        t, i, c = np.nonzero(lm)
        d = i // local
        s, slot = np.divmod(c, max(cap, 1))  # source rank, its put slot
        k = np.where(c >= ndev * cap, n_off * cap + (c - ndev * cap),
                     oi_of[(d - s) % ndev] * cap + slot)
        rows = t * padded + i
        pos = np.arange(rows.size) - np.searchsorted(rows, rows)
        idx = np.zeros((ndev, H, local, radix), np.int32)
        mask = np.zeros((ndev, H, local, radix), np.int32)
        idx[d, t, i - d * local, pos] = k
        mask[d, t, i - d * local, pos] = 1
        base = np.zeros((H, padded), np.int64)
        base[:, :graph.width] = graph.checksum_table()

        def per_rank(a):  # (H, padded) -> (ndev, H, local, 1)
            return np.ascontiguousarray(
                a.reshape(H, ndev, local, 1).transpose(1, 0, 2, 3))

        send_rows = np.zeros((ndev, max(n_off, 1), max(cap, 1)), np.int32)
        for oi, (_, idx_tab, _) in enumerate(sched):
            send_rows[:, oi] = idx_tab
        tabs = (idx, mask, per_rank(plan.iters.astype(np.int32)),
                per_rank(base.astype(np.int32)), send_rows)
        if graph.kernel.kind == "compute_mxu":
            tabs += (mxu_weight().astype(np.float32),)
        return offsets, tabs

    def _staged_onesided(self, graph: TaskGraph):
        plan = CC.plan_comm(graph, self.ranks, "cols", comm="onesided")
        offsets, tabs = self._onesided_tables(graph, plan)
        staged = onesided_tables_from_numpy(offsets, tabs, self.device)
        kw = dict(kernel=graph.kernel, height=graph.height,
                  payload_elems=graph.payload_elems)
        return lambda: plan.trim(taskbench_onesided(*staged, **kw))

    def _staged(self, graphs: List[TaskGraph], radix: int):
        g0 = graphs[0]
        tabs = tables_from_numpy(self._tables(graphs, radix), self.device)
        kw = dict(kernel=g0.kernel, ngraphs=len(graphs), height=g0.height,
                  payload_elems=g0.payload_elems)
        return lambda: taskbench_fused(*tabs, **kw)

    def _build(self, graphs: List[TaskGraph]):
        """Independent graphs: one launch per graph."""
        if self.comm == "onesided":
            calls = [self._staged_onesided(g) for g in graphs]
        else:
            calls = [self._staged([g], max(1, g.max_radix()))
                     for g in graphs]
        return lambda: [call() for call in calls]

    def _build_stacked(self, graphs: List[TaskGraph]):
        """Concurrent graphs in ONE launch: the graphs share the table row
        axis, so even multi-graph scenarios stay at one launch.  The
        one-sided form has none: one K4 launch per graph."""
        if self.comm == "onesided" or not body.stackable(graphs):
            return None
        g0 = graphs[0]
        call = self._staged(graphs, max(1, max(g.max_radix()
                                               for g in graphs)))
        return lambda: call().reshape(len(graphs), g0.width,
                                      g0.payload_elems)
