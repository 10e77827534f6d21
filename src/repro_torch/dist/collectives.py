"""Communication planning for rank-parallel backends (the comm-plan layer).

The port's own copy of the numpy planning half of the reference's
``repro.dist.collectives``: which ranks own which columns, and which
payload rows move between them each timestep.  ``CommPlan`` is that plan:

* **analysis** — ``dependency_reach``/``directional_reach`` scan the
  dependence offsets of ``TaskGraph.dependence_matrices()`` with one
  ``np.nonzero`` (one timestep slice for time-invariant graphs);
* **placement** — columns are blocked over ``ndev`` ranks, ragged widths
  padded to the next multiple with *dead columns* (no dependencies, zero
  iterations) that ``trim`` drops again;
* **movement** — five modes: ``ring``, ``halo`` and ``allgather`` (picked
  by ``auto`` from the reach), and ``a2a`` and ``onesided``, which must be
  asked for.  ``a2a`` and ``onesided`` share one per-pair slot layout:
  rank ``src`` sends rank ``dst`` exactly the rows ``dst``'s tasks read
  from ``src``'s block, padded to ``a2a_cap`` rows a pair.
  ``onesided`` moves them by producer puts and signal flags
  (``_onesided_offsets`` is the put schedule), which is what the
  ``cuda-fused[comm=onesided]`` kernel K4 runs.

``local_mats`` are the dependence matrices re-indexed into each rank's
context window: ``[left halo | local block | right halo]`` for the
ppermute modes, ``[recv buffers (src-major) | local block]`` for
``a2a``/``onesided``.

The runtime half moves the rows, on a rank of ``dist.ranks`` (the
reference's runs inside ``shard_map``): ``local_cols``, ``exchange``
(ring and halo are ppermutes that do not wrap — a rank with no source
gets zeros; allgather is tiled; a2a is one all-to-all of the plan's
slots), and ``onesided_state``/``onesided_push``/``onesided_wait``.  Each
takes the calling rank's communicator (``dist.ranks.RankComm``) where the
reference names the mesh axis.  ``exchange`` and ``onesided_push`` with
``async_op=True`` return the exchange in flight (its ``wait()`` gives the
result), so a program can post step t's rows and wait only before step
t+1's body reads them; the values are the same either way.

``TokenA2APlan`` and ``dispatch_capacity`` are the MoE token all-to-all
(dispatch and combine over the ``data`` axis of a rank grid,
``models.moe``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.graph import TaskGraph
from .ranks import Done

MODES = ("auto", "ring", "halo", "allgather", "a2a", "onesided")


def _dep_offsets(graph: TaskGraph) -> np.ndarray:
    """All distinct dependence offsets ``j - i`` across the graph."""
    if graph.height <= 1:
        return np.empty((0,), np.int64)
    if graph.is_time_invariant():
        mats = graph.dependence_matrix(1)[None]
    else:
        mats = graph.dependence_matrices()[1:]
    _, i, j = np.nonzero(mats)
    return np.unique(j.astype(np.int64) - i.astype(np.int64))


def directional_reach(graph: TaskGraph) -> Tuple[int, int]:
    """(left, right): how far deps reach toward lower / higher columns."""
    offs = _dep_offsets(graph)
    if offs.size == 0:
        return 0, 0
    return int(max(-offs.min(), 0)), int(max(offs.max(), 0))


def dependency_reach(graph: TaskGraph) -> int:
    """max |j - i| over all deps — the halo width an MPI rank would post."""
    left, right = directional_reach(graph)
    return max(left, right)


# eq=False: ndarray fields would make the generated __eq__/__hash__ raise
@dataclasses.dataclass(frozen=True, eq=False)
class CommPlan:
    """How one graph's payloads are laid out and moved over ``ndev`` ranks.

    ``local_mats``/``iters`` are padded to ``padded_width`` columns; dead
    columns (>= ``width``) have empty dependence rows and zero iterations,
    and are sliced away by ``trim``.
    """

    mode: str            # "ring" | "halo" | "allgather" | "a2a" | "onesided"
    axis: str            # name of the axis the ranks live on
    ndev: int
    width: int           # real graph width
    padded_width: int    # next multiple of ndev
    local: int           # columns per rank
    halo: int            # exchange width (0 => no communication)
    local_mats: np.ndarray   # (H, padded_width, ctx) uint8
    iters: np.ndarray        # (H, padded_width) int32
    # the executing program may issue timestep t+1's exchange ahead of
    # t+1's task body; a program-shape flag, the plan is the same
    comm_overlap: bool = False
    # a2a/onesided modes: [src, dst] row counts and padded send-row indices
    send_counts: Optional[np.ndarray] = None   # (ndev, ndev) int64
    a2a_cap: int = 0                           # rows per (src, dst) buffer
    a2a_send_idx: Optional[np.ndarray] = None  # (ndev, ndev, cap) int32

    @property
    def ragged(self) -> bool:
        return self.padded_width != self.width

    @property
    def recv_counts(self) -> Optional[np.ndarray]:
        """[dst, src] rows received — the transpose of ``send_counts``:
        every row sent is received exactly once (token conservation)."""
        return None if self.send_counts is None else self.send_counts.T

    @property
    def context_width(self) -> int:
        """Columns of t-1 payload visible to each rank after exchange."""
        return self.local_mats.shape[-1]

    def trim(self, gathered):
        """Drop dead padding columns from a (padded_width, ...) output."""
        return gathered[: self.width]

    # ------------------------------------------- what a rank is handed
    def shard(self, rank: int) -> Tuple[np.ndarray, np.ndarray]:
        """Rank ``rank``'s slice of the tables, as ``in_specs`` would cut
        them: its ``(H, local, ctx)`` matrices and ``(H, local)``
        iterations."""
        cols = slice(rank * self.local, (rank + 1) * self.local)
        return self.local_mats[:, cols], self.iters[:, cols]

    def without_tables(self) -> "CommPlan":
        """This plan with its per-column tables cut to no columns: what a
        rank needs besides its ``shard`` (the mode, the sizes, the slot
        layout; ``context_width`` still holds)."""
        return dataclasses.replace(self, local_mats=self.local_mats[:, :0],
                                   iters=self.iters[:, :0])

    @property
    def tag_span(self) -> int:
        """Point-to-point tags one exchange or push uses from its ``tag``:
        two for the halo's directions, one a one-sided offset."""
        return self.ndev + 1

    # ------------------------------------------- the runtime half (rank)
    def local_cols(self, comm) -> torch.Tensor:
        """Global column ids of the calling rank."""
        return comm.rank * self.local + torch.arange(self.local,
                                                     device=comm.device)

    def exchange(self, payload: torch.Tensor, comm, async_op: bool = False,
                 tag: int = 0):
        """Move t-1 payloads into this rank's context.

        payload: (local, P) f32 — the rank's own previous-timestep rows.
        Returns (context_width, P) rows ordered to match ``local_mats``
        (with ``async_op``, the exchange in flight; ``wait()`` returns
        them).  ``tag`` and the ``tag_span - 1`` tags after it are this
        exchange's point-to-point tags.
        """
        if self.mode == "allgather":
            pending = comm.all_gather(payload, tag)
        elif self.mode == "onesided":
            # stateless form (one put, then the wait of epoch 1); the
            # executing backends carry (recv, sig) across steps instead
            recv, sig = self.onesided_state(payload.shape[-1], payload.device,
                                            payload.dtype)
            pending = self.onesided_push(payload, recv, sig, comm, True,
                                         tag).then(
                lambda rs: self.onesided_wait(*rs, 1, payload))
        elif self.mode == "a2a":
            if self.a2a_cap == 0:
                return _result(payload, async_op)  # no remote deps
            idx = comm.constant(self.a2a_send_idx)[comm.rank]
            send = payload[idx]  # (ndev, cap, P)
            pending = comm.all_to_all(send, tag, lambda recv: torch.cat(
                [recv.reshape(self.ndev * self.a2a_cap, -1), payload]))
        elif self.halo == 0:
            return _result(payload, async_op)
        else:
            pending = self._ppermute(payload, comm, tag)
        return pending if async_op else pending.wait()

    def _ppermute(self, payload: torch.Tensor, comm, tag: int):
        """ring / halo: r -> r+1 (and r -> r-1 for halo), no wrap; a rank
        with no source gets zeros."""
        h, r, last = self.halo, comm.rank, self.ndev - 1
        halo = self.mode == "halo"
        edge = payload[:h]  # the shape and type of what each side gets
        sends, recvs = [], []
        if r < last:
            sends.append((payload[-h:], r + 1, tag))
        if r > 0:
            recvs.append((edge, r - 1, tag))
        if halo and r > 0:
            sends.append((payload[:h], r - 1, tag + 1))
        if halo and r < last:
            recvs.append((edge, r + 1, tag + 1))

        def finish(got):
            got = list(got)
            from_left = got.pop(0) if r > 0 else torch.zeros_like(edge)
            if not halo:
                return torch.cat([from_left, payload])
            from_right = got.pop(0) if r < last else torch.zeros_like(edge)
            return torch.cat([from_left, payload, from_right])

        return comm.p2p(sends, recvs, finish)

    @functools.cached_property
    def _onesided_offsets(self) -> List[Tuple[int, np.ndarray, np.ndarray]]:
        """Static transport schedule: one entry per *active* ring offset.

        ``(offset, idx_table, flag_table)``: rank ``r`` puts the payload
        rows ``idx_table[r]`` to rank ``(r + offset) % ndev``;
        ``flag_table[r]`` is 1 where the pair is live.  Every rank runs
        every offset's put — the SPMD-uniform schedule — and dead pairs
        deliver rows no ``local_mats`` entry reads.
        """
        assert self.mode == "onesided" and self.send_counts is not None
        out: List[Tuple[int, np.ndarray, np.ndarray]] = []
        for off in range(1, self.ndev):
            dsts = (np.arange(self.ndev) + off) % self.ndev
            live = self.send_counts[np.arange(self.ndev), dsts] > 0
            if not live.any():
                continue
            idx = self.a2a_send_idx[np.arange(self.ndev), dsts]  # (ndev, cap)
            out.append((off, idx.astype(np.int32),
                        live.astype(np.float32)))
        return out

    def onesided_state(self, payload_elems: int, device,
                       dtype=torch.float32):
        """Fresh (recv buffers, signal counters) for the executing loop.

        ``recv[s]`` is the ``a2a_cap``-row buffer rank ``s`` puts into on
        this rank; ``sig[s]`` counts the epochs rank ``s`` has signalled.
        """
        recv = torch.zeros((self.ndev, self.a2a_cap, payload_elems),
                           dtype=dtype, device=device)
        sig = torch.zeros((self.ndev,), dtype=torch.int32, device=device)
        return recv, sig

    def onesided_push(self, payload: torch.Tensor, recv: torch.Tensor,
                      sig: torch.Tensor, comm, async_op: bool = False,
                      tag: int = 0):
        """The producer side: put dependency rows into each consumer's
        receive buffer and raise its signal.

        One point-to-point packet ``[rows | one flag row]`` per active ring
        offset (offset index ``oi`` on tag ``tag + oi``), to ``(r + off) %
        ndev``, and one from ``(r - off) % ndev``: the flag travels with
        the rows, so the producer raises the signal.  Dead pairs still send
        their masked rows (flag 0), so every rank runs the same schedule.
        ``recv[src]`` is set and ``sig[src] += flag`` — in place, on the
        tensors passed in.  Returns ``(recv, sig)``, or with ``async_op``
        the push in flight.
        """
        if self.a2a_cap == 0:
            return _result((recv, sig), async_op)
        r, P = comm.rank, payload.shape[-1]
        sends, recvs, srcs = [], [], []
        for oi, (off, idx_tab, flag_tab) in enumerate(self._onesided_offsets):
            block = payload[comm.constant(idx_tab)[r]]  # (cap, P)
            flag = torch.full((1, P), float(flag_tab[r]), dtype=block.dtype,
                              device=block.device)
            packet = torch.cat([block, flag])
            sends.append((packet, (r + off) % self.ndev, tag + oi))
            src = (r - off) % self.ndev
            recvs.append((packet, src, tag + oi))
            srcs.append(src)

        def finish(got):
            for src, packet in zip(srcs, got):
                recv[src] = packet[:-1]
                sig[src] += packet[-1, 0].to(sig.dtype)
            return recv, sig

        pending = comm.p2p(sends, recvs, finish)
        return pending if async_op else pending.wait()

    def onesided_wait(self, recv: torch.Tensor, sig: torch.Tensor, t: int,
                      payload: torch.Tensor) -> torch.Tensor:
        """The consumer side: the masked wait + context assembly.

        Receive slots whose producer has not signalled epoch ``t`` yet
        read as zeros — which is also what makes the mode bit-exact with
        the blocking ones: dead pairs and the t=0 epoch are masked
        instead of synchronized away.
        """
        if self.a2a_cap == 0:
            return payload
        ready = sig >= int(t)
        slots = torch.where(ready[:, None, None], recv,
                            torch.zeros_like(recv))
        return torch.cat([slots.reshape(self.ndev * self.a2a_cap, -1),
                          payload])


def _result(value, async_op: bool):
    """``value``, or with ``async_op`` an exchange already done."""
    return Done(value) if async_op else value


def _padded_static_inputs(graph: TaskGraph, padded: int):
    """Dep matrices (H, padded, padded) u8 + iteration counts (H, padded)."""
    from ..backends import body  # local import: backends import this module

    mats, iters = body.graph_static_inputs(graph)
    W = graph.width
    if padded == W:
        return mats, iters
    H = graph.height
    pm = np.zeros((H, padded, padded), np.uint8)
    pm[:, :W, :W] = mats
    pi = np.zeros((H, padded), np.int32)  # dead columns: no work
    pi[:, :W] = iters
    return pm, pi


def plan_comm(
    graph: TaskGraph,
    ndev: int,
    axis: str,
    comm: str = "auto",
    prefer_ring: bool = False,
    comm_overlap: bool = False,
) -> CommPlan:
    """Build the communication plan for ``graph`` over ``ndev`` ranks.

    ``comm`` forces a mode; ``auto`` picks the cheapest legal one (never
    ``a2a`` or ``onesided``, which must be asked for).  With
    ``prefer_ring``, graphs whose deps reach only toward lower columns use
    the one-directional ring instead of the bidirectional halo.
    ``comm_overlap`` is recorded on the plan for the executing backend.
    """
    if comm not in MODES:
        raise ValueError(f"unknown comm mode {comm!r}; known: {MODES}")
    if ndev < 1:
        raise ValueError(f"need at least one rank, got {ndev}")
    W, H = graph.width, graph.height
    padded = -(-W // ndev) * ndev
    local = padded // ndev
    left, right = directional_reach(graph)
    reach = max(left, right)

    if comm == "auto":
        if reach > local:
            mode = "allgather"
        elif prefer_ring and right == 0:
            mode = "ring"
        else:
            mode = "halo"
    else:
        mode = comm
        if mode == "ring" and right > 0:
            raise ValueError(
                f"ring comm needs left-only deps, but reach is "
                f"(left={left}, right={right})")
        if mode in ("ring", "halo") and reach > local:
            raise ValueError(
                f"{mode} comm cannot cover reach {reach} with "
                f"{local} columns per rank; use allgather")

    mats, iters = _padded_static_inputs(graph, padded)
    if mode in ("a2a", "onesided"):
        plan = _plan_a2a(graph, ndev, axis, mats, iters, padded, local,
                         mode=mode)
        return dataclasses.replace(plan, comm_overlap=comm_overlap) \
            if comm_overlap else plan
    if mode == "allgather":
        halo = 0
        lmats = mats  # context is the full gathered (padded) width
    else:
        halo = min(reach if mode == "halo" else left, local)
        lhalo, rhalo = halo, (halo if mode == "halo" else 0)
        ctx = lhalo + local + rhalo
        lmats = np.zeros((H, padded, ctx), np.uint8)
        t_idx, i_idx, j_idx = np.nonzero(mats)
        # re-index dep columns into [left halo | local block | right halo]
        lj = j_idx - ((i_idx // local) * local - lhalo)
        assert ((0 <= lj) & (lj < ctx)).all(), (mode, halo, local)
        lmats[t_idx, i_idx, lj] = 1

    return CommPlan(
        mode=mode, axis=axis, ndev=ndev, width=W, padded_width=padded,
        local=local, halo=halo, local_mats=lmats, iters=iters,
        comm_overlap=comm_overlap,
    )


def _plan_a2a(graph: TaskGraph, ndev: int, axis: str,
              mats: np.ndarray, iters: np.ndarray,
              padded: int, local: int, mode: str = "a2a") -> CommPlan:
    """Per-pair dispatch plan: rank ``src`` sends rank ``dst`` exactly the
    payload columns ``dst``'s tasks read from ``src``'s block (union over
    timesteps, one plan reused per step).  Buffers are padded to the max
    pair count; unused send slots carry local row 0, which no
    ``local_mats`` entry references.  ``onesided`` shares this layout.
    """
    H = graph.height
    t_idx, i_idx, j_idx = np.nonzero(mats)
    src, dst = j_idx // local, i_idx // local
    remote = src != dst
    # unique (src, dst, j) triples, lexically sorted — fixes the slot order
    triples = np.unique(
        np.stack([src[remote], dst[remote], j_idx[remote]], axis=1), axis=0)
    send_counts = np.zeros((ndev, ndev), np.int64)
    np.add.at(send_counts, (triples[:, 0], triples[:, 1]), 1)
    cap = int(send_counts.max()) if triples.size else 0
    send_idx = np.zeros((ndev, ndev, cap), np.int32)
    # context offset of remote column j for its consumer rank d:
    # [recv buffers (ndev * cap, src-major) | local block]
    col_off = np.zeros((ndev, padded), np.int64)
    slot = np.zeros((ndev, ndev), np.int64)
    for s, d, j in triples:
        k = slot[s, d]
        slot[s, d] += 1
        send_idx[s, d, k] = j - s * local
        col_off[d, j] = s * cap + k
    ctx = ndev * cap + local
    lmats = np.zeros((H, padded, ctx), np.uint8)
    r = i_idx // local
    off = np.where(j_idx // local == r, ndev * cap + (j_idx - r * local),
                   col_off[r, j_idx])
    lmats[t_idx, i_idx, off] = 1
    return CommPlan(
        mode=mode, axis=axis, ndev=ndev, width=graph.width,
        padded_width=padded, local=local, halo=0, local_mats=lmats,
        iters=iters, send_counts=send_counts, a2a_cap=cap,
        a2a_send_idx=send_idx,
    )


# ---------------------------------------------- dynamic token all-to-all
def dispatch_capacity(sends: int, ndev: int, factor: float) -> int:
    """Rows per destination-rank buffer for ``sends`` routed items.

    ``factor`` is the MoE capacity factor; the result is padded to a
    multiple of 8 with a floor of 8, as the reference pads it to the TPU's
    sublane tile, so that both packages plan the same buffers.  Sends
    beyond a destination's capacity are dropped deterministically in send
    order (``TokenA2APlan.route``).
    """
    return max(8, int(math.ceil(factor * sends / ndev / 8.0) * 8))


@dataclasses.dataclass(frozen=True)
class TokenA2APlan:
    """Routing-dependent all-to-all over one axis of ranks (MoE dispatch
    and combine).

    The static part — ``cap`` rows per destination, slot assignment by
    arrival order, the forward and reverse ``all_to_all`` — is planned
    here; the per-row destinations arrive at run time from the router.
    ``route`` is a pure function of them; ``dispatch`` and ``combine`` run
    on a rank with the axis's communicator (``dist.ranks.RankComm``),
    where the reference runs inside ``shard_map`` and names the axis.
    Volume per rank per direction: ``ndev * cap`` rows.
    """

    ndev: int
    cap: int

    def route(self, dest: torch.Tensor):
        """dest (M,) -> (slot, keep).

        ``slot`` is each row's arrival index among same-destination rows
        (deterministic in send order: the capacity drop); rows with
        ``slot >= cap`` are parked on the overflow slot ``cap`` and masked
        by ``keep``.
        """
        onehot = torch.zeros(dest.shape[0], self.ndev, dtype=torch.int64,
                             device=dest.device)
        onehot.scatter_(1, dest.long()[:, None], 1)
        slot = torch.cumsum(onehot, dim=0) - onehot
        slot = (slot * onehot).sum(-1)
        keep = slot < self.cap
        return torch.where(keep, slot, self.cap), keep

    def dispatch(self, dest: torch.Tensor, slot: torch.Tensor,
                 rows: torch.Tensor, comm, tag: int = 0, fill=0):
        """Exchange rows (M, ...) toward their destination ranks.

        Returns this rank's received rows, flattened to ``(ndev * cap,
        ...)``: row ``s * cap + k`` is the k-th row rank ``s`` sent here.
        Empty and overflow slots hold ``fill``.
        """
        shape = (self.ndev, self.cap + 1) + tuple(rows.shape[1:])
        buf = torch.full(shape, fill, dtype=rows.dtype, device=rows.device)
        # rows past the capacity all land on the overflow slot, cut below
        buf[dest.long(), slot] = rows
        recv = comm.all_to_all(buf[:, :self.cap].contiguous(), tag).wait()
        return recv.reshape((self.ndev * self.cap,) + tuple(rows.shape[1:]))

    def combine(self, out_rows: torch.Tensor, dest: torch.Tensor,
                slot: torch.Tensor, comm, tag: int = 0):
        """Reverse exchange: ``out_rows`` ``(ndev * cap, ...)`` keyed like
        ``dispatch``'s result travel back to the senders; returns one row
        per original send (M, ...).  Dropped sends read the overflow slot
        — mask the result with ``keep`` from ``route``.
        """
        back = comm.all_to_all(out_rows.reshape(
            (self.ndev, self.cap) + tuple(out_rows.shape[1:])).contiguous(),
            tag).wait()
        return back[dest.long(), slot.clamp(0, self.cap - 1)]
