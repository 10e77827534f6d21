"""The LM kernels on DTensors: each rank calls the kernel (or its plain
version, or the oracle) on its local shards, as ``shard_map`` would.

DTensor has no sharding rule for a hand-written kernel, and its rule for
the batched products of the plain versions cannot lay out the (batch x
heads) rows they flatten when both dims are sharded.  Every rank already
holds what its own heads need: attention is independent across the batch
and the heads, and so is the SSD scan.  So ``ops`` hands DTensor inputs
here, and each call

  * keeps q's (x's) sharding of the batch and head dims and gathers the
    rest (the sequence, the feature dim);
  * shards k and v (B and C) like q on the batch, and on the heads where
    their head count divides the same mesh axes; otherwise it keeps them
    whole and slices out the heads (groups) this rank's q heads read, with
    their gradient a partial sum over those axes;
  * slices a per-row tensor (cursors, key positions) to the rank's rows;
  * returns DTensors laid out like q (x), the state like x's batch and
    heads.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def is_dtensor(*ts) -> bool:
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return False
    return any(isinstance(t, DTensor) for t in ts)


def _mesh(*ts):
    from torch.distributed.tensor import DTensor

    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    from ..dist.sharding import distribute

    if t is None or isinstance(t, DTensor):
        return t
    return distribute(t, mesh, [Replicate()] * mesh.ndim)


def _contiguous_strides(shape):
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def _local_box(shape, mesh, place):
    """(local shape, global offset) of this rank's shard: a dim sharded
    over several mesh dims is split in the mesh's order (evenly: the rules
    shard only dims they divide)."""
    coord = mesh.get_coordinate()
    size, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(place):
        if p.is_shard():
            n = mesh.size(i)
            size[p.dim] //= n
            offset[p.dim] += coord[i] * size[p.dim]
    return size, offset


class _Layout:
    """A rank's view of the lead tensor's (q's, x's) batch and head dims."""

    def __init__(self, lead, head_dim: int):
        from torch.distributed.tensor import Replicate, Shard

        self.mesh = mesh = lead.device_mesh
        self.head_dim = head_dim
        self.place = [p if isinstance(p, Shard) and p.dim in (0, head_dim)
                      else Replicate() for p in lead.placements]
        self.head_axes = [i for i, p in enumerate(self.place)
                          if p == Shard(head_dim)]
        self.nheads = 1
        for i in self.head_axes:
            self.nheads *= mesh.size(i)
        self.lead = lead.redistribute(mesh, self.place)
        local, offset = _local_box(lead.shape, mesh, self.place)
        self.rows = (offset[0], local[0])
        self.heads = (offset[head_dim], local[head_dim])

    def follower(self, t, dim_b: int, dim_h: int, groups_of: int):
        """``t``'s local shard for this rank's heads: ``groups_of`` lead
        heads share one of ``t``'s ``dim_h`` entries (GQA groups, SSD
        groups); ``dim_b`` is its batch dim (None: no batch dim)."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        if t is None:
            return None
        t = _as_dtensor(t, self.mesh)
        n = t.shape[dim_h]
        sharded = n % self.nheads == 0 and (
            self.nheads == 1 or self.heads[1] % groups_of == 0)
        place = []
        for i, p in enumerate(self.place):
            if p == Shard(0) and dim_b is not None:
                place.append(Shard(dim_b))
            elif i in self.head_axes and sharded:
                place.append(Shard(dim_h))
            else:
                place.append(Replicate())
        t = t.redistribute(self.mesh, place)
        if sharded or self.nheads == 1:
            return t.to_local()
        grads = [Partial() if i in self.head_axes else p
                 for i, p in enumerate(place)]
        h0, hl = self.heads
        lo, hi = h0 // groups_of, (h0 + hl - 1) // groups_of + 1
        return t.to_local(grad_placements=grads).narrow(dim_h, lo, hi - lo)

    def per_row(self, t):
        """A tensor with one entry a batch row (or 0-d): this rank's."""
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(t, torch.Tensor):
            return t
        if isinstance(t, DTensor):
            t = t.redistribute(t.device_mesh,
                               [Replicate()] * t.device_mesh.ndim).to_local()
        if t.ndim == 0:
            return t
        b0, nb = self.rows
        return t.narrow(0, b0, nb)

    def wrap(self, out, place=None):
        from torch.distributed.tensor import DTensor, Shard

        if place is None:
            place = self.place
        glob = list(out.shape)  # the rules shard only dims they divide
        for i, p in enumerate(place):
            if isinstance(p, Shard):
                glob[p.dim] *= self.mesh.size(i)
        return DTensor.from_local(out.contiguous(), self.mesh, place,
                                  run_check=False,
                                  shape=torch.Size(glob),
                                  stride=_contiguous_strides(glob))


def attention(call: Callable, q, k, v, q_offset, kv_positions):
    """``call(q, k, v, q_offset, kv_positions)`` on each rank's shards."""
    lay = _Layout(_as_dtensor(q, _mesh(q, k, v)), head_dim=2)
    groups = q.shape[2] // k.shape[2]
    out = call(lay.lead.to_local(), lay.follower(k, 0, 2, groups),
               lay.follower(v, 0, 2, groups), lay.per_row(q_offset),
               lay.per_row(kv_positions))
    return lay.wrap(out)


def ssd(call: Callable, x, dt, A, Bm, Cm, D: Optional[torch.Tensor],
        h=None):
    """``call(x, dt, A, Bm, Cm, D[, h]) -> (y, state)`` on each rank's
    shards: x (B, S, H, P), dt (B, S, H), A and D (H,), B and C
    (B, S, G, N), a carried state h (B, H, P, N)."""
    from torch.distributed.tensor import Shard

    lay = _Layout(_as_dtensor(x, _mesh(x, dt, A, Bm, Cm, D, h)), head_dim=2)
    groups = x.shape[2] // Bm.shape[2]
    args = [lay.lead.to_local(), lay.follower(dt, 0, 2, 1),
            lay.follower(A, None, 0, 1), lay.follower(Bm, 0, 2, groups),
            lay.follower(Cm, 0, 2, groups), lay.follower(D, None, 0, 1)]
    if h is not None:
        args.append(lay.follower(h, 0, 1, 1))
    y, state = call(*args)
    state_place = [Shard(1) if p == Shard(2) else p for p in lay.place]
    return lay.wrap(y), lay.wrap(state, state_place)
