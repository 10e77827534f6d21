"""Logical-axis sharding rules with divisibility fallback (the port of
``repro.dist.sharding``).

Every tensor carries *logical* axis names (``"embed"``, ``"heads"``,
``"batch"``...) rather than concrete mesh axes.  A ``ShardingRules`` table
maps each logical axis to an ordered list of *candidate* mesh placements;
resolution walks the tensor's axes left-to-right and, per axis, takes the
first candidate that

  * names only mesh axes that exist in the mesh,
  * names only mesh axes not already used by this tensor
    (a mesh axis shards at most one dim of any tensor), and
  * evenly divides the dimension (the *divisibility fallback*:
    Arctic's 56 heads don't divide a 16-way ``model`` axis, so heads
    replicate and attention runs context-parallel instead — no
    per-arch special-casing).

A candidate may be a single mesh axis (``"model"``) or a tuple
(``("pod", "data")``) whose product shards one dim — how the batch and
FSDP dims span pods on the multi-pod mesh.

``spec_for`` is device-free: the mesh is anything with axis names and
sizes (a ``DeviceMesh``, or a plain ``{axis: size}`` dict), and the spec
is a ``PartitionSpec``, a tuple with one entry a tensor dim (a mesh axis,
a tuple of them, or None), as the reference's.  ``sharding_for`` turns
it into DTensor placements on a ``torch.distributed.device_mesh.
DeviceMesh``: one a mesh dim, ``Shard(d)`` where that mesh axis shards
tensor dim d, else ``Replicate()``.  A tuple candidate shards one dim
over several mesh dims; DTensor splits it over them in the mesh's order,
so a tuple must name its axes in that order (major to minor, JAX's order
for a tuple), which gives each device the shard JAX gives it.

``use_rules``/``active_rules`` install a rules table for a region of
code; ``constrain`` is the model-side hook that redistributes a DTensor
(or places a plain tensor, a replica on every rank) to its logical-axes
layout, and is the identity outside any rules context, so single-device
code runs the exact same model code.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# one candidate mesh placement: a mesh axis or a tuple sharding jointly
Candidate = Union[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis, a tuple of them, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


@dataclasses.dataclass
class ShardingRules:
    """A mesh (a ``DeviceMesh`` or an axis -> size mapping) + rule
    table."""

    mesh: Any
    rules: Dict[Optional[str], List[Candidate]]

    def spec_for(self, axis_names: Sequence[Optional[str]],
                 shapes: Sequence[int]) -> PartitionSpec:
        """Resolve one tensor's logical axes to a PartitionSpec."""
        mesh_shape = mesh_axes(self.mesh)
        used: set = set()
        entries: List[Optional[Candidate]] = []
        for name, dim in zip(axis_names, shapes):
            pick: Optional[Candidate] = None
            for cand in self.rules.get(name, []) if name is not None else []:
                axes = (cand,) if isinstance(cand, str) else tuple(cand)
                if any(a not in mesh_shape for a in axes):
                    continue  # e.g. ("pod","data") on a single-pod mesh
                if any(a in used for a in axes):
                    continue  # mesh axis already shards another dim
                size = int(np.prod([mesh_shape[a] for a in axes]))
                if dim % size:
                    continue  # divisibility fallback: try the next candidate
                pick = axes[0] if len(axes) == 1 else axes
                used.update(axes)
                break
            entries.append(pick)
        return PartitionSpec(*entries)

    def sharding_for(self, axis_names: Sequence[Optional[str]],
                     shapes: Sequence[int]) -> list:
        """The DTensor placements of ``spec_for`` on ``self.mesh``."""
        return placements(self.mesh, self.spec_for(axis_names, shapes))


def placements(mesh, spec: Sequence[Optional[Candidate]]) -> list:
    """DTensor placements, one a dim of ``mesh`` (a ``DeviceMesh``), for
    a PartitionSpec."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {axes} shard one dim out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def _tp_fsdp_sp_rules() -> Dict[Optional[str], List[Candidate]]:
    fsdp: List[Candidate] = [("pod", "data"), "data"]
    tp: List[Candidate] = ["model"]
    return {
        # activations
        "batch": list(fsdp),
        "seq": list(tp),        # sequence-parallel residual layout
        "seq_full": [],         # replicated sequence inside attention/FFN
        # MoE region: SP-aware expert parallelism keeps the sequence
        # sharded over `model` so each plane all-to-alls only its shard
        # (models.moe ep_mode="sp"; divisibility fallback -> replicated)
        "seq_moe": list(tp),
        "kv_seq": [],
        "act_heads": list(tp),
        "kv_heads_act": list(tp),
        "act_ffn": list(tp),
        "vocab_out": list(tp),
        # parameters
        "embed": list(fsdp),
        "embed2": [],           # norm scales/biases replicate
        "vocab": list(tp),
        "heads": list(tp),
        "kv_heads": list(tp),
        "head_dim": [],
        "ffn": list(tp),
        "expert": list(fsdp),   # expert parallelism over the data axis
        "expert_embed": [],
        "expert_ffn": list(tp),
        "ssm_inner": list(tp),
        "ssm_heads": list(tp),
        "lru": list(tp),
        "conv_k": [],
        "layers": [],           # stacked-layer leading dim stays unsharded
        # pipeline: the stage-stacked block dim lives on the stage axis
        # (skipped on meshes without one — same code runs 3D and 4D)
        "stage": ["stage"],
    }


def _dp_only_rules() -> Dict[Optional[str], List[Candidate]]:
    """Naive data parallelism: batch over (pod x) data, replicate the rest."""
    return {"batch": [("pod", "data"), "data"]}


_STRATEGIES = {
    "tp+fsdp+sp": _tp_fsdp_sp_rules,
    "dp_only": _dp_only_rules,
}


def make_rules(mesh, strategy: str = "tp+fsdp+sp") -> ShardingRules:
    if strategy not in _STRATEGIES:
        raise ValueError(
            f"unknown sharding strategy {strategy!r}; known: {sorted(_STRATEGIES)}")
    return ShardingRules(mesh=mesh, rules=_STRATEGIES[strategy]())


# ------------------------------------------------------- active-rules context
_ACTIVE: List[ShardingRules] = []


@contextmanager
def use_rules(rules: ShardingRules):
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def active_rules() -> Optional[ShardingRules]:
    return _ACTIVE[-1] if _ACTIVE else None


def distribute(x: torch.Tensor, mesh, place: list):
    """``x``, the same whole tensor on every rank, as a DTensor with
    ``place``: each rank keeps its own shard, no communication."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(x, mesh, [Replicate()] * len(place),
                             run_check=False)
    return rep.redistribute(mesh, place)


def constrain(x, *axes):
    """Lay ``x`` out by its logical axes under the active rules.

    Identity when no rules are active, so model code is oblivious to
    whether it runs on one device or sharded.  Under rules on a
    ``DeviceMesh`` a DTensor is redistributed to the spec, and a plain
    tensor (a replica on every rank) is distributed to it.
    """
    rules = active_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    place = rules.sharding_for(axes, x.shape)
    if isinstance(x, DTensor):
        return x.redistribute(rules.mesh, place)
    return distribute(x, rules.mesh, place)


def write_(dst, method: str, *args):
    """``getattr(dst, method)(*args)``, an in-place write into ``dst``
    (``index_copy_``, ``copy_``...), returning ``dst``.  On a DTensor each
    rank writes its own shard: a tensor argument with ``dst``'s number of
    dims is laid out like ``dst``, any other (an index) is replicated; the
    written dims must be ones ``dst`` does not shard."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(dst, DTensor):
        getattr(dst, method)(*args)
        return dst
    mesh = dst.device_mesh

    def local(a):
        if not isinstance(a, torch.Tensor):
            return a
        place = (list(dst.placements) if a.ndim == dst.ndim
                 else [Replicate()] * mesh.ndim)
        if not isinstance(a, DTensor):
            return distribute(a, mesh, place).to_local()
        return a.redistribute(mesh, place).to_local()

    getattr(dst.to_local(), method)(*[local(a) for a in args])
    return dst
