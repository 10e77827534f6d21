"""Abstract inputs and their shardings for every dry-run cell (the port of
``repro.launch.specs``).

``batch_struct``, ``params_struct``, ``state_struct`` and ``caches_struct``
return trees of meta tensors (shapes and dtypes, no storage) beside the
logical-axes tree of each; ``shardings_from_axes`` turns an axes tree and
its struct tree into a tree of DTensor placements through the
divisibility-fallback rules (or of ``PartitionSpec``s with ``spec=True``,
which needs no device mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..configs import InputShape
from ..dist.sharding import ShardingRules, distribute
from ..models import model as M
from ..models.cache import cache_logical_axes, init_caches, stack_caches
from ..optim import adamw
from ..train import train_step as TS

META = torch.device("meta")


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_axes(fn, axes_tree, struct_tree):
    """``fn(axes, struct leaf)`` over an axes tree and the tree of values
    it describes (dicts, lists, dataclasses; a dataclass's str fields,
    such as a cache's ``kind``, are kept)."""
    if axes_tree is None or isinstance(axes_tree, str):
        return axes_tree
    if is_axes(axes_tree):
        return fn(axes_tree, struct_tree)
    if dataclasses.is_dataclass(axes_tree):
        return dataclasses.replace(axes_tree, **{
            f.name: map_axes(fn, getattr(axes_tree, f.name),
                             getattr(struct_tree, f.name))
            for f in dataclasses.fields(axes_tree)})
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, struct_tree[k])
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, a, s)
                               for a, s in zip(axes_tree, struct_tree))
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def shardings_from_axes(axes_tree, struct_tree, rules: ShardingRules,
                        spec: bool = False):
    """logical-axes tree + value tree -> a tree of DTensor placements on
    ``rules.mesh`` (``spec=True``: of ``PartitionSpec``s)."""
    resolve = rules.spec_for if spec else rules.sharding_for
    return map_axes(lambda ax, s: resolve(ax, tuple(s.shape)), axes_tree,
                    struct_tree)


def place(values, axes_tree, rules: ShardingRules):
    """A tree of tensors (each the same whole tensor on every rank) as
    DTensors on ``rules.mesh``, laid out by their logical axes; each rank
    keeps its own shards."""
    return map_axes(
        lambda ax, t: distribute(t, rules.mesh,
                                 rules.sharding_for(ax, tuple(t.shape))),
        axes_tree, values)


def batch_struct(cfg, shape: InputShape) -> Tuple[Dict, Dict]:
    """(struct, logical axes) for one training/prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend:
        return (
            {"embeds": torch.empty(B, S, cfg.d_model, dtype=torch.bfloat16,
                                   device=META),
             "labels": torch.empty(B, S, dtype=torch.int32, device=META)},
            {"embeds": ("batch", "seq", None), "labels": ("batch", "seq")},
        )
    return (
        {"tokens": torch.empty(B, S, dtype=torch.int32, device=META),
         "labels": torch.empty(B, S, dtype=torch.int32, device=META)},
        {"tokens": ("batch", "seq"), "labels": ("batch", "seq")},
    )


def params_struct(cfg):
    """(params on the meta device, logical axes): ``model.model_spec``."""
    return M.model_spec(cfg)


def state_struct(cfg, tcfg: TS.TrainConfig):
    """(TrainState on the meta device, its logical-axes TrainState)."""
    state = TS.init_state(cfg, tcfg, device=META)
    _, axes = M.model_spec(cfg)
    axes_state = TS.TrainState(
        step=(),
        params=axes,
        opt=adamw.state_logical_axes(state.opt, axes),
    )
    return state, axes_state


def caches_struct(cfg, batch: int, max_len: int):
    """(caches on the meta device, matching logical axes).

    Scanned homogeneous stacks get a single stacked LayerCache (leading
    layer dim); heterogeneous stacks get the per-layer list."""
    caches = init_caches(cfg, batch, max_len, dtype=torch.bfloat16,
                         device=META)
    if M.scanned(cfg):
        ax = cache_logical_axes(caches[0])
        axes = map_axes(lambda a, _: (None,) + tuple(a), ax, caches[0])
        return stack_caches(caches), axes
    return caches, [cache_logical_axes(c) for c in caches]


def _mesh_size(mesh, axis: str) -> int:
    from ..dist.sharding import mesh_axes

    return mesh_axes(mesh).get(axis, 1)


def decode_grad_accum(cfg, shape: InputShape, mesh) -> int:
    return 1


def train_grad_accum(cfg, shape: InputShape, mesh) -> int:
    """Pick microbatching so per-device microbatch stays small (<=4)."""
    dp = _mesh_size(mesh, "data") * _mesh_size(mesh, "pod")
    b_loc = max(1, shape.global_batch // dp)
    return max(1, b_loc // 4)
