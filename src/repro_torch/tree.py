"""Nested parameter and state trees: dicts, lists, tuples and dataclasses
of tensors, with None as an empty subtree.

The order and the key strings are JAX's (``tree_flatten_with_path`` and
``keystr``): dict keys sorted, ``['key']`` for a dict entry, ``[i]`` for a
list item, ``.field`` for a dataclass field.  So a flat key list names the
same leaf in both packages (the checkpoint manifest keeps it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch


def flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """[(key string, leaf)] in JAX's order."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in flatten(getattr(tree, f.name), f"{path}.{f.name}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of the same structure), in a tree of that structure."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Any, new_leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (in ``flatten``
    order)."""
    keys = [k for k, _ in flatten(like)]
    if len(keys) != len(new_leaves):
        raise ValueError(f"{len(new_leaves)} leaves for a tree of "
                         f"{len(keys)}")
    return _rebuild(like, "", dict(zip(keys, new_leaves)))


_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits_sum(t: torch.Tensor) -> int:
    """The tensor's elements read as integers of their width and summed,
    exactly (int64, in chunks so that no copy of the whole tensor is
    made): order-free, so the sums of a partition add up to the whole's
    on any device."""
    flat = t.detach().contiguous().view(-1).view(_BITS[t.element_size()])
    return int(torch.stack([c.sum(dtype=torch.int64)
                            for c in flat.split(1 << 24)]).sum())


def fingerprint(tree: Any) -> Dict[str, int]:
    """``bits_sum`` of every leaf, by its key: two trees with equal
    fingerprints hold the same bits but for an unlikely collision."""
    return {k: bits_sum(v) for k, v in flatten(tree)}


def _rebuild(tree: Any, path: str, by_key: dict) -> Any:
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), f"{path}.{f.name}",
                             by_key) for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{path}[{k!r}]", by_key)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, f"{path}[{i}]", by_key)
                          for i, v in enumerate(tree))
    return by_key[path]
