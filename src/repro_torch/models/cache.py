"""Decode caches of the port (the ``ssm`` kind of ``repro.models.cache``).

``LayerCache`` of kind ``ssm`` holds a Mamba-2 layer's conv tails
(``conv_x`` (B, K-1, d_inner), ``conv_bc`` (B, K-1, 2GN), in the model
dtype) and its float32 SSD state (B, H, P, N).  ``stack_caches`` gives the
stacked layout: one ``LayerCache`` whose tensors lead with a layer dim.
The ``full``, ``ring`` and ``rglru`` kinds come with attention and RG-LRU.

Unlike the reference's pure functions, the port updates caches in place:
``model.forward`` writes each layer's new tails and state into the tensors
it was given, and ``reset_slot`` / ``write_prompt`` overwrite one batch
slot of the persistent serving cache (a list or a stacked cache), so the
engine holds one copy of it for its whole life.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from .layers import dtype_of

_STATE_FIELDS = ("conv_x", "conv_bc", "state")


@dataclasses.dataclass
class LayerCache:
    kind: str
    conv_x: Optional[torch.Tensor] = None
    conv_bc: Optional[torch.Tensor] = None
    state: Optional[torch.Tensor] = None

    def tensors(self):
        return [getattr(self, f) for f in _STATE_FIELDS
                if getattr(self, f) is not None]

    def layer(self, i: int) -> "LayerCache":
        """Views of layer ``i`` of a stacked cache (writes go through)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f)[i] for f in _STATE_FIELDS
            if getattr(self, f) is not None})


def init_layer_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     per_slot_pos: bool = False, device=None) -> LayerCache:
    """A zeroed cache for one layer.  ``max_len`` and ``per_slot_pos`` size
    and place attention caches; an ``ssm`` cache has no cursor."""
    if kind != "ssd":
        raise NotImplementedError(
            f"no {kind!r} cache in the port yet: attention caches come with "
            f"the flash-attention slice (K5), rglru with the RG-LRU slice")
    d_in = cfg.ssm_expand * cfg.d_model
    H, G, N = d_in // cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    K = cfg.ssm_conv
    return LayerCache(
        kind="ssm",
        conv_x=torch.zeros(batch, K - 1, d_in, dtype=dtype, device=device),
        conv_bc=torch.zeros(batch, K - 1, 2 * G * N, dtype=dtype,
                            device=device),
        state=torch.zeros(batch, H, cfg.ssm_headdim, N, dtype=torch.float32,
                          device=device),
    )


def init_caches(cfg, batch: int, max_len: int, dtype=None,
                per_slot_pos: bool = False, device=None) -> List[LayerCache]:
    dtype = dtype or dtype_of(cfg)
    return [init_layer_cache(kind, cfg, batch, max_len, dtype,
                             per_slot_pos=per_slot_pos, device=device)
            for kind in cfg.pattern_for_depth()]


# ------------------------------------------------- slot lifecycle (serving)
Caches = Union[LayerCache, List[LayerCache]]


def stack_caches(caches: Sequence[LayerCache]) -> LayerCache:
    """Per-layer list -> one LayerCache with a leading layer dim."""
    kinds = {c.kind for c in caches}
    if len(kinds) != 1:
        raise ValueError(f"cannot stack heterogeneous cache kinds {kinds}")
    first = caches[0]
    return dataclasses.replace(first, **{
        f: torch.stack([getattr(c, f) for c in caches])
        for f in _STATE_FIELDS if getattr(first, f) is not None})


def unstack_caches(stacked: LayerCache, num_layers: int) -> List[LayerCache]:
    """Inverse of ``stack_caches`` (views)."""
    return [stacked.layer(i) for i in range(num_layers)]


def _layers(caches: Caches) -> List[LayerCache]:
    """Per-layer caches with the batch dim first (views of a stacked one)."""
    if isinstance(caches, LayerCache):
        return unstack_caches(caches, caches.tensors()[0].shape[0])
    return list(caches)


def reset_slot(caches: Caches, slot: int) -> Caches:
    """Zero batch slot ``slot`` across every layer, in place."""
    if isinstance(caches, LayerCache):  # one write a field for all layers
        for t in caches.tensors():
            t[:, slot].zero_()
        return caches
    for c in caches:
        for t in c.tensors():
            t[slot].zero_()
    return caches


def write_prompt(caches: Caches, slot: int, prefill: Caches) -> Caches:
    """Admit a prefilled request into batch slot ``slot``, in place.

    ``prefill`` is the cache a B=1 unpadded prefill produced (a list or a
    stacked cache); its whole per-slot state replaces whatever the freed
    slot held, so admission into a dirty slot needs no reset first.
    """
    if isinstance(caches, LayerCache) and isinstance(prefill, LayerCache):
        pairs = [(caches, prefill, (slice(None), slot), (slice(None), 0))]
    else:
        dst, src = _layers(caches), _layers(prefill)
        if len(dst) != len(src):
            raise ValueError(f"{len(src)} prefill layers for {len(dst)} "
                             f"layers")
        pairs = [(c, p, slot, 0) for c, p in zip(dst, src)]
    for c, p, at, row in pairs:
        if c.kind != p.kind:
            raise ValueError(f"cache kind mismatch: {c.kind} vs {p.kind}")
        for f in _STATE_FIELDS:
            a = getattr(c, f)
            if a is not None:
                a[at].copy_(getattr(p, f)[row])
    return caches
