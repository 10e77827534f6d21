"""Decode caches of the port (the port of ``repro.models.cache``).

``LayerCache`` kinds, per block kind:
  full  - (B, max_len, Hkv, Dh) K/V, for full-attention layers
  ring  - (B, W, Hkv, Dh) sliding-window ring buffer (local attention,
          and attention or MoE blocks with ``cfg.window``, whenever the
          window W is below ``max_len``)
  ssm   - Mamba-2 conv tails (B, K-1, d_inner) and (B, K-1, 2GN) and the
          float32 SSD state (B, H, P, N)
  rglru - conv tail (B, K-1, w) and the float32 recurrent state (B, w)
The attention kinds carry a cursor ``pos``: a 0-d tensor (every row at the
same depth) or, with ``per_slot_pos``, one a batch slot (B,), and an
optional ``start`` (B,), each slot's first real row.  ``stack_caches``
gives the stacked layout: one ``LayerCache`` whose tensors lead with a
layer dim, for homogeneous stacks only.

Unlike the reference's pure functions, the port updates caches in place:
attention layers write their K/V rows and advance ``pos`` on the device,
``model.forward`` writes each recurrent layer's new tails and state into
the tensors it was given, and ``reset_slot`` / ``write_prompt`` overwrite
one batch slot of the persistent serving cache (a list or a stacked
cache), so the engine holds one copy of it for its whole life.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from .layers import dtype_of

_STATE_FIELDS = ("k", "v", "conv_x", "conv_bc", "state", "conv", "h")
_CURSOR_FIELDS = ("pos", "start")
_FIELDS = _STATE_FIELDS + _CURSOR_FIELDS


@dataclasses.dataclass
class LayerCache:
    kind: str
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    conv_x: Optional[torch.Tensor] = None
    conv_bc: Optional[torch.Tensor] = None
    state: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None
    h: Optional[torch.Tensor] = None
    start: Optional[torch.Tensor] = None  # (B,) first real row (attn kinds)

    def tensors(self):
        """The state tensors (K/V, tails, states), not the cursors."""
        return [getattr(self, f) for f in _STATE_FIELDS
                if getattr(self, f) is not None]

    def layer(self, i: int) -> "LayerCache":
        """Views of layer ``i`` of a stacked cache (writes go through)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f)[i] for f in _FIELDS
            if getattr(self, f) is not None})


def init_layer_cache(kind: str, cfg, batch: int, max_len: int, dtype,
                     per_slot_pos: bool = False, device=None) -> LayerCache:
    """A zeroed cache for one layer of block kind ``kind``."""
    if kind == "ssd":
        d_in = cfg.ssm_expand * cfg.d_model
        H, G, N = d_in // cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
        K = cfg.ssm_conv
        return LayerCache(
            kind="ssm",
            conv_x=torch.zeros(batch, K - 1, d_in, dtype=dtype, device=device),
            conv_bc=torch.zeros(batch, K - 1, 2 * G * N, dtype=dtype,
                                device=device),
            state=torch.zeros(batch, H, cfg.ssm_headdim, N,
                              dtype=torch.float32, device=device),
        )
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return LayerCache(
            kind="rglru",
            conv=torch.zeros(batch, cfg.conv1d_width - 1, w, dtype=dtype,
                             device=device),
            h=torch.zeros(batch, w, dtype=torch.float32, device=device),
        )
    if kind in ("attn", "moe"):
        window = cfg.window
    elif kind == "local_attn":
        window = cfg.local_window
    else:
        raise ValueError(kind)
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    pos0 = torch.zeros((batch,) if per_slot_pos else (), dtype=torch.int64,
                       device=device)
    rows = window if window is not None and window < max_len else max_len
    return LayerCache(
        kind="ring" if rows < max_len else "full",
        k=torch.zeros(batch, rows, Hkv, Dh, dtype=dtype, device=device),
        v=torch.zeros(batch, rows, Hkv, Dh, dtype=dtype, device=device),
        pos=pos0,
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
    """Per-layer list -> one LayerCache with a leading layer dim (for
    homogeneous stacks: every layer the same kind and shape)."""
    kinds = {c.kind for c in caches}
    if len(kinds) != 1:
        raise ValueError(f"cannot stack heterogeneous cache kinds {kinds}")
    first = caches[0]
    return dataclasses.replace(first, **{
        f: torch.stack([getattr(c, f) for c in caches])
        for f in _FIELDS if getattr(first, f) is not None})


def unstack_caches(stacked: LayerCache, num_layers: int) -> List[LayerCache]:
    """Inverse of ``stack_caches`` (views)."""
    return [stacked.layer(i) for i in range(num_layers)]


def _per_slot(a: torch.Tensor, stacked: bool) -> bool:
    """Whether a cursor holds one value a slot (else one for all)."""
    return a.ndim == (2 if stacked else 1)


def _slot_view(a: torch.Tensor, slot: int, stacked: bool) -> torch.Tensor:
    return a[:, slot] if stacked else a[slot]


def _reset_layer(c: LayerCache, slot: int, stacked: bool) -> None:
    for t in c.tensors():
        _slot_view(t, slot, stacked).zero_()
    for f in _CURSOR_FIELDS:
        a = getattr(c, f)
        if a is not None:
            (_slot_view(a, slot, stacked) if _per_slot(a, stacked)
             else a).zero_()


def reset_slot(caches: Caches, slot: int) -> Caches:
    """Zero batch slot ``slot`` across every layer (cursors included), in
    place.  A scalar cursor is shared by every slot, and is zeroed."""
    if isinstance(caches, LayerCache):  # one write a field for all layers
        _reset_layer(caches, slot, stacked=True)
    else:
        for c in caches:
            _reset_layer(c, slot, stacked=False)
    return caches


def _write_layer(c: LayerCache, p: LayerCache, slot: int,
                 stacked: bool) -> None:
    if c.kind != p.kind:
        raise ValueError(f"cache kind mismatch: {c.kind} vs {p.kind}")
    for f in _STATE_FIELDS:
        a = getattr(c, f)
        if a is not None:
            src = getattr(p, f)
            _slot_view(a, slot, stacked).copy_(src[:, 0] if stacked
                                               else src[0])
    for f in _CURSOR_FIELDS:
        a = getattr(c, f)
        if a is None:
            continue
        if not _per_slot(a, stacked):
            raise ValueError(
                "write_prompt needs per-slot cursors; build the engine cache "
                "with init_caches(..., per_slot_pos=True)")
        src = getattr(p, f)
        dst = _slot_view(a, slot, stacked)
        if src is None:
            dst.zero_()
        elif _per_slot(src, stacked):  # (1,) or (L, 1)
            dst.copy_(src[..., 0])
        else:
            dst.copy_(src)


def write_prompt(caches: Caches, slot: int, prefill: Caches) -> Caches:
    """Admit a prefilled request into batch slot ``slot``, in place.

    ``prefill`` is the cache a B=1 unpadded prefill produced, in the same
    layout as ``caches``; its whole per-slot state (K/V rows, tails,
    states and cursors) replaces whatever the freed slot held, so
    admission into a dirty slot needs no reset first.
    """
    if isinstance(caches, LayerCache):
        if not isinstance(prefill, LayerCache):
            prefill = stack_caches(prefill)
        _write_layer(caches, prefill, slot, stacked=True)
        return caches
    if isinstance(prefill, LayerCache):
        prefill = unstack_caches(prefill, prefill.tensors()[0].shape[0])
    if len(caches) != len(prefill):
        raise ValueError(f"{len(prefill)} prefill layers for {len(caches)} "
                         f"layers")
    for c, p in zip(caches, prefill):
        _write_layer(c, p, slot, stacked=False)
    return caches


def cache_logical_axes(cache: LayerCache) -> LayerCache:
    """Logical sharding axes of each of a layer cache's tensors, in a
    ``LayerCache`` of the same kind (the cursors' axes are ``()``)."""
    kind = cache.kind
    if kind in ("full", "ring"):
        return LayerCache(
            kind=kind,
            k=("batch", "kv_seq", "kv_heads_act", None),
            v=("batch", "kv_seq", "kv_heads_act", None),
            pos=(),
        )
    if kind == "ssm":
        return LayerCache(
            kind=kind,
            conv_x=("batch", None, "ssm_inner"),
            conv_bc=("batch", None, None),
            state=("batch", "ssm_heads", None, None),
        )
    if kind == "rglru":
        return LayerCache(
            kind=kind,
            conv=("batch", None, "lru"),
            h=("batch", "lru"),
        )
    raise ValueError(kind)
