"""The port's LM: builds a stack of Mamba-2 (``ssd``) blocks from its config.

The port of the ``ssd`` branch of ``repro.models.model``.  Parameters are a
nested dict of tensors with the reference's keys: ``embed``,
``final_norm``, ``head`` when the embeddings are not tied, and the blocks
stacked on a leading layer dim (``blocks_scanned``; the port loops over
layers in Python, so it has no unstacked form).  Other block kinds raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from ..backends.base import resolve_device
from . import layers as L
from .cache import LayerCache, unstack_caches
from .ssm import apply_ssd_block, init_ssd_block

_LATER = {
    "attn": "attention blocks come with the flash-attention slice (K5)",
    "local_attn": "attention blocks come with the flash-attention slice (K5)",
    "moe": "MoE blocks come after the flash-attention slice (K5)",
    "rglru": "RG-LRU blocks come with the recurrentgemma slice",
}


def check_supported(cfg) -> None:
    for kind in sorted(set(cfg.pattern_for_depth())):
        if kind != "ssd":
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet; "
                f"{_LATER.get(kind, 'no slice brings it yet')}")


def _generator(generator, device: torch.device) -> Optional[torch.Generator]:
    if device.type == "meta":  # shapes and dtypes only
        return None
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, parameters "
                             f"on {device}")
        return generator
    return torch.Generator(device).manual_seed(int(generator))


def init_model(cfg, generator: Union[torch.Generator, int] = 0,
               device=None) -> Dict:
    """Random parameters from ``generator`` (or a seed) on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = _generator(generator, device)
    dt = L.dtype_of(cfg)
    tree: Dict = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                  device),
        "final_norm": L.init_norm(cfg.d_model, dt, cfg.norm, device),
    }
    if not cfg.tie_embeddings:
        tree["head"] = L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                        device)
    tree["blocks_scanned"] = {"ssd": init_ssd_block(
        gen, cfg, dt, device, layers=cfg.num_layers)}
    return tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(params: Dict, cfg) -> List[Dict]:
    """Per-layer parameter dicts (views of the stacked tree)."""
    return [_index(params["blocks_scanned"], i)
            for i in range(cfg.num_layers)]


def _write(cache: LayerCache, new: Dict) -> None:
    """Write a block's new cache tensors in place.  A prompt shorter than
    the conv window yields fewer tail rows than the cache holds: they go
    into the leading rows and the others keep what they held, as the
    reference's scan writes them (``dynamic_update_index_in_dim``)."""
    for f, src in new.items():
        dst = getattr(cache, f)
        dst[:, :src.shape[1]].copy_(src)


def forward(params: Dict, cfg, tokens: torch.Tensor,
            caches: Optional[Union[LayerCache, List[LayerCache]]] = None,
            pos=0, last_token_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[Union[LayerCache,
                                                    List[LayerCache]]]]:
    """(B, S) tokens -> ((B, S or 1, vocab) logits, caches).

    ``caches`` (a per-layer list or a stacked cache) is updated in place
    and returned.  ``pos`` (the first token's position, scalar or (B,)) is
    accepted for the reference's signature; an ``ssd`` stack has no
    positional term and does not read it.
    """
    check_supported(cfg)
    h = L.apply_embedding(params["embed"], tokens)
    if isinstance(caches, LayerCache):
        per_layer = unstack_caches(caches, cfg.num_layers)
    else:
        per_layer = caches
    for i, bp in enumerate(layer_params(params, cfg)):
        cache_i = per_layer[i] if per_layer is not None else None
        a, new = apply_ssd_block(bp["ssd"], h, cfg, cache=cache_i,
                                 kernel_impl=cfg.kernel_impl)
        h = h + a
        if new is not None:
            _write(cache_i, new)
    if last_token_only:
        h = h[:, -1:, :]
    h = L.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return L.apply_unembed(head, h), caches
