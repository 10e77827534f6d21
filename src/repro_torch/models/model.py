"""The port's LM: builds a model from its config (the port of
``repro.models.model``).

Block kinds (cycled through ``cfg.block_pattern``):
  attn       - pre-norm GQA attention + gated or plain MLP
  local_attn - the same with ``cfg.local_window`` sliding window
  moe        - attention (``cfg.window``) + top-k MoE FFN, plus Arctic's
               dense MLP in parallel (``cfg.dense_residual_ff``)
  ssd        - Mamba-2 mixer block (no MLP)
  rglru      - Griffin recurrent block + MLP
A config with a modality frontend raises ``NotImplementedError`` naming
the slice that brings it.  ``forward`` runs the MoE dense path and
returns no aux losses (the training slice sums them over layers).

Parameters are a nested dict of tensors with the reference's keys:
``embed``, ``final_norm``, ``head`` when the embeddings are not tied, and
either the blocks stacked on a leading layer dim (``blocks_scanned``, for
``cfg.scan_layers`` with one block kind) or a list of per-layer dicts
(``blocks``: RecurrentGemma's heterogeneous 26-layer stack).  The port
loops over layers in Python in both layouts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from ..backends.base import resolve_device
from . import layers as L
from .cache import LayerCache, unstack_caches
from .moe import apply_moe, init_moe
from .rglru import apply_rglru_block, init_rglru_block
from .ssm import apply_ssd_block, init_ssd_block

KINDS = ("attn", "local_attn", "moe", "ssd", "rglru")


def check_supported(cfg) -> None:
    for kind in sorted(set(cfg.pattern_for_depth())):
        if kind not in KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend (inputs as "
            f"embeddings) comes with the VLM and audio slice")


def scanned(cfg) -> bool:
    """Whether the blocks are stacked on a layer dim (the reference scans
    them): ``cfg.scan_layers`` and a single block kind."""
    return bool(cfg.scan_layers) and len(set(cfg.pattern_for_depth())) == 1


def _generator(generator, device: torch.device) -> Optional[torch.Generator]:
    if device.type == "meta":  # shapes and dtypes only
        return None
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, parameters "
                             f"on {device}")
        return generator
    return torch.Generator(device).manual_seed(int(generator))


def init_block(gen, kind: str, cfg, dtype, device,
               layers: Optional[int] = None) -> Dict:
    """One block's parameters, or ``layers`` blocks stacked."""
    d = cfg.d_model
    if kind in ("attn", "local_attn"):
        return {
            "norm1": L.init_norm(d, dtype, cfg.norm, device, layers),
            "attn": L.init_attention(gen, cfg, dtype, device, layers),
            "norm2": L.init_norm(d, dtype, cfg.norm, device, layers),
            "mlp": L.init_mlp(gen, cfg, dtype, device, layers),
        }
    if kind == "moe":
        p = {
            "norm1": L.init_norm(d, dtype, cfg.norm, device, layers),
            "attn": L.init_attention(gen, cfg, dtype, device, layers),
            "norm2": L.init_norm(d, dtype, cfg.norm, device, layers),
            "moe": init_moe(gen, cfg, dtype, device, layers),
        }
        if cfg.dense_residual_ff:
            p["mlp"] = L.init_mlp(gen, cfg, dtype, device, layers,
                                  d_ff=cfg.dense_residual_ff)
        return p
    if kind == "ssd":
        return {"ssd": init_ssd_block(gen, cfg, dtype, device, layers)}
    if kind == "rglru":
        return {
            "rec": init_rglru_block(gen, cfg, dtype, device, layers),
            "norm2": L.init_norm(d, dtype, cfg.norm, device, layers),
            "mlp": L.init_mlp(gen, cfg, dtype, device, layers),
        }
    raise ValueError(kind)


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
    pattern = cfg.pattern_for_depth()
    if scanned(cfg):
        tree["blocks_scanned"] = init_block(gen, pattern[0], cfg, dt, device,
                                            layers=cfg.num_layers)
    else:
        tree["blocks"] = [init_block(gen, kind, cfg, dt, device)
                          for kind in pattern]
    return tree


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(params: Dict, cfg) -> List[Dict]:
    """Per-layer parameter dicts (views of a stacked tree)."""
    if "blocks" in params:
        return list(params["blocks"])
    return [_index(params["blocks_scanned"], i)
            for i in range(cfg.num_layers)]


def apply_block(p: Dict, kind: str, x: torch.Tensor, cfg,
                positions: torch.Tensor, cache: Optional[LayerCache] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x', new cache tensors of a recurrent block or None).  An
    attention block updates its cache in place itself."""
    new = None
    if kind in ("attn", "local_attn", "moe"):
        window = cfg.local_window if kind == "local_attn" else cfg.window
        h = L.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps)
        x = x + L.apply_attention(p["attn"], h, cfg, positions, window=window,
                                  cache=cache, kernel_impl=cfg.kernel_impl)
        h = L.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
        if kind == "moe":
            m, _ = apply_moe(p["moe"], h, cfg, impl=cfg.moe_impl)
            if "mlp" in p:  # Arctic: a dense MLP in parallel
                m = m + L.apply_mlp(p["mlp"], h, cfg)
            x = x + m
        else:
            x = x + L.apply_mlp(p["mlp"], h, cfg)
    elif kind == "ssd":
        a, new = apply_ssd_block(p["ssd"], x, cfg, cache=cache,
                                 kernel_impl=cfg.kernel_impl)
        x = x + a
    elif kind == "rglru":
        a, new = apply_rglru_block(p["rec"], x, cfg, cache=cache)
        x = x + a
        h = L.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps)
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    else:
        raise ValueError(kind)
    return x, new


def _write(cache: LayerCache, new: Dict, scan: bool = True) -> None:
    """Write a recurrent block's new cache tensors in place.

    A prompt shorter than the conv window yields fewer tail rows than the
    cache holds.  The reference places them by how it runs the layers, and
    the port follows it: a scanned stack writes them into the leading rows
    and the others keep what they held (``dynamic_update_index_in_dim``);
    an unrolled stack keeps the short tail as the layer's cache until
    ``write_prompt`` broadcasts it over the rows (``.at[slot].set``), so it
    is broadcast here.
    """
    for f, src in new.items():
        dst = getattr(cache, f)
        if scan:
            dst[:, :src.shape[1]].copy_(src)
        else:
            dst.copy_(src)


def forward(params: Dict, cfg, tokens: torch.Tensor,
            caches: Optional[Union[LayerCache, List[LayerCache]]] = None,
            pos=0, last_token_only: bool = False
            ) -> Tuple[torch.Tensor, Optional[Union[LayerCache,
                                                    List[LayerCache]]]]:
    """(B, S) tokens -> ((B, S or 1, vocab) logits, caches).

    ``caches`` (a per-layer list, or a stacked cache for a scanned stack)
    is updated in place and returned.  ``pos`` is the absolute position of
    the first token, an int, a 0-d tensor or (B,) per-slot depths; it sets
    the RoPE positions (attention caches keep their own cursors).
    """
    check_supported(cfg)
    B, S = tokens.shape
    h = L.apply_embedding(params["embed"], tokens)
    steps = torch.arange(S, device=tokens.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos.to(tokens.device)[:, None] + steps[None, :]
    else:
        positions = (steps + pos)[None, :].expand(B, S)
    per_layer = (unstack_caches(caches, cfg.num_layers)
                 if isinstance(caches, LayerCache) else caches)
    scan = scanned(cfg)
    pattern = cfg.pattern_for_depth()
    for i, bp in enumerate(layer_params(params, cfg)):
        cache_i = per_layer[i] if per_layer is not None else None
        h, new = apply_block(bp, pattern[i], h, cfg, positions, cache_i)
        if new is not None:
            _write(cache_i, new, scan)
    if last_token_only:
        h = h[:, -1:, :]
    h = L.apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return L.apply_unembed(head, h), caches
