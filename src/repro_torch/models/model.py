"""The port's LM: builds a model from its config (the port of
``repro.models.model``).

Block kinds (cycled through ``cfg.block_pattern``):
  attn       - pre-norm GQA attention + gated or plain MLP
  local_attn - the same with ``cfg.local_window`` sliding window
  moe        - attention (``cfg.window``) + top-k MoE FFN, plus Arctic's
               dense MLP in parallel (``cfg.dense_residual_ff``)
  ssd        - Mamba-2 mixer block (no MLP)
  ssd_moe    - Mamba-2 mixer block + the ``moe`` kind's FFN (Granite 4.0-H)
  rglru      - Griffin recurrent block + MLP
Each residual branch is scaled by ``cfg.residual_multiplier`` where it is
not 1, the embeddings by ``cfg.embedding_multiplier`` and the logits
divided by ``cfg.logits_scaling`` (Granite's scalings).
A config with a modality frontend (Qwen2-VL's vision, HuBERT's audio)
takes its inputs as embeddings (``forward(..., embeds=)``).  ``forward``
runs the MoE dense path; with ``return_aux`` it also returns the MoE aux
losses summed over the layers, which the train step adds to its loss.
``cfg.remat`` checkpoints each block of a cacheless forward that records
gradients, as the reference's ``jax.checkpoint`` does: ``"full"`` keeps
only the residual stream between blocks, ``"selective"`` also keeps the
outputs of the unbatched matmuls (``aten.mm``/``addmm``), the reference's
``dots_with_no_batch_dims_saveable``.

Parameters are a nested dict of tensors with the reference's keys:
``embed``, ``final_norm``, ``head`` when the embeddings are not tied, and
either the blocks stacked on a leading layer dim (``blocks_scanned``, for
``cfg.scan_layers`` with one block kind) or a list of per-layer dicts
(``blocks``: RecurrentGemma's heterogeneous 26-layer stack).  The port
loops over layers in Python in both layouts.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.utils import checkpoint as ckpt

from .. import tree as T
from ..backends.base import resolve_device
from ..dist.sharding import constrain
from . import layers as L
from .cache import LayerCache, unstack_caches
from .moe import apply_moe, init_moe
from .rglru import apply_rglru_block, init_rglru_block
from .ssm import apply_ssd_block, init_ssd_block

KINDS = ("attn", "local_attn", "moe", "ssd", "ssd_moe", "rglru")
REMATS = ("none", "full", "selective")
_SAVED_BY_SELECTIVE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_supported(cfg) -> None:
    for kind in sorted(set(cfg.pattern_for_depth())):
        if kind not in KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported")
    if cfg.remat not in REMATS:
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}; known: "
                         f"{REMATS}")


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
               layers: Optional[int] = None, leaves: bool = False) -> Dict:
    """One block's parameters, or ``layers`` blocks stacked; with
    ``leaves``, as ``layers.Leaf``s (each tensor with its logical axes)."""
    d = cfg.d_model
    kw = dict(leaves=leaves)

    def norm():
        return L.init_norm(d, dtype, cfg.norm, device, layers, **kw)

    if kind in ("attn", "local_attn"):
        return {
            "norm1": norm(),
            "attn": L.init_attention(gen, cfg, dtype, device, layers, **kw),
            "norm2": norm(),
            "mlp": L.init_mlp(gen, cfg, dtype, device, layers, **kw),
        }
    if kind in ("moe", "ssd_moe"):
        if kind == "moe":
            p = {
                "norm1": norm(),
                "attn": L.init_attention(gen, cfg, dtype, device, layers,
                                         **kw),
            }
        else:
            p = {"ssd": init_ssd_block(gen, cfg, dtype, device, layers,
                                       **kw)}
        p["norm2"] = norm()
        p["moe"] = init_moe(gen, cfg, dtype, device, layers, **kw)
        if cfg.dense_residual_ff:
            p["mlp"] = L.init_mlp(gen, cfg, dtype, device, layers,
                                  d_ff=cfg.dense_residual_ff, **kw)
        return p
    if kind == "ssd":
        return {"ssd": init_ssd_block(gen, cfg, dtype, device, layers, **kw)}
    if kind == "rglru":
        return {
            "rec": init_rglru_block(gen, cfg, dtype, device, layers, **kw),
            "norm2": norm(),
            "mlp": L.init_mlp(gen, cfg, dtype, device, layers, **kw),
        }
    raise ValueError(kind)


def _init_tree(cfg, generator, device, leaves: bool) -> Dict:
    check_supported(cfg)
    device = resolve_device(device)
    gen = _generator(generator, device)
    dt = L.dtype_of(cfg)
    kw = dict(leaves=leaves)
    tree: Dict = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                  device, **kw),
        "final_norm": L.init_norm(cfg.d_model, dt, cfg.norm, device, **kw),
    }
    if not cfg.tie_embeddings:
        tree["head"] = L.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                        device, **kw)
    pattern = cfg.pattern_for_depth()
    if scanned(cfg):
        tree["blocks_scanned"] = init_block(gen, pattern[0], cfg, dt, device,
                                            layers=cfg.num_layers, **kw)
    else:
        tree["blocks"] = [init_block(gen, kind, cfg, dt, device, **kw)
                          for kind in pattern]
    return tree


def init_model(cfg, generator: Union[torch.Generator, int] = 0,
               device=None) -> Dict:
    """Random parameters from ``generator`` (or a seed) on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    return _init_tree(cfg, generator, device, leaves=False)


def init_model_leaves(cfg, generator: Union[torch.Generator, int] = 0,
                      device=None) -> Dict:
    """``init_model`` as a ``layers.Leaf`` tree: each parameter with its
    logical axes (the reference's ``init_model``)."""
    return _init_tree(cfg, generator, device, leaves=True)


def model_spec(cfg):
    """(params on the meta device, logical-axes tree): shapes and dtypes
    only, nothing allocated and nothing drawn (the dry run's path)."""
    return L.split_leaves(init_model_leaves(cfg, None, "meta"))


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
    return _block(p, kind, x, cfg, positions, cache)[:2]


def _block(p: Dict, kind: str, x: torch.Tensor, cfg, positions: torch.Tensor,
           cache: Optional[LayerCache] = None,
           held_pairs: Optional[torch.Tensor] = None):
    """``apply_block`` and the MoE block's aux losses: (x', new, (lb, z)),
    the losses None for any other block.  ``held_pairs``: the held
    experts' counter (``moe.apply_moe``)."""
    new, aux = None, None
    x = constrain(x, "batch", "seq", None)
    if kind in ("attn", "local_attn", "moe"):
        window = cfg.local_window if kind == "local_attn" else cfg.window
        h = L.seq_full(L.apply_norm(p["norm1"], x, cfg.norm, cfg.norm_eps))
        x = x + _branch(L.apply_attention(
            p["attn"], h, cfg, positions, window=window, cache=cache,
            kernel_impl=cfg.kernel_impl), cfg)
        if kind == "moe":
            x, aux = _moe_ffn(p, x, cfg, held_pairs)
        else:
            h = L.seq_full(L.apply_norm(p["norm2"], x, cfg.norm,
                                        cfg.norm_eps))
            x = x + L.apply_mlp(p["mlp"], h, cfg)
    elif kind in ("ssd", "ssd_moe"):
        a, new = apply_ssd_block(p["ssd"], x, cfg, cache=cache,
                                 kernel_impl=cfg.kernel_impl)
        x = x + _branch(a, cfg)
        if kind == "ssd_moe":
            x, aux = _moe_ffn(p, x, cfg, held_pairs)
    elif kind == "rglru":
        a, new = apply_rglru_block(p["rec"], x, cfg, cache=cache)
        x = x + a
        h = L.seq_full(L.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps))
        x = x + L.apply_mlp(p["mlp"], h, cfg)
    else:
        raise ValueError(kind)
    return constrain(x, "batch", "seq", None), new, aux


def _branch(a: torch.Tensor, cfg) -> torch.Tensor:
    """A residual branch scaled by ``cfg.residual_multiplier`` (unless 1)."""
    r = getattr(cfg, "residual_multiplier", 1.0)
    return a if r == 1.0 else a * r


def _moe_ffn(p: Dict, x: torch.Tensor, cfg,
             held_pairs: Optional[torch.Tensor] = None):
    """The ``moe`` kind's FFN and its residual: x + the experts (with
    Arctic's dense MLP or Granite's shared expert in parallel) on the
    normed x; returns (x', (lb, z))."""
    h = L.seq_full(L.apply_norm(p["norm2"], x, cfg.norm, cfg.norm_eps))
    m, metrics = apply_moe(p["moe"], h, cfg, impl=cfg.moe_impl,
                           held_pairs=held_pairs)
    if "mlp" in p:  # a dense MLP in parallel
        m = m + L.apply_mlp(p["mlp"], h, cfg)
    return x + _branch(m, cfg), (metrics["moe_lb_loss"],
                                 metrics["moe_z_loss"])


def _selective_contexts():
    def policy(ctx, op, *args, **kwargs):
        return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_SELECTIVE
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return ckpt.create_selective_checkpoint_contexts(policy)


def _remat_block(p: Dict, kind: str, x: torch.Tensor, cfg,
                 positions: torch.Tensor):
    """``_block`` without a cache under ``cfg.remat``: the block's
    activations are recomputed in the backward pass (all of them, or all
    but the unbatched matmuls' outputs)."""
    fn = functools.partial(_block, kind=kind, cfg=cfg, positions=positions)
    if cfg.remat == "none":
        return fn(p, x=x)
    extra = ({} if cfg.remat == "full"
             else {"context_fn": _selective_contexts})
    return ckpt.checkpoint(lambda pp, xx: fn(pp, x=xx), p, x,
                           use_reentrant=False, **extra)


def _write(cache: LayerCache, new: Dict, scan: bool = True) -> None:
    """Write a recurrent block's new cache tensors in place.

    A prompt shorter than the conv window yields fewer tail rows than the
    cache holds.  The reference places them by how it runs the layers, and
    the port follows it: a scanned stack writes them into the leading rows
    and the others keep what they held (``dynamic_update_index_in_dim``);
    an unrolled stack keeps the short tail as the layer's cache until
    ``write_prompt`` broadcasts it over the rows (``.at[slot].set``), so it
    is broadcast here.  A field whose new tensor is the cache's own
    memory (the SSM state, which ``ops.ssd_decode_step`` updates in place)
    is not copied onto itself.
    """
    for f, src in new.items():
        dst = getattr(cache, f)
        if scan:
            dst = dst[:, :src.shape[1]]
        if not _same_memory(src, dst):
            dst.copy_(src)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two plain tensors view the same memory alike: the same
    address, type, shape and strides (never for meta, fake or
    distributed tensors, which hold no address of their own)."""
    return (type(a) is torch.Tensor and type(b) is torch.Tensor
            and not a.is_meta and a.data_ptr() == b.data_ptr()
            and a.dtype == b.dtype and a.shape == b.shape
            and a.stride() == b.stride())


def forward(params: Dict, cfg, tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            caches: Optional[Union[LayerCache, List[LayerCache]]] = None,
            pos=0, last_token_only: bool = False, return_aux: bool = False,
            held_pairs: Optional[torch.Tensor] = None):
    """(B, S) tokens, or (B, S, d) ``embeds`` (a modality frontend's stub
    inputs, cast to the model's dtype in place of the embedding lookup) ->
    ((B, S or 1, vocab) logits, caches), and with ``return_aux`` a third
    item: {"moe_lb_loss", "moe_z_loss"}, float32 sums over the layers.

    ``caches`` (a per-layer list, or a stacked cache for a scanned stack)
    is updated in place and returned.  ``pos`` is the absolute position of
    the first token, an int, a 0-d tensor or (B,) per-slot depths; it sets
    the RoPE positions (attention caches keep their own cursors).  A
    cacheless forward that records gradients checkpoints each block under
    ``cfg.remat``.  ``held_pairs`` (an int64 device tensor) counts the
    (token, held expert) pairs of a model with ``cfg.experts_held``.
    """
    check_supported(cfg)
    if (tokens is None) == (embeds is None):
        raise ValueError("give tokens or embeds, one of them")
    if embeds is not None:
        h = embeds.to(L.dtype_of(cfg))
        B, S = embeds.shape[:2]
    else:
        h = L.apply_embedding(params["embed"], tokens)
        B, S = tokens.shape
    mult = getattr(cfg, "embedding_multiplier", 1.0)
    if mult != 1.0:
        h = h * mult
    h = constrain(h, "batch", "seq", None)
    steps = torch.arange(S, device=h.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos.to(h.device)[:, None] + steps[None, :]
    else:
        positions = (steps + pos)[None, :].expand(B, S)
    per_layer = (unstack_caches(caches, cfg.num_layers)
                 if isinstance(caches, LayerCache) else caches)
    remat = caches is None and torch.is_grad_enabled() and (
        h.requires_grad or any(t.requires_grad for t in T.leaves(params)))
    scan = scanned(cfg)
    pattern = cfg.pattern_for_depth()
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    zl = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, bp in enumerate(layer_params(params, cfg)):
        if remat:
            h, new, aux = _remat_block(bp, pattern[i], h, cfg, positions)
        else:
            cache_i = per_layer[i] if per_layer is not None else None
            h, new, aux = _block(bp, pattern[i], h, cfg, positions, cache_i,
                                 held_pairs)
            if new is not None:
                _write(cache_i, new, scan)
        if aux is not None:
            lb, zl = lb + aux[0], zl + aux[1]
    if last_token_only:
        h = h[:, -1:, :]
    h = L.seq_full(L.apply_norm(params["final_norm"], h, cfg.norm,
                                cfg.norm_eps))
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = L.apply_unembed(head, h)
    scaling = getattr(cfg, "logits_scaling", 1.0)
    if scaling != 1.0:
        logits = logits / scaling
    logits = constrain(logits, "batch", "seq", "vocab_out")
    if return_aux:
        return logits, caches, {"moe_lb_loss": lb, "moe_z_loss": zl}
    return logits, caches
