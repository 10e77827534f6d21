"""Common model layers of the port: init and apply over plain dicts of tensors.

The port of ``repro.models.layers``: norms, the embedding and the tied or
dedicated unembedding, the matmul convention and the init helpers, RoPE,
GQA attention over every cache kind, and the MLP.  Parameters are nested
dicts of tensors with the reference's keys and layouts.  With
``leaves=True`` an ``init_*`` returns ``Leaf(tensor, axes)`` instead of each
tensor: the tensor and the reference's logical-axis names, which
``split_leaves`` splits into a parameter tree and an axes tree (the axes
drive ``dist.sharding``; a stacked weight's lead with ``"layers"``).

All matmuls run in the parameter dtype with float32 accumulation (no TF32,
no reduced-precision bf16 reductions: ``repro_torch`` turns both off);
norms, RoPE and softmax in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.sharding import constrain, write_
from ..kernels import ops
from ..kernels.sharded import is_dtensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype a config's ``dtype`` names."""
    try:
        return DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; known: "
                         f"{sorted(DTYPES)}") from None


@dataclasses.dataclass
class Leaf:
    value: Any
    axes: Tuple[Optional[str], ...]


def is_leaf(x) -> bool:
    return isinstance(x, Leaf)


def _split(tree, part: str):
    if isinstance(tree, Leaf):
        return getattr(tree, part)
    if isinstance(tree, dict):
        return {k: _split(v, part) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split(v, part) for v in tree)
    return tree


def split_leaves(tree):
    """Leaf tree -> (parameter tree, logical-axes tree)."""
    return _split(tree, "value"), _split(tree, "axes")


def leaf(value: torch.Tensor, axes: Tuple[Optional[str], ...],
         layers: Optional[int] = None, leaves: bool = True):
    """``value``, or with ``leaves`` its ``Leaf``; a weight stacked on a
    leading layer dim gets ``"layers"`` in front of its axes."""
    if not leaves:
        return value
    return Leaf(value, axes if layers is None else ("layers",) + tuple(axes))


_DRAW = 1 << 28  # float32 elements ``_dense_init`` draws at once


def _dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
                device) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan-in), drawn in
    float32 and cast, as the reference's ``_dense_init``.  A tensor of more
    than ``_DRAW`` elements is drawn in slices of its leading dim, so that
    the float32 draw of a stacked weight (32 layers of Qwen2-72B's MLP: 31
    GB) never sits beside its cast; where one slice of the leading dim is
    still larger (a layer of Arctic's experts: 4.5G elements), of its
    leading dims merged until a slice fits.  On the meta device nothing is
    drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    lead = 0  # leading dims merged into the sliced one
    while lead < len(shape) - 1 and int(np.prod(shape[lead:])) > _DRAW:
        lead += 1
    flat = out.view((-1,) + tuple(shape[lead:])) if lead else out[None]
    rows = max(1, _DRAW // max(int(np.prod(flat.shape[1:])), 1))
    scale = 1.0 / np.sqrt(max(in_axis_size, 1))
    for i in range(0, flat.shape[0], rows):
        w = torch.empty(flat[i:i + rows].shape, dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        flat[i:i + rows] = w.mul_(scale)
    return out


def seq_full(x: torch.Tensor) -> torch.Tensor:
    """A normed residual ``(B, S, d)`` with the whole sequence on every
    rank, the layout of a matmul's input under sharding rules (identity
    outside them).  The matmul flattens (B, S) into rows, and DTensor
    cannot lay out those rows when both dims are sharded; the reference's
    partitioner gathers the sequence at the same point."""
    return constrain(x, "batch", "seq_full", None)


def matmul(x: torch.Tensor, w: torch.Tensor,
           ndim_contract: int = 1) -> torch.Tensor:
    """x @ w over the last ``ndim_contract`` dims of x and the first of w,
    in the operands' dtype with float32 accumulation, rounded to x's
    dtype."""
    if ndim_contract == 1 and w.ndim == 2:
        return torch.matmul(x, w).to(x.dtype)
    lead, inner = x.shape[:x.ndim - ndim_contract], w.shape[:ndim_contract]
    out = w.shape[ndim_contract:]
    x2 = _splittable(x.reshape(*lead, -1), -1, inner[0])
    w2 = _splittable(w.reshape(int(np.prod(inner)), -1), 0, inner[0])
    y = _splittable(torch.matmul(x2, _splittable(w2, -1, out[0])), -1,
                    out[0])
    return y.reshape(*lead, *out).to(x.dtype)


def _split_layout(t, dim: int, first: int):
    """A DTensor laid out so that its dim ``dim`` splits into (first, ...):
    the ranks sharding that dim must divide ``first``; the others gather
    it."""
    from torch.distributed.tensor import Replicate

    dim %= t.ndim
    mesh, place, n = t.device_mesh, list(t.placements), 1
    for i, p in enumerate(place):
        if p.is_shard(dim):
            if first % (n * mesh.size(i)):
                place[i] = Replicate()
            else:
                n *= mesh.size(i)
    return t if place == list(t.placements) else t.redistribute(mesh, place)


class _Splittable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, first):
        ctx.dims = (dim, first)
        return _split_layout(t, dim, first)

    @staticmethod
    def backward(ctx, grad):
        return _split_layout(grad, *ctx.dims), None, None


def _splittable(t: torch.Tensor, dim: int, first: int) -> torch.Tensor:
    """``t``, whose dim ``dim`` is merged from or about to split into
    ``(first, ...)`` (a matmul's flattened operand or product); on a
    DTensor sharded there over more ranks than divide ``first`` (GQA's few
    kv heads on a wide ``model`` axis) that dim is gathered first, in the
    forward and in the backward pass.  Identity on plain tensors."""
    if not is_dtensor(t):
        return t
    return _Splittable.apply(t, dim, first)


# ---------------------------------------------------------------- norms
def init_norm(d: int, dtype, kind: str = "rms", device=None,
              layers: Optional[int] = None, leaves: bool = False) -> Dict:
    lead = () if layers is None else (layers,)
    p = {"scale": leaf(torch.ones(lead + (d,), dtype=dtype, device=device),
                       ("embed2",), layers, leaves)}
    if kind == "layer":
        p["bias"] = leaf(torch.zeros(lead + (d,), dtype=dtype, device=device),
                         ("embed2",), layers, leaves)
    return p


def apply_norm(p: Dict, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------ embeddings
def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   device, leaves: bool = False) -> Dict:
    if torch.device(device).type == "meta":
        table = torch.empty(vocab, d, dtype=dtype, device=device)
    else:
        emb = torch.empty(vocab, d, dtype=torch.float32, device=device)
        emb.normal_(generator=gen)
        table = (emb / np.sqrt(d)).to(dtype)
    return {"table": leaf(table, ("vocab", "embed"), None, leaves)}


def apply_embedding(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def apply_unembed(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (tied or dedicated) (vocab, d) table."""
    return matmul(x, p["table"].T)


# ----------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, mrope: bool = False) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S): rotary embedding in float32, the
    two halves of the head rotated together (the reference's layout).
    ``mrope`` is Qwen2-VL's flag; for the text backbone it is 1-D RoPE."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    ang = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, D/2)
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., : D // 2], xf[..., D // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention
def init_attention(gen: torch.Generator, cfg, dtype, device,
                   layers: Optional[int] = None, leaves: bool = False) -> Dict:
    """One attention layer's parameters, or ``layers`` stacked on a leading
    dim: wq (d, H, Dh), wk and wv (d, Hkv, Dh), wo (H, Dh, d), and zero
    q/k/v biases when ``cfg.qkv_bias``."""
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = () if layers is None else (layers,)

    def dense(shape, fan_in, axes):
        return leaf(_dense_init(gen, lead + shape, fan_in, dtype, device),
                    axes, layers, leaves)

    def zeros(shape, axes):
        return leaf(torch.zeros(lead + shape, dtype=dtype, device=device),
                    axes, layers, leaves)

    p = {
        "wq": dense((d, H, Dh), d, ("embed", "heads", "head_dim")),
        "wk": dense((d, Hkv, Dh), d, ("embed", "kv_heads", "head_dim")),
        "wv": dense((d, Hkv, Dh), d, ("embed", "kv_heads", "head_dim")),
        "wo": dense((H, Dh, d), H * Dh, ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H, Dh), ("heads", "head_dim"))
        p["bk"] = zeros((Hkv, Dh), ("kv_heads", "head_dim"))
        p["bv"] = zeros((Hkv, Dh), ("kv_heads", "head_dim"))
    return p


def _write_rows(buf: torch.Tensor, rows: torch.Tensor,
                new: torch.Tensor) -> None:
    """buf[b, rows[b]] = new[b] for the rows inside buf, in place; a row
    outside it is dropped (the reference's ``mode="drop"``).  No host
    sync: the dropped rows are rewritten with what they held."""
    B, L = buf.shape[:2]
    bidx = torch.arange(B, device=buf.device)
    inside = (rows >= 0) & (rows < L)
    at = rows.clamp(0, L - 1)
    keep = inside.reshape((B,) + (1,) * (new.ndim - 1))
    buf[bidx, at] = torch.where(keep, new.to(buf.dtype), buf[bidx, at])


def apply_attention(p: Dict, x: torch.Tensor, cfg, positions: torch.Tensor,
                    window: Optional[int] = None, cache=None,
                    kernel_impl: str = "auto") -> torch.Tensor:
    """GQA attention; returns the layer output and updates ``cache`` (a
    ``full`` or ``ring`` LayerCache) in place: K/V rows written and the
    cursor ``pos`` advanced on the device.  RoPE unless
    ``cfg.position_embedding`` is ``"nope"``; the softmax scale is
    ``cfg.attention_scale`` where set, else 1/sqrt(head_dim).

    The branches of the reference (``repro/models/layers.py``):
      - no cache: attention over the sequence (K5 on a static offset 0);
      - ``full``, per-slot (B,) ``pos``: one decode token a slot, written
        at its own row (rows past the cache dropped);
      - ``full``, scalar ``pos``: the S new rows written from ``pos``;
      - ``ring``, S > 1: a prefill from the start, attention over the
        sequence itself (K5 when there is no ``start``), then the last
        min(W, S) keys stashed at slot = position % W;
      - ``ring``, one token: written at slot pos % W, each slot's absolute
        position rebuilt from ``pos`` for the mask.
    ``start`` ((B,), optional) rebases each row's first real token to 0
    (left-padded prefills): pad keys land at negative positions.  Cursors
    are tensors, so every cached branch but the ring prefill goes to the
    attention oracle (``ops.attention``'s rule).
    """
    B, S, _ = x.shape
    q = matmul(x, p["wq"])  # (B, S, H, Dh)
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if getattr(cfg, "position_embedding", "rope") == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    q = constrain(q, "batch", "seq_full", "act_heads", None)
    k = constrain(k, "batch", "seq_full", "kv_heads_act", None)

    def kv_layout(t):
        return constrain(t, "batch", "kv_seq", "kv_heads_act", None)

    start = cache.start if cache is not None else None

    def offsets(pos, nrows):
        """(q_offset, kv_positions) for rows 0..nrows-1 at cursor pos."""
        rows = torch.arange(nrows, device=x.device)[None, :]
        if start is None:
            if pos.ndim == 0:
                return pos, None
            return pos, rows.expand(B, nrows)
        return pos - start, rows - start[:, None]

    def attend(kk, vv, causal, q_off, kv_pos):
        return ops.attention(q, kk, vv, causal=causal, window=window,
                             q_offset=q_off, kv_positions=kv_pos,
                             scale=getattr(cfg, "attention_scale", None),
                             impl=kernel_impl)

    if cache is None:
        out = attend(k, v, cfg.causal, 0, None)
    elif cache.kind == "full" and cache.pos.ndim == 1:
        if S != 1:
            raise ValueError(
                "per-slot cache cursors support single-token decode only; "
                "prefill slots unpadded at B=1 and admit via write_prompt")
        pos = cache.pos  # (B,): rows already cached per slot
        _write_rows(cache.k, pos, k[:, 0])
        _write_rows(cache.v, pos, v[:, 0])
        out = attend(kv_layout(cache.k), kv_layout(cache.v), True,
                     *offsets(pos, cache.k.shape[1]))
        cache.pos.add_(1)
    elif cache.kind == "full":
        L = cache.k.shape[1]
        pos = cache.pos  # 0-d: tokens already cached
        # dynamic_update_slice clamps its start so the S rows fit
        rows = pos.clamp(0, max(L - S, 0)) + torch.arange(S, device=x.device)
        write_(cache.k, "index_copy_", 1, rows, k.to(cache.k.dtype))
        write_(cache.v, "index_copy_", 1, rows, v.to(cache.v.dtype))
        # rows past pos + S - 1 are zero or stale; the causal mask at
        # q_offset = pos never reads them
        out = attend(kv_layout(cache.k), kv_layout(cache.v), True,
                     *offsets(pos, L))
        cache.pos.add_(S)
    elif cache.kind == "ring" and S > 1:
        W = cache.k.shape[1]
        if start is None:
            q_off, kv_pos = 0, None
        else:
            q_off = -start
            kv_pos = torch.arange(S, device=x.device)[None, :] \
                - start[:, None]
        out = attend(k, v, cfg.causal, q_off, kv_pos)
        take = min(W, S)
        slots = torch.arange(S - take, S, device=x.device) % W
        cache.k[:, slots] = k[:, S - take:].to(cache.k.dtype)
        cache.v[:, slots] = v[:, S - take:].to(cache.v.dtype)
        cache.pos.add_(S)
    elif cache.kind == "ring":
        W = cache.k.shape[1]
        pos = cache.pos
        slots = torch.arange(W, device=x.device)
        if pos.ndim == 1:
            bidx = torch.arange(B, device=x.device)
            cache.k[bidx, pos % W] = k[:, 0].to(cache.k.dtype)
            cache.v[bidx, pos % W] = v[:, 0].to(cache.v.dtype)
            rows = pos[:, None] - ((pos[:, None] - slots[None, :]) % W)
        else:
            at = (pos % W).reshape(1)
            write_(cache.k, "index_copy_", 1, at, k.to(cache.k.dtype))
            write_(cache.v, "index_copy_", 1, at, v.to(cache.v.dtype))
            # slot s holds the largest position p <= pos with p % W == s
            rows = pos - ((pos - slots) % W)  # in (pos - W, pos]
        q_off = pos if start is None else pos - start
        kv_pos = rows if start is None else (
            (rows if rows.ndim == 2 else rows[None, :]) - start[:, None])
        out = attend(kv_layout(cache.k), kv_layout(cache.v), True, q_off,
                     kv_pos)
        cache.pos.add_(1)
    else:
        raise ValueError(cache.kind)
    out = constrain(out, "batch", "seq_full", "act_heads", None)
    return constrain(matmul(out, p["wo"], 2), "batch", "seq", None)


# -------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, cfg, dtype, device,
             layers: Optional[int] = None,
             d_ff: Optional[int] = None, leaves: bool = False) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = () if layers is None else (layers,)

    def dense(shape, fan_in, axes):
        return leaf(_dense_init(gen, lead + shape, fan_in, dtype, device),
                    axes, layers, leaves)

    def zeros(shape, axes):
        return leaf(torch.zeros(lead + shape, dtype=dtype, device=device),
                    axes, layers, leaves)

    if cfg.mlp_gated:
        return {
            "wi_gate": dense((d, f), d, ("embed", "ffn")),
            "wi_up": dense((d, f), d, ("embed", "ffn")),
            "wo": dense((f, d), f, ("ffn", "embed")),
        }
    return {
        "wi": dense((d, f), d, ("embed", "ffn")),
        "bi": zeros((f,), ("ffn",)),
        "wo": dense((f, d), f, ("ffn", "embed")),
        "bo": zeros((d,), ("embed2",)),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":  # jax.nn.gelu defaults to the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def apply_mlp(p: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if "wi_gate" in p:
        h = _act(cfg.act, matmul(x, p["wi_gate"])) * matmul(x, p["wi_up"])
        h = constrain(h, "batch", "seq_full", "act_ffn")
        return constrain(matmul(h, p["wo"]), "batch", "seq", None)
    h = _act(cfg.act, matmul(x, p["wi"]) + p["bi"])
    h = constrain(h, "batch", "seq_full", "act_ffn")
    return constrain(matmul(h, p["wo"]), "batch", "seq", None) + p["bo"]
