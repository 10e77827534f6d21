"""Common model layers of the port: init and apply over plain dicts of tensors.

The port of ``repro.models.layers``: norms, the embedding and the tied or
dedicated unembedding, the matmul convention and the init helpers, RoPE,
GQA attention over every cache kind, and the MLP.  Parameters are nested
dicts of tensors with the reference's keys and layouts (no logical-axis
names: the port does not shard yet).

All matmuls run in the parameter dtype with float32 accumulation (no TF32,
no reduced-precision bf16 reductions: ``repro_torch`` turns both off);
norms, RoPE and softmax in float32.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype a config's ``dtype`` names."""
    try:
        return DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; known: "
                         f"{sorted(DTYPES)}") from None


_DRAW = 1 << 28  # float32 elements ``_dense_init`` draws at once


def _dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
                device) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan-in), drawn in
    float32 and cast, as the reference's ``_dense_init``.  A tensor of more
    than ``_DRAW`` elements is drawn in slices of its leading dim, so that
    the float32 draw of a stacked weight (32 layers of Qwen2-72B's MLP: 31
    GB) never sits beside its cast."""
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, _DRAW * shape[0] // max(out.numel(), 1))
    scale = 1.0 / np.sqrt(max(in_axis_size, 1))
    for i in range(0, shape[0], rows):
        w = torch.empty(out[i:i + rows].shape, dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[i:i + rows] = w.mul_(scale)
    return out


def matmul(x: torch.Tensor, w: torch.Tensor,
           ndim_contract: int = 1) -> torch.Tensor:
    """x @ w over the last ``ndim_contract`` dims of x and the first of w,
    in the operands' dtype with float32 accumulation, rounded to x's
    dtype."""
    if ndim_contract == 1 and w.ndim == 2:
        return torch.matmul(x, w).to(x.dtype)
    lead, inner = x.shape[:x.ndim - ndim_contract], w.shape[:ndim_contract]
    out = w.shape[ndim_contract:]
    y = torch.matmul(x.reshape(*lead, -1), w.reshape(int(np.prod(inner)), -1))
    return y.reshape(*lead, *out).to(x.dtype)


# ---------------------------------------------------------------- norms
def init_norm(d: int, dtype, kind: str = "rms", device=None,
              layers: Optional[int] = None) -> Dict:
    lead = () if layers is None else (layers,)
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
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
                   device) -> Dict:
    emb = torch.empty(vocab, d, dtype=torch.float32, device=device)
    emb.normal_(generator=gen)
    return {"table": (emb / np.sqrt(d)).to(dtype)}


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
                   layers: Optional[int] = None) -> Dict:
    """One attention layer's parameters, or ``layers`` stacked on a leading
    dim: wq (d, H, Dh), wk and wv (d, Hkv, Dh), wo (H, Dh, d), and zero
    q/k/v biases when ``cfg.qkv_bias``."""
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = () if layers is None else (layers,)
    p = {
        "wq": _dense_init(gen, lead + (d, H, Dh), d, dtype, device),
        "wk": _dense_init(gen, lead + (d, Hkv, Dh), d, dtype, device),
        "wv": _dense_init(gen, lead + (d, Hkv, Dh), d, dtype, device),
        "wo": _dense_init(gen, lead + (H, Dh, d), H * Dh, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H, Dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros(lead + (Hkv, Dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros(lead + (Hkv, Dh), dtype=dtype, device=device)
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
    cursor ``pos`` advanced on the device.

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
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)

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
        out = attend(cache.k, cache.v, True, *offsets(pos, cache.k.shape[1]))
        cache.pos.add_(1)
    elif cache.kind == "full":
        L = cache.k.shape[1]
        pos = cache.pos  # 0-d: tokens already cached
        # dynamic_update_slice clamps its start so the S rows fit
        rows = pos.clamp(0, max(L - S, 0)) + torch.arange(S, device=x.device)
        cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
        cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
        # rows past pos + S - 1 are zero or stale; the causal mask at
        # q_offset = pos never reads them
        out = attend(cache.k, cache.v, True, *offsets(pos, L))
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
            cache.k.index_copy_(1, at, k.to(cache.k.dtype))
            cache.v.index_copy_(1, at, v.to(cache.v.dtype))
            # slot s holds the largest position p <= pos with p % W == s
            rows = pos - ((pos - slots) % W)  # in (pos - W, pos]
        q_off = pos if start is None else pos - start
        kv_pos = rows if start is None else (
            (rows if rows.ndim == 2 else rows[None, :]) - start[:, None])
        out = attend(cache.k, cache.v, True, q_off, kv_pos)
        cache.pos.add_(1)
    else:
        raise ValueError(cache.kind)
    return matmul(out, p["wo"], 2)


# -------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, cfg, dtype, device,
             layers: Optional[int] = None,
             d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = () if layers is None else (layers,)
    if cfg.mlp_gated:
        return {
            "wi_gate": _dense_init(gen, lead + (d, f), d, dtype, device),
            "wi_up": _dense_init(gen, lead + (d, f), d, dtype, device),
            "wo": _dense_init(gen, lead + (f, d), f, dtype, device),
        }
    return {
        "wi": _dense_init(gen, lead + (d, f), d, dtype, device),
        "bi": torch.zeros(lead + (f,), dtype=dtype, device=device),
        "wo": _dense_init(gen, lead + (f, d), f, dtype, device),
        "bo": torch.zeros(lead + (d,), dtype=dtype, device=device),
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
        return matmul(h, p["wo"])
    h = _act(cfg.act, matmul(x, p["wi"]) + p["bi"])
    return matmul(h, p["wo"]) + p["bo"]
