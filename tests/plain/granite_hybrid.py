"""Granite 4.0-H Small's forward in plain float32 PyTorch: the yardstick of
the port's ``granite-4.0-h-small`` (``tests/test_torch_granite.py``).

The model (``granitemoehybrid``, config.json of
ibm-granite/granite-4.0-h-small): ``layer_types`` sets each layer's mixer,
Mamba-2 or attention; every layer is

    x <- x + r * mixer(rms(x))
    x <- x + r * (moe(rms(x)) + shared(rms(x)))

with r the ``residual_multiplier``; embeddings times
``embedding_multiplier``, logits through the tied table over
``logits_scaling``.  It imports nothing of the program and no JAX; it sets
TF32 off, so a float32 product on a card is a float32 product.

``c`` is a plain dict of the model's numbers under config.json's keys,
with ``num_local_experts`` the router's width and ``experts_held`` the
experts [lo, hi) of one chip's share.  ``params`` holds the weights under
the port's keys (``embed``, ``final_norm``, ``blocks``), in any dtype:
each is used in float32.  ``rnd``, where given, is applied to every
product's operands and to the SSM state after each step (a control that
computes in a lower precision).

Departures from the published description, each at its line: the experts
are one chip's share (the others' outputs are left out, as on the chip);
the router's softmax over all experts then top-k renormalised equals the
published top-k then softmax over the k.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Rnd = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(scale)


def mm(a: torch.Tensor, w: torch.Tensor, rnd=_same) -> torch.Tensor:
    """a @ w over a's last dim and w's first (w may have more dims)."""
    w2 = rnd(_f(w)).reshape(w.shape[0], -1)
    return (rnd(a) @ w2).reshape(*a.shape[:-1], *w.shape[1:])


def swiglu(h, wg, wu, wd, rnd=_same) -> torch.Tensor:
    return mm(F.silu(mm(h, wg, rnd)) * mm(h, wu, rnd), wd, rnd)


def moe(h: torch.Tensor, p: Mapping, c: Mapping, rnd=_same) -> torch.Tensor:
    """The routed experts held here: softmax over all ``num_local_experts``
    router outputs, top ``num_experts_per_tok``, gates renormalised over
    them; each token gets the gated outputs of the held experts it was
    routed to.  The absent experts' outputs are left out (one chip's
    share, as the program computes it)."""
    x = h.reshape(-1, h.shape[-1])
    probs = torch.softmax(mm(x, p["router"], rnd), dim=-1)
    top, idx = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    lo, hi = c["experts_held"]
    y = torch.zeros_like(x)
    for e in range(lo, hi):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            k = e - lo
            out = swiglu(x[tok], p["w_gate"][k], p["w_up"][k],
                         p["w_down"][k], rnd)
            y.index_add_(0, tok, gates[tok, slot, None] * out)
    return y.reshape(h.shape)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time with a bias: x (B, T, C), w (K, C)."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, k:k + T] * _f(w[k]) for k in range(K)) + _f(b)


def mamba(x: torch.Tensor, p: Mapping, c: Mapping, rnd=_same) -> torch.Tensor:
    """Mamba-2 mixer on the normed x: in-projections z, x, B|C, dt; the
    conv with its bias and SiLU; the SSD as its sequential recurrence from
    a zero state, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t + D x_t; the gated RMSNorm of y * silu(z); the
    out-projection."""
    Bsz, T, _ = x.shape
    H, P = c["mamba_n_heads"], c["mamba_d_head"]
    G, N = c["mamba_n_groups"], c["mamba_d_state"]
    z = mm(x, p["wz"], rnd)
    xs = F.silu(_conv(mm(x, p["wx"], rnd), p["conv_x"], p["conv_x_bias"]))
    bc = F.silu(_conv(mm(x, p["wbc"], rnd), p["conv_bc"],
                      p["conv_bc_bias"]))
    dt = F.softplus(mm(x, p["wdt"], rnd) + _f(p["dt_bias"]))  # (B, T, H)
    A = -torch.exp(_f(p["A_log"]))
    xh = xs.reshape(Bsz, T, H, P)
    Bm = bc[..., :G * N].reshape(Bsz, T, G, N).repeat_interleave(H // G, 2)
    Cm = bc[..., G * N:].reshape(Bsz, T, G, N).repeat_interleave(H // G, 2)
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        dtx = rnd(dt[:, t, :, None] * xh[:, t])                # (B, H, P)
        h = rnd(torch.exp(dt[:, t] * A)[..., None, None] * h
                + dtx[..., None] * rnd(Bm[:, t])[:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, rnd(Cm[:, t])))
    y = torch.stack(ys, 1) + xh * _f(p["D"])[:, None]
    g = y.reshape(Bsz, T, H * P) * F.silu(z)
    return mm(rms(g, p["gnorm"], c["rms_norm_eps"]), p["wo"], rnd)


def attention(x: torch.Tensor, p: Mapping, c: Mapping,
              rnd=_same) -> torch.Tensor:
    """Causal GQA attention on the normed x with no positional embedding
    (NoPE), scaled by ``attention_multiplier``."""
    Bsz, T, _ = x.shape
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    q = mm(x, p["wq"], rnd)                                  # (B, T, Hq, D)
    k = mm(x, p["wk"], rnd).repeat_interleave(Hq // Hkv, 2)
    v = mm(x, p["wv"], rnd).repeat_interleave(Hq // Hkv, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", rnd(q), rnd(k))
    s = s * c["attention_multiplier"]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", rnd(a), rnd(v))
    return mm(o.reshape(Bsz, T, -1), p["wo"].reshape(-1, p["wo"].shape[-1]),
              rnd)


def block(x: torch.Tensor, p: Mapping, kind: str, c: Mapping,
          rnd=_same) -> torch.Tensor:
    r, eps = c["residual_multiplier"], c["rms_norm_eps"]
    if kind == "mamba":
        x = x + r * mamba(rms(x, p["ssd"]["norm"]["scale"], eps), p["ssd"],
                          c, rnd)
    else:
        x = x + r * attention(rms(x, p["norm1"]["scale"], eps), p["attn"],
                              c, rnd)
    h = rms(x, p["norm2"]["scale"], eps)
    m = p["mlp"]
    return x + r * (moe(h, p["moe"], c, rnd)
                    + swiglu(h, m["wi_gate"], m["wi_up"], m["wo"], rnd))


def forward(params: Mapping, c: Mapping, tokens: torch.Tensor,
            at: Optional[torch.Tensor] = None, rnd: Rnd = None
            ) -> torch.Tensor:
    """(B, T) tokens -> float32 logits (B, T, vocab), or with ``at`` ((B, m)
    positions) the logits at those positions alone, (B, m, vocab)."""
    rnd = rnd or _same
    table = params["embed"]["table"]
    x = _f(table[tokens]) * c["embedding_multiplier"]
    for p, kind in zip(params["blocks"], c["layer_types"]):
        x = block(x, p, kind, c, rnd)
    if at is not None:
        x = torch.gather(x, 1, at[..., None].expand(*at.shape, x.shape[-1]))
    h = rms(x, params["final_norm"]["scale"], c["rms_norm_eps"])
    return mm(h, table.T, rnd) / c["logits_scaling"]
