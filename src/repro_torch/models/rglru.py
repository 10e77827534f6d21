"""Griffin / RecurrentGemma recurrent block, the port of ``repro.models.rglru``.

Recurrent block:  y = W_out( GeLU(W_gate x) * RG-LRU(conv1d(W_x x)) )
RG-LRU:           r_t = sigmoid(W_a u_t + b_a)      (recurrence gate)
                  i_t = sigmoid(W_i u_t + b_i)      (input gate)
                  a_t = exp(-c softplus(lam) r_t),  c = 8
                  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

The reference runs the linear recurrence as ``lax.associative_scan``, which
is XLA and not a Pallas kernel; here it is a log-depth (Hillis-Steele)
scan of (a, b) pairs over the sequence in float32, ceil(log2 S) rounds of
elementwise products.  Decode is the single-step update.  The causal conv
and its decode step are the Mamba-2 block's float32 shifted products (no
cuDNN).  A block returns its output and the cache tensors it computed; the
model writes those into its cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .cache import LayerCache
from ..dist.sharding import constrain
from .layers import (_dense_init, apply_norm, init_norm, leaf, matmul,
                     seq_full)
from .ssm import _causal_conv, _conv_step

_C = 8.0


def init_rglru_block(gen: torch.Generator, cfg, dtype, device,
                     layers: Optional[int] = None,
                     leaves: bool = False) -> Dict:
    """One block's parameters, or ``layers`` blocks stacked on a leading
    dim; the reference's distributions, drawn from ``gen``.  The gate
    biases and lam are float32, as in the reference."""
    d = cfg.d_model
    w = cfg.lru_width or d
    lead = () if layers is None else (layers,)

    def dense(shape, fan_in, axes):
        return leaf(_dense_init(gen, lead + shape, fan_in, dtype, device),
                    axes, layers, leaves)

    def named(value, axes):
        return leaf(value, axes, layers, leaves)

    # lam so that a^c is in [0.9, 0.999] (paper section 2.4)
    u = torch.empty(lead + (w,), dtype=torch.float32, device=device)
    u.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * _C)))  # softplus^-1
    zeros = torch.zeros(lead + (w,), dtype=torch.float32, device=device)
    return {
        "norm": init_norm(d, dtype, cfg.norm, device, layers, leaves=leaves),
        "w_gate": dense((d, w), d, ("embed", "lru")),
        "w_x": dense((d, w), d, ("embed", "lru")),
        "conv": dense((cfg.conv1d_width, w), cfg.conv1d_width,
                      ("conv_k", "lru")),
        "w_a": dense((w, w), w, ("lru", "lru")),
        "b_a": named(zeros, ("lru",)),
        "w_i": dense((w, w), w, ("lru", "lru")),
        "b_i": named(zeros.clone(), ("lru",)),
        "lam": named(lam, ("lru",)),
        "w_out": dense((w, d), w, ("lru", "embed")),
    }


def _rglru_coeffs(p: Dict, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (..., w) conv output -> (a, b) of h = a h_prev + b, in float32."""
    uf = u.float()
    r = torch.sigmoid(matmul(uf, p["w_a"].float()) + p["b_a"])
    i = torch.sigmoid(matmul(uf, p["w_i"].float()) + p["b_i"])
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, log depth:
    after the round of offset k, (a_t, b_t) composes steps t-2k+1..t, with
    (a1, b1) then (a2, b2) composing to (a1 a2, a2 b1 + b2)."""
    S = a.shape[1]
    off = 1
    while off < S:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return b


def apply_rglru_block(p: Dict, x: torch.Tensor, cfg,
                      cache: Optional[LayerCache] = None
                      ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (block output, new cache tensors or None).

    With a cache, one token is a decode step from the cached conv window
    and state; more tokens are a prefill from a zero state, whose conv tail
    is ``u[:, S-(K-1):]`` as the reference slices it: the last K-1 rows,
    or for a prompt shorter than the window the last K-1-S of them (one
    row for two tokens at K = 4; ``model.forward`` writes it as the
    reference's layout does).
    """
    S = x.shape[1]
    xn = seq_full(apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps))
    gate = F.gelu(matmul(xn, p["w_gate"]).float(), approximate="tanh")
    u = matmul(xn, p["w_x"])
    u = constrain(u, "batch", "seq_full", "lru")

    new = None
    if cache is not None and S == 1:
        u1, conv = _conv_step(u[:, 0], cache.conv, p["conv"])
        a, b = _rglru_coeffs(p, u1)
        h = a * cache.h + b
        new = {"conv": conv, "h": h}
        h = h[:, None]
    else:
        u_tail = u[:, S - (p["conv"].shape[0] - 1):]
        a, b = _rglru_coeffs(p, _causal_conv(u, p["conv"]))
        h = linear_scan(a, b)
        if cache is not None:  # prefill: the final state for decode
            new = {"conv": u_tail, "h": h[:, -1]}

    y = (gate * h).to(x.dtype)
    return matmul(y, p["w_out"]), new
