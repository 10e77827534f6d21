"""Mamba-2 block (SSD mixer), the port of ``repro.models.ssm``.

  norm -> in-projections (z, x, B|C, dt)
       -> causal depthwise conv on x and B|C (K = ``ssm_conv``), plus a
          bias a channel where ``cfg.ssm_conv_bias`` (Granite 4.0-H)
       -> SiLU, softplus dt, A = -exp(A_log)
       -> SSD: K6 (``ops.ssd``) over a prompt, one scan step
          (``ops.ssd_decode_step``) for a decode token
       -> gated RMSNorm(y * silu(z)) -> out-projection

The depthwise conv is a sum of shifted products in float32 (no cuDNN
convolution, whose float32 path would default to TF32 on the card).  A
block returns its output and the cache tensors it computed; the model
writes those into its cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .cache import LayerCache
from ..dist.sharding import constrain
from .layers import (_dense_init, apply_norm, init_norm, leaf, matmul,
                     seq_full)


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_headdim
    return d_in, nheads, cfg.ssm_ngroups, cfg.ssm_state


def init_ssd_block(gen: torch.Generator, cfg, dtype, device,
                   layers: Optional[int] = None, leaves: bool = False) -> Dict:
    """One block's parameters, or ``layers`` blocks stacked on a leading
    dim; the reference's distributions, drawn from ``gen``."""
    d = cfg.d_model
    d_in, H, G, N = _dims(cfg)
    lead = () if layers is None else (layers,)

    def dense(shape, fan_in, axes):
        return leaf(_dense_init(gen, lead + shape, fan_in, dtype, device),
                    axes, layers, leaves)

    def named(value, axes):
        return leaf(value, axes, layers, leaves)

    def uniform(lo, hi):
        u = torch.empty(lead + (H,), dtype=torch.float32, device=device)
        return u.uniform_(lo, hi, generator=gen)

    # dt bias: softplus^-1 of dt in [1e-3, 1e-1], log-uniform (mamba2)
    u = uniform(0.0, 1.0)
    dt0 = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    p = {
        "norm": init_norm(d, dtype, cfg.norm, device, layers, leaves=leaves),
        "wz": dense((d, d_in), d, ("embed", "ssm_inner")),
        "wx": dense((d, d_in), d, ("embed", "ssm_inner")),
        "wbc": dense((d, 2 * G * N), d, ("embed", None)),
        "wdt": dense((d, H), d, ("embed", "ssm_heads")),
        "conv_x": dense((cfg.ssm_conv, d_in), cfg.ssm_conv,
                        ("conv_k", "ssm_inner")),
        "conv_bc": dense((cfg.ssm_conv, 2 * G * N), cfg.ssm_conv,
                         ("conv_k", None)),
        "dt_bias": named(dt_bias, ("ssm_heads",)),
        "A_log": named(torch.log(uniform(1.0, 16.0)), ("ssm_heads",)),
        "D": named(torch.ones(lead + (H,), dtype=torch.float32,
                              device=device), ("ssm_heads",)),
        "gnorm": named(torch.ones(lead + (d_in,), dtype=dtype, device=device),
                       ("ssm_inner",)),
        "wo": dense((d_in, d), d_in, ("ssm_inner", "embed")),
    }
    if getattr(cfg, "ssm_conv_bias", False):
        # nn.Conv1d's default: uniform in +-1/sqrt(fan_in), fan_in = K
        bound = cfg.ssm_conv ** -0.5
        for name, width, axes in (("conv_x_bias", d_in, ("ssm_inner",)),
                                  ("conv_bc_bias", 2 * G * N, (None,))):
            b = torch.empty(lead + (width,), dtype=torch.float32,
                            device=device)
            if not b.is_meta:
                b.uniform_(-bound, bound, generator=gen)
            p[name] = named(b.to(dtype), axes)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, C), w (K, C), optional bias b (C,): depthwise causal conv in
    float32, the bias added last."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    wf = w.float()
    out = xp[:, 0:S] * wf[0]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * wf[k]
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def _conv_step(x_t: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv: x_t (B, C); state (B, K-1, C) past inputs."""
    wins = torch.cat([state, x_t[:, None, :]], dim=1)  # (B, K, C)
    wf, wsf = w.float(), wins.float()
    out = wsf[:, 0] * wf[0]
    for k in range(1, w.shape[0]):
        out = out + wsf[:, k] * wf[k]
    if b is not None:
        out = out + b.float()
    return out.to(x_t.dtype), wins[:, 1:, :]


def apply_ssd_block(p: Dict, x: torch.Tensor, cfg,
                    cache: Optional[LayerCache] = None,
                    kernel_impl: str = "auto"
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (block output, new cache tensors or None).

    With a cache, one token is a decode step (the conv window and the SSD
    state carried from the cache); more tokens are a prefill from a zero
    state, whose conv tails are the last K-1 rows of the inputs, or all of
    them when the prompt is shorter (``model.forward`` writes them into the
    leading rows of the cache, as the reference's scan does).
    """
    B, S, _ = x.shape
    d_in, H, G, N = _dims(cfg)
    Pd = cfg.ssm_headdim
    h = seq_full(apply_norm(p["norm"], x, cfg.norm, cfg.norm_eps))
    z = matmul(h, p["wz"])
    xs = matmul(h, p["wx"])
    bc = matmul(h, p["wbc"])
    dt_raw = matmul(h, p["wdt"])
    z = constrain(z, "batch", "seq_full", "ssm_inner")
    xs = constrain(xs, "batch", "seq_full", "ssm_inner")

    new = None
    decode = cache is not None and S == 1
    bx, bbc = p.get("conv_x_bias"), p.get("conv_bc_bias")
    if decode:
        xs1, conv_x = _conv_step(xs[:, 0], cache.conv_x, p["conv_x"], bx)
        bc1, conv_bc = _conv_step(bc[:, 0], cache.conv_bc, p["conv_bc"], bbc)
        xs, bc = xs1[:, None], bc1[:, None]
    else:
        if cache is not None:  # prefill: keep the conv tails for decode
            K = p["conv_x"].shape[0]
            conv_x = xs[:, S - (K - 1):, :]
            conv_bc = bc[:, S - (K - 1):, :]
        xs = _causal_conv(xs, p["conv_x"], bx)
        bc = _causal_conv(bc, p["conv_bc"], bbc)

    xs = F.silu(xs)
    bc = F.silu(bc)
    Bm = bc[..., : G * N].reshape(B, S, G, N)
    Cm = bc[..., G * N:].reshape(B, S, G, N)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, H, Pd)
    xh = constrain(xh, "batch", "seq_full", "ssm_heads", None)

    if decode:
        y, state = ops.ssd_decode_step(xh, dtv, A, Bm, Cm, cache.state,
                                       p["D"])
    else:
        y, state = ops.ssd(xh, dtv, A, Bm, Cm, p["D"], chunk=cfg.ssm_chunk,
                           impl=kernel_impl)
    if cache is not None:
        new = {"conv_x": conv_x, "conv_bc": conv_bc, "state": state}

    y = y.reshape(B, S, d_in)
    # gated RMSNorm (mamba2's RMSNormGated)
    g = y.float() * F.silu(z.float())
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + cfg.norm_eps) * p["gnorm"].float()
    out = matmul(g.to(x.dtype), p["wo"])
    return out, new
