"""Common model layers of the port: init and apply over plain dicts of tensors.

The port of the part of ``repro.models.layers`` that the Mamba-2 stack
needs: norms, the embedding and the tied or dedicated unembedding, the
matmul convention and the init helpers.  Parameters are nested dicts of
tensors with the reference's keys and layouts (no logical-axis names: the
port does not shard yet).

All matmuls run in the parameter dtype with float32 accumulation (no TF32,
no reduced-precision bf16 reductions: ``repro_torch`` turns both off);
norms in float32.  Attention, RoPE and the MLP come with their slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype a config's ``dtype`` names."""
    try:
        return DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; known: "
                         f"{sorted(DTYPES)}") from None


def _dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
                device) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan-in), drawn in
    float32 and cast, as the reference's ``_dense_init``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / np.sqrt(max(in_axis_size, 1)))).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w over the last dim of x and the first of w, in the operands'
    dtype with float32 accumulation, rounded to x's dtype."""
    return torch.matmul(x, w).to(x.dtype)


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
