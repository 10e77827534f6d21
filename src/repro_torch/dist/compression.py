"""int8 gradient compression with error feedback, on one device (the
single-device half of ``repro.dist.compression``).

``ef_compress`` quantizes ``grad + residual`` to int8 with a per-tensor
scale and carries the quantization error into the next step's residual:
the compressed value plus the new residual is the input, so the scheme is
unbiased over time (1-bit Adam / EF-SGD lineage).  ``adamw.update`` calls
it with ``compression="int8_ef"``.  The compressed all-reduce
(``compressed_psum``) comes with the data-parallel train step.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .. import tree as T

QMAX = 127.0  # symmetric int8 range


def _safe(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def ef_compress(grad: torch.Tensor, residual: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dequantized int8 value, new residual); value + residual is the
    input, in float32."""
    v = grad.float() + residual
    scale = _safe(v.abs().max() / QMAX)
    q = torch.clamp(torch.round(v / scale), -QMAX, QMAX).to(torch.int8)
    deq = q.float() * scale
    return deq, v - deq


def ef_compress_tree(grads: Any, residuals: Any) -> Tuple[Any, Any]:
    """``ef_compress`` leaf by leaf -> (compressed tree, residual tree)."""
    outs = [ef_compress(g, r)
            for g, r in zip(T.leaves(grads), T.leaves(residuals))]
    return (T.unflatten(grads, [c for c, _ in outs]),
            T.unflatten(grads, [r for _, r in outs]))
