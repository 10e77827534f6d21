"""int8 gradient compression: error feedback and the compressed
all-reduce (the port of ``repro.dist.compression``).

``ef_compress`` quantizes ``grad + residual`` to int8 with a per-tensor
scale and carries the quantization error into the next step's residual:
the compressed value plus the new residual is the input, so the scheme is
unbiased over time (1-bit Adam / EF-SGD lineage).  ``adamw.update`` calls
it with ``compression="int8_ef"``.

``compressed_psum`` is the collective form, run inside a rank on its
``RankComm`` (``dist.ranks``): one scalar all-reduce of ``max|v|`` gives
the ranks a shared scale, each rank quantizes to the int8 range, the
integers are summed and rescaled once.  The error is at most ``0.5 *
scale`` a rank.  As in the reference, the integers travel as int32, so
the sum moves as many bytes as a float32 one (the reference's docstring
says int8 and a quarter of the bandwidth; its code casts to int32 before
the ``psum``); the int32 sum is exact, so every rank gets the same result
in any order.
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


def compressed_psum(v: torch.Tensor, comm, tag: int = 0) -> torch.Tensor:
    """The quantized all-reduce of ``v`` over ``comm``'s ranks, in
    ``v``'s dtype: a ``"max"`` all-reduce of ``max|v|`` for the shared
    scale, then round half to even (``jnp.round``'s rule), clamp to
    [-127, 127], an int32 ``"sum"`` all-reduce, one rescale.  ``tag``
    keys the host buffers the ops stage through."""
    v32 = v.float()
    amax = comm.all_reduce(v32.abs().max().reshape(1), tag, op="max").wait()
    scale = _safe(amax[0] / QMAX)
    q = torch.clamp(torch.round(v32 / scale), -QMAX, QMAX).to(torch.int32)
    total = comm.all_reduce(q, tag).wait()
    return (total.float() * scale).to(v.dtype)
