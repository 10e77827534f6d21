"""Dispatch of the LM kernels (the port of ``repro.kernels.ops``).

``impl`` selects the path, as the reference's does:
  - "auto": the kernel's wrapper (``flash_attention.flash_attention``,
    ``ssd.ssd_chunked``), which runs the kernel (K5, K6) on a CUDA tensor
    and its plain version on a CPU tensor;
  - "plain": the plain version, asked for by name;
  - "ref": the oracles of ``ref``.
On DTensors (under ``dist.sharding``'s rules) each rank runs the chosen
path on its local shards (``kernels.sharded``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as _fa
from . import ref as _ref
from . import sharded as _sharded
from . import ssd as _ssd
from . import ssd_decode as _ssd_decode

IMPLS = ("auto", "plain", "ref")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")


# ------------------------------------------------------------- attention
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_offset=0, kv_positions: Optional[torch.Tensor] = None,
              scale: Optional[float] = None, impl: str = "auto",
              block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    The reference's rule (``repro/kernels/ops.py``): a ``kv_positions``
    (ring caches) or a ``q_offset`` that is a tensor rather than a Python
    int (cache cursors) goes to the oracle; so does ``impl="ref"``, which
    takes the chunked oracle for long prefills (Sq >= 2048 and Skv >=
    8192).  Everything else is the static-offset prefill and no-cache
    path, on K5 (or its plain version).
    """
    _check_impl(impl)
    if _sharded.is_dtensor(q, k, v):
        return _sharded.attention(
            lambda *a: attention(*a[:3], causal=causal, window=window,
                                 q_offset=a[3], kv_positions=a[4],
                                 scale=scale, impl=impl, block_q=block_q,
                                 block_k=block_k),
            q, k, v, q_offset, kv_positions)
    if kv_positions is not None or not isinstance(q_offset, int):
        impl = "ref"
    if impl == "ref":
        fn = _ref.attention_ref
        if q.shape[1] >= 2048 and k.shape[1] >= 8192:
            fn = _ref.attention_ref_chunked
        return fn(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  kv_positions=kv_positions, scale=scale)
    fn = _fa.flash_attention_plain if impl == "plain" else _fa.flash_attention
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
              window=window, q_offset=q_offset, scale=scale, block_q=block_q,
              block_k=block_k)


# ------------------------------------------------------------------ SSD
def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: Optional[torch.Tensor] = None, chunk: int = 128,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD from a zero state -> (y, final state).

    Sequences are zero-padded up to a multiple of ``min(chunk, S)``; padded
    steps carry dt = 0 (decay exp(0) = 1, no input), so the final state is
    exact.
    """
    _check_impl(impl)
    if _sharded.is_dtensor(x, dt, A, Bm, Cm, D):
        return _sharded.ssd(
            lambda *a: ssd(*a, chunk=chunk, impl=impl), x, dt, A, Bm, Cm, D)
    S = x.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    if impl == "ref":
        y, h = _ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                    return_state=True)
    else:
        fn = _ssd.ssd_chunked_plain if impl == "plain" else _ssd.ssd_chunked
        y, h = fn(x.contiguous(), dt.contiguous(), A.contiguous(),
                  Bm.contiguous(), Cm.contiguous(), D, chunk=chunk)
    if pad:
        y = y[:, :S]
    return y, h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor,
                    D: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token state update (the serving path), O(state): one step of
    ``ssd_ref`` from the carried state h (B, H, P, N), which is updated in
    place and returned with y (``ssd_decode.ssd_decode``: K7 on a CUDA
    tensor, its plain version on a CPU one)."""
    if _sharded.is_dtensor(x, dt, A, Bm, Cm, h, D):
        return _sharded.ssd(
            lambda x_, dt_, A_, B_, C_, D_, h_: ssd_decode_step(
                x_, dt_, A_, B_, C_, h_, D_), x, dt, A, Bm, Cm, D, h)
    return _ssd_decode.ssd_decode(x, dt, A, Bm, Cm, h, D)
