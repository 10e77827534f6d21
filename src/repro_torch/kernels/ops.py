"""Dispatch of the LM kernels (the port of ``repro.kernels.ops``).

``impl`` selects the SSD path, as the reference's does:
  - "auto": the K6 wrapper (``ssd.ssd_chunked``), which runs K6 on a CUDA
    tensor and its plain version on a CPU tensor;
  - "plain": ``ssd.ssd_chunked_plain``, asked for by name;
  - "ref": the chunked oracle ``ref.ssd_chunked_ref``.

``attention`` comes with the flash-attention kernel (K5).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import ref as _ref
from . import ssd as _ssd

IMPLS = ("auto", "plain", "ref")


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, D: Optional[torch.Tensor] = None, chunk: int = 128,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD from a zero state -> (y, final state).

    Sequences are zero-padded up to a multiple of ``min(chunk, S)``; padded
    steps carry dt = 0 (decay exp(0) = 1, no input), so the final state is
    exact.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")
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
    ``ssd_ref`` from the carried state h (B, H, P, N)."""
    return _ref.ssd_ref(x, dt, A, Bm, Cm, D, h0=h, return_state=True)
