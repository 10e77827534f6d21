"""K7, one Mamba-2 SSD decode step: wrapper and plain version.

The serving path's single-token update (``ops.ssd_decode_step``) from the
carried float32 state h (B, H, P, N): da = exp(dt A), h' = da h + (x dt)
outer B, y = h' . C + D x.  K7 (``csrc/ssd_decode.cu``) does it in one
pass that reads the state once and writes it once, in place; its header
says what bounds it on the H100 and how its design answers that.  It
replaces no TPU kernel: the reference's decode step is plain jnp.

Shapes as in the reference: x (B, 1, H, P), dt (B, 1, H), A (H,), B and C
(B, 1, G, N), D (H,) or None, h (B, H, P, N).  Both versions update ``h``
in place and return (y, h), y (B, 1, H, P) in x's type.  The new state is
``ssd_ref``'s bit for bit; y is the same sum taken in another order
(a warp's shuffles on the card against the gemv of ``ssd_ref``).

CPU tensors run the plain version (and meta tensors, which compute
nothing); CUDA tensors launch K7 or raise.  K7 has no backward: an input
that needs a gradient raises on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._cost import Cost, costed, nbytes
from .ref import ssd_ref

_TYPES = (torch.float32, torch.bfloat16)


def ssd_decode_cost(x, dt, A, Bm, Cm, h, D=None) -> Cost:
    """K7's declared cost: y = h' . C as a product (2 FLOPs a state
    element), the update's multiply, multiply and add as operations; the
    state read and written once, the other inputs read and y written
    once."""
    Bsz, _, H, P = x.shape
    elems = Bsz * H * P * h.shape[3]
    ins = sum(nbytes(t) for t in (x, dt, A, Bm, Cm, D))
    return Cost(2.0 * elems, ins + nbytes(x) + 2 * nbytes(h), 3.0 * elems)


def _check(x, dt, A, Bm, Cm, h, D) -> None:
    """Validate shapes, types and devices."""
    if x.ndim != 4 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, H, P), got {tuple(x.shape)}")
    Bsz, _, H, P = x.shape
    if Bm.ndim != 4 or Bm.shape[:2] != (Bsz, 1) or Cm.shape != Bm.shape:
        raise ValueError(f"B and C must be (B, 1, G, N) with B of x "
                         f"{tuple(x.shape)}, got {tuple(Bm.shape)} and "
                         f"{tuple(Cm.shape)}")
    G, N = Bm.shape[2], Bm.shape[3]
    if G == 0 or H % G:
        raise ValueError(f"heads {H} are not a multiple of groups {G}")
    if tuple(dt.shape) != (Bsz, 1, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt must be {(Bsz, 1, H)} and A {(H,)}, got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    if D is not None and tuple(D.shape) != (H,):
        raise ValueError(f"D must be {(H,)}, got {tuple(D.shape)}")
    if tuple(h.shape) != (Bsz, H, P, N):
        raise ValueError(f"the state must be {(Bsz, H, P, N)}, got "
                         f"{tuple(h.shape)}")
    if x.dtype not in _TYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, B and C must be float32 or bfloat16, all three "
                         f"alike, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    floats = (dt, A, h) + (() if D is None else (D,))
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError(f"dt, A, D and the state must be float32, got "
                         f"{[t.dtype for t in floats]}")
    devices = {t.device for t in (x, dt, A, Bm, Cm, h) + (() if D is None
                                                         else (D,))}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")


@costed(ssd_decode_cost)
def ssd_decode_plain(x, dt, A, Bm, Cm, h, D: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``ssd_ref`` at S=1, then the new state
    copied into ``h``."""
    _check(x, dt, A, Bm, Cm, h, D)
    y, new = ssd_ref(x, dt, A, Bm, Cm, D, h0=h, return_state=True)
    h.copy_(new)
    return y, h


@_build.kernel("K7", ssd_decode_cost, "SSD decode", plain_on=("cpu", "meta"))
def ssd_decode(x, dt, A, Bm, Cm, h, D: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h) of one decode step, ``h`` updated in place.

    CPU (and meta) tensors run the plain version; CUDA tensors launch K7
    on the current stream, counted in ``ssd_decode.launches`` once a
    call.  On the card the state must be contiguous; x, dt, B and C may
    have any slot stride, each dense within a slot.
    """
    _check(x, dt, A, Bm, Cm, h, D)
    if _build.runs_plain("K7", h.device):
        return ssd_decode_plain(x, dt, A, Bm, Cm, h, D)
    ins = (x, dt, A, Bm, Cm, h) + (() if D is None else (D,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise ValueError("K7 has no backward: no input of the decode step "
                         "may require grad")
    if not h.is_contiguous():
        raise ValueError("the state must be contiguous (K7 updates it in "
                         "place)")
    if not A.is_contiguous() or (D is not None and not D.is_contiguous()):
        raise ValueError("A and D must be contiguous")
    Bsz, _, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bsz, 1, H, P), dtype=x.dtype, device=x.device)
    slots = []
    for name, t in (("x", x), ("dt", dt), ("B", Bm), ("C", Cm)):
        if not t[0].is_contiguous():
            raise ValueError(f"{name} must be dense within a slot")
        slots.append(t.stride(0))
    _build.launch(
        "K7", "ssd_decode_launch", x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if D is None else D.data_ptr(), h.data_ptr(), y.data_ptr(), Bsz,
        H, P, N, G, *slots, int(x.dtype == torch.bfloat16),
        int(uses_wide_path(h)), device=h.device)
    return y, h


def uses_wide_path(h: torch.Tensor) -> bool:
    """Whether K7 walks the state ``h`` on 16-byte loads: N % 4 == 0 and
    ``h`` 16-byte aligned (else its scalar path)."""
    return h.shape[3] % 4 == 0 and h.data_ptr() % 16 == 0
