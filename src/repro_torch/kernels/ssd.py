"""K6, the Mamba-2 SSD chunked forward: wrapper and plain version.

Counterpart of ``repro.kernels.ssd.ssd_chunked`` (the Pallas TPU kernel
``_ssd_kernel``).  Two CUDA kernels, picked by type and size in
``ssd_chunked``: bf16 x, B and C with P <= 64 and N <= 128 (the Mamba-2
serving path) run the tensor-core kernel of ``csrc/ssd_sm90.cuh``, three
chunk-parallel passes on ``wgmma``; everything else the SIMT kernel of
``csrc/ssd.cu``.  Their headers say what bounds them on the H100 and how
their designs answer that.

Shapes as in the reference: x (B, S, H, P), dt (B, S, H), A (H,), B and C
(B, S, G, N), D (H,) or None; S a multiple of ``chunk = min(chunk, S)``,
``chunk`` at most 128, and on the card P and N multiples of 4.  Returns
y (B, S, H, P) in x's type and the final state (B, H, P, N) in float32,
from a zero initial state.

Gradients: K6 is a forward kernel, as the Pallas kernel is (the reference
has no backward kernel: its train step differentiates ``ops.ssd`` through
the jnp path).  On a CUDA tensor that needs a gradient the wrapper runs as
an autograd function: its forward launches K6, its backward recomputes
the chunk loop through ``ssd_chunked_plain`` and takes that graph's
gradients for x, dt, A, B and C (a hand-written backward kernel would be a
feature the reference lacks); D is added outside it.  When no gradient is
needed the call is the direct launch, so serving and its captured CUDA
graphs are as before.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._cost import Cost, costed, nbytes
from ._grad import plain_grads

MAX_CHUNK = 128
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on Hopper
TC_MAX_P, TC_MAX_N = 64, 128  # the tensor-core kernel's head and state sizes
_TYPES = (torch.float32, torch.bfloat16)


def _with_skip(y: torch.Tensor, x: torch.Tensor,
               D: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's edge: y is rounded to x's type, then D x is added in
    float32 and the sum rounded again."""
    if D is None:
        return y
    return (y.float() + x.float() * D.float()[None, None, :, None]).to(x.dtype)


def ssd_cost(x, dt, A, Bm, Cm, D=None, chunk: int = MAX_CHUNK) -> Cost:
    """K6's declared cost: the causal half of the score and intra-chunk
    products, the inter-chunk and state products; x, dt, A, B, C (and D)
    read and y and the float32 state written once; two operations (the
    decay's exp and the mask) a causal score."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    chunk = min(int(chunk), S)
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    flops = Bsz * H * nc * (2 * tri * (N + P) + 4 * chunk * N * P)
    state = Bsz * H * P * N * 4
    ins = sum(nbytes(t) for t in (x, dt, A, Bm, Cm, D))
    return Cost(float(flops), ins + nbytes(x) + state,
                2.0 * Bsz * H * nc * tri)


@costed(ssd_cost)
def ssd_chunked_plain(x, dt, A, Bm, Cm, D: Optional[torch.Tensor] = None,
                      chunk: int = MAX_CHUNK
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: K6's chunk loop in float32, each chunk's
    products taken in the Pallas kernel's order."""
    chunk = _check(x, dt, A, Bm, Cm, D, chunk)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Af = A.float()
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    idx = torch.arange(chunk, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]  # (1, Qi, Qj, 1)
    # masked before the exp: above the diagonal cum_i - cum_j > 0 can
    # overflow, and exp's gradient there (0 x inf) would be NaN
    never = torch.full((), float("-inf"), device=x.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        xc = x[:, sl].float()                                   # (B, Q, H, P)
        dtc = dt[:, sl].float()                                 # (B, Q, H)
        bc = torch.repeat_interleave(Bm[:, sl].float(), rep, dim=2)
        cc = torch.repeat_interleave(Cm[:, sl].float(), rep, dim=2)
        cum = torch.cumsum(dtc * Af, dim=1)                     # (B, Q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # (B, Qi, Qj, H)
        decay = torch.exp(torch.where(tri, seg, never))
        cb = torch.einsum("bihn,bjhn->bijh", cc, bc)
        yc = torch.einsum("bijh,bjhp->bihp", cb * decay, xc * dtc[..., None])
        c_in = cc * torch.exp(cum)[..., None]
        yc = yc + torch.einsum("bihn,bhpn->bihp", c_in, h)
        tail = torch.exp(cum[:, -1:] - cum) * dtc               # (B, Q, H)
        b_in = bc * tail[..., None]
        h = torch.exp(cum[:, -1])[..., None, None] * h \
            + torch.einsum("bjhp,bjhn->bhpn", xc, b_in)
        y[:, sl] = yc.to(x.dtype)
    return _with_skip(y, x, D), h


def _check(x, dt, A, Bm, Cm, D, chunk: int) -> int:
    """Validate shapes, types and devices; return the chunk length used."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if Bm.ndim != 4 or Bm.shape[:2] != (Bsz, S) or Cm.shape != Bm.shape:
        raise ValueError(f"B and C must be (B, S, G, N) with B, S of x "
                         f"{tuple(x.shape)}, got {tuple(Bm.shape)} and "
                         f"{tuple(Cm.shape)}")
    G = Bm.shape[2]
    if G == 0 or H % G:
        raise ValueError(f"heads {H} are not a multiple of groups {G}")
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt must be {(Bsz, S, H)} and A {(H,)}, got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    if D is not None and tuple(D.shape) != (H,):
        raise ValueError(f"D must be {(H,)}, got {tuple(D.shape)}")
    if x.dtype not in _TYPES or Bm.dtype not in _TYPES or Cm.dtype != Bm.dtype:
        raise ValueError(f"x, B and C must be float32 or bfloat16 (B and C "
                         f"alike), got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} and "
                         f"{A.dtype}")
    devices = {t.device for t in (x, dt, A, Bm, Cm) + (() if D is None else (D,))}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    if S == 0:
        raise ValueError("empty sequence (S = 0)")
    chunk = min(int(chunk), S)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {chunk}")
    if S % chunk:
        raise ValueError(f"S = {S} is not a multiple of chunk {chunk}; "
                         f"ops.ssd pads it")
    return chunk


def uses_tensor_cores(x: torch.Tensor, Bm: torch.Tensor) -> bool:
    """Whether ``ssd_chunked`` runs the tensor-core kernel on the card: bf16
    x, B and C (C is B's type) with P <= 64 and N <= 128."""
    return (x.dtype == Bm.dtype == torch.bfloat16
            and x.shape[3] <= TC_MAX_P and Bm.shape[3] <= TC_MAX_N)


@_build.kernel("K6", ssd_cost, "SSD")
def ssd_chunked(x, dt, A, Bm, Cm, D: Optional[torch.Tensor] = None,
                chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, final state) of the SSD chunked forward from a zero state.

    CPU tensors run the plain version; CUDA tensors launch K6 on the current
    stream (counted in ``ssd_chunked.launches``, once a call, whichever
    kernel runs), then add D outside it.  On a CUDA tensor that needs a
    gradient, the launch is the forward of an autograd function whose
    backward goes through the plain version (the module's docstring).
    """
    chunk = _check(x, dt, A, Bm, Cm, D, chunk)
    if _build.runs_plain("K6", x.device):
        return ssd_chunked_plain(x, dt, A, Bm, Cm, D, chunk)
    ins = (x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        y, state = _SSDChunked.apply(*ins, chunk)
    else:
        y, state = _launch(*ins, chunk)
    return _with_skip(y, x, D), state


def _launch(x, dt, A, Bm, Cm, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on the current stream, counted: (y without D, final state)."""
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError("x, dt, A, B and C must be contiguous")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if P % 4 or N % 4:
        raise ValueError(f"K6 takes P and N in multiples of 4, got P={P}, "
                         f"N={N}")
    y = torch.empty_like(x)
    state = torch.empty(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    if uses_tensor_cores(x, Bm):
        for name, t in (("x", x), ("B", Bm), ("C", Cm)):
            if t.data_ptr() % 8:
                raise ValueError(f"{name} is not 8-byte aligned (the "
                                 f"tensor-core kernel copies 8 or 16 bytes "
                                 f"at a time)")
        nc = S // chunk
        hs = torch.empty(Bsz, H, nc, P, N, dtype=torch.float32,
                         device=x.device)
        decay = torch.empty(Bsz, H, nc, dtype=torch.float32, device=x.device)
        hin = torch.empty(Bsz, H, nc, 2, P, N, dtype=torch.bfloat16,
                          device=x.device)
        _build.launch(
            "K6", "ssd_chunked_bf16_launch", x.data_ptr(),
            dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), hs.data_ptr(), decay.data_ptr(),
            hin.data_ptr(), Bsz, S, H, P, G, N, chunk, device=x.device)
    else:
        smem = _build.library().ssd_chunked_smem_bytes(P, N, chunk)
        if smem > SMEM_LIMIT:
            raise ValueError(f"P={P}, N={N}, chunk={chunk} needs {smem} "
                             f"bytes of shared memory a block, above "
                             f"{SMEM_LIMIT}")
        _build.launch(
            "K6", "ssd_chunked_launch", x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            state.data_ptr(), Bsz, S, H, P, G, N, chunk,
            int(x.dtype == torch.bfloat16), int(Bm.dtype == torch.bfloat16),
            device=x.device)
    return y, state


class _SSDChunked(torch.autograd.Function):
    """K6 forward (without D), backward by recomputing the plain version."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _launch(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        grads = plain_grads(
            lambda *t: ssd_chunked_plain(*t, None, ctx.chunk),
            ctx.saved_tensors, ctx.needs_input_grad[:5], (gy, gstate))
        return grads + (None,)
