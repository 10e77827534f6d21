"""K5, the FlashAttention-2 forward: wrapper and plain version.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` (the
Pallas TPU kernel ``_flash_kernel``).  Two CUDA kernels, chosen here by the
input type: bf16 runs ``csrc/flash_attention_sm90.cuh`` (wgmma and TMA, P
carried to the tensor cores as two bf16 terms), float32 the SIMT kernel of
``csrc/flash_attention.cu`` (float32 FMAs: the tensor cores would need
TF32).  Their headers say what bounds them on the H100 and how their
designs answer that.

The function: q is taken to float32 and multiplied by ``scale`` (1/sqrt(D)
unless given), k and v to float32; query i sits at position ``q_offset +
i`` and key j at j; a key is allowed when ``j <= q_pos`` (causal) and
``j > q_pos - window`` (a window given); masked scores are -1e30; the
softmax is taken over the allowed keys in float32; a query that no key is
allowed for gives 0 (the reference's ``attention_ref`` gives the mean of v
there); the output is in q's type.  GQA: q head h reads kv head
``h // (Hq // Hkv)``.

Layout: q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), the layout
``ops.attention`` and the models use (the Pallas kernel takes (B, H, S, D)
after a transpose); the kernels read it as it is, so nothing is copied.
Any Sq and Skv: the kernels mask their ragged edges.  ``block_q`` and
``block_k`` are the Pallas kernel's tile sizes; the result does not depend
on them (the CUDA kernels' tiles are 64 or 128 query rows by 64 keys).
Head sizes: ``HEAD_DIMS``; D = 80 (HuBERT X-Large) pads the tensor-core
kernel's tiles to 128 columns, which its header accounts for.

Gradients: K5 is a forward kernel, as the Pallas kernel is (the reference
has no backward kernel: its train step differentiates ``ops.attention``
through the jnp path).  On a CUDA tensor that needs a gradient the wrapper
runs as an autograd function: its forward launches K5, its backward
recomputes the forward through ``flash_attention_plain`` and takes that
graph's gradients (a hand-written backward kernel would be a feature the
reference lacks).  When no gradient is needed the call is the direct
launch, so serving and its captured CUDA graphs are as before.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build
from ._cost import Cost, costed, nbytes
from ._grad import plain_grads

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 128, 256)  # the head sizes K5 is built for
SMEM_LIMIT = 232448  # bytes of shared memory a block can use on Hopper
_TYPES = (torch.float32, torch.bfloat16)
_POS_LIMIT = 1 << 30  # positions, offsets and windows the kernel takes


def _scale(D: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else float(1.0 / np.sqrt(D))


def check_tma(name: str, ptr: int, strides, dtype: torch.dtype) -> None:
    """Raise ValueError unless a tensor can be a TMA operand: its data
    16-byte aligned and every stride but the innermost a multiple of 16
    bytes (``strides`` in elements, as ``Tensor.stride()`` gives them)."""
    size = dtype.itemsize
    if ptr % 16:
        raise ValueError(f"{name}: data at {ptr:#x} is not 16-byte aligned "
                         f"(TMA needs it)")
    if any((s * size) % 16 for s in strides[:-1]):
        raise ValueError(f"{name}: strides {tuple(strides)} of {size}-byte "
                         f"elements are not all multiples of 16 bytes (TMA "
                         f"needs them)")


def attention_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int],
                    q_offset: int) -> int:
    """The (query, key) pairs a head attends to: keys up to the query's
    position when causal, from ``window - 1`` before it with a window."""
    qpos = q_offset + np.arange(Sq)
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(Sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def attention_cost(q, k, v, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   scale: Optional[float] = None, block_q: int = 128,
                   block_k: int = 128) -> Cost:
    """K5's declared cost: 4 D FLOPs a head for every allowed (query, key)
    pair (the score and its share of P V), q, k and v read and the output
    written once; 4 operations a pair and head (scale, running max, exp,
    row sum)."""
    B, Sq, Hq, D = q.shape
    pairs = attention_pairs(Sq, k.shape[1], causal, window, int(q_offset))
    return Cost(4.0 * D * Hq * B * pairs,
                2 * nbytes(q) + nbytes(k) + nbytes(v), 4.0 * Hq * B * pairs)


@costed(attention_cost)
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0, scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128
                          ) -> torch.Tensor:
    """The plain PyTorch version: K5's function in float32, over the whole
    score matrix at once (not in the kernel's block order)."""
    _check(q, k, v, window, q_offset, block_q, block_k)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = q.float() * _scale(D, scale)
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v.float(), group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    alive = m > NEG_INF / 2
    p = torch.where(alive, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    safe = torch.where(l > 0, l, 1.0)  # (B, Hq, Sq, 1)
    return (o / safe.permute(0, 2, 1, 3)).to(q.dtype)


def _check(q, k, v, window, q_offset, block_q, block_k) -> None:
    """Validate shapes, types, devices and the static arguments."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, Hq, D), k and v (B, Skv, Hkv, "
                         f"D) alike, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head size")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads {Hkv}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must be float32 or bfloat16, all "
                         f"alike, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"inputs on several devices: "
                         f"{sorted({str(t.device) for t in (q, k, v)})}")
    if not isinstance(q_offset, int):
        raise ValueError(f"q_offset must be a Python int (a tensor offset "
                         f"goes to ops.attention's ref path), got "
                         f"{type(q_offset).__name__}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")


@_build.kernel("K5", attention_cost, "attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Attention of q over k and v; returns (B, Sq, Hq, D) in q's type.

    CPU tensors run the plain version; CUDA tensors launch K5 on the current
    stream (counted in ``flash_attention.launches``): the tensor-core
    kernel for bf16, the float32 kernel for float32.  On a CUDA tensor that
    needs a gradient, the launch is the forward of an autograd function
    whose backward goes through the plain version (the module's docstring).
    """
    _check(q, k, v, window, q_offset, block_q, block_k)
    if _build.runs_plain("K5", q.device):
        return flash_attention_plain(q, k, v, causal, window, q_offset, scale,
                                     block_q, block_k)
    args = (causal, window, q_offset, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, *args)
    return _launch(q, k, v, *args)


def _launch(q, k, v, causal, window, q_offset, scale) -> torch.Tensor:
    """K5 on the current stream, counted."""
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"K5 is built for head sizes {HEAD_DIMS}, got D={D}")
    big = max(Sq, Skv, abs(q_offset), window or 0)
    if big >= _POS_LIMIT:
        raise ValueError(f"positions, offsets and windows must stay below "
                         f"{_POS_LIMIT}, got {big}")
    # bf16: the tensor-core kernel, whose loads are TMA's; float32: SIMT
    bf16 = q.dtype == torch.bfloat16
    kind = "bf16" if bf16 else "f32"
    smem = getattr(_build.library(), f"flash_attention_{kind}_smem_bytes")(D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"D={D} needs {smem} bytes of shared memory a block,"
                         f" above {SMEM_LIMIT}")
    out = torch.empty_like(q)
    if bf16:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", out)):
            check_tma(name, t.data_ptr(), t.stride(), t.dtype)
    _build.launch(
        "K5", f"flash_attention_{kind}_launch", q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
        _scale(D, scale), int(bool(causal)), int(window is not None),
        int(window or 0), q_offset, device=q.device)
    return out


class _FlashAttention(torch.autograd.Function):
    """K5 forward, backward by recomputing the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, q_offset, scale)
        return _launch(q, k, v, *ctx.args)

    @staticmethod
    def backward(ctx, grad):
        grads = plain_grads(
            lambda q, k, v: flash_attention_plain(q, k, v, *ctx.args),
            ctx.saved_tensors, ctx.needs_input_grad[:3], (grad,))
        return grads + (None,) * len(ctx.args)
