"""Plain PyTorch oracles of the SSD kernel (the port of ``repro.kernels.ref``).

``ssd_ref`` is the sequential scan over time and ``ssd_chunked_ref`` the
matmul-form chunked algorithm, both in float32 with the reference's
shapes: x (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S, G, N), an
optional skip D (H,) and initial state h0 (B, H, P, N).  The attention
oracles come with the flash-attention kernel (K5).
"""
from __future__ import annotations

from typing import Optional

import torch


def _heads(m: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, S, G, N) group projections -> (B, S, H, N) float32, H = G*rep."""
    return torch.repeat_interleave(m.float(), rep, dim=2)


def _initial_state(h0, x: torch.Tensor, N: int) -> torch.Tensor:
    Bsz, _, H, P = x.shape
    if h0 is None:
        return torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    return h0.float()


def ssd_ref(x, dt, A, Bm, Cm, D: Optional[torch.Tensor] = None,
            h0: Optional[torch.Tensor] = None, return_state: bool = False):
    """Mamba-2 SSD oracle: sequential scan over time, float32 state.

    h_t = exp(dt_t A) h_{t-1} + dt_t (x_t outer B_t);  y_t = C_t . h_t + D x_t
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert H % G == 0
    rep = H // G
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = _heads(Bm, rep), _heads(Cm, rep)
    h = _initial_state(h0, x, N)
    ys = []
    for t in range(S):
        dtt = dtf[:, t]                                   # (B, H)
        da = torch.exp(dtt * Af[None])
        dbx = torch.einsum("bhp,bhn->bhpn", xf[:, t] * dtt[..., None],
                           Bf[:, t])
        h = da[..., None, None] * h + dbx
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def ssd_chunked_ref(x, dt, A, Bm, Cm, D: Optional[torch.Tensor] = None,
                    chunk: int = 64, h0: Optional[torch.Tensor] = None,
                    return_state: bool = False):
    """Matmul-form chunked SSD: masked intra-chunk products, then a short
    scan over the chunk summaries.  The same float32 sums as ``ssd_ref``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    assert S % chunk == 0
    nc = S // chunk

    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    Af = A.float()
    Bf = _heads(Bm, rep).reshape(Bsz, nc, chunk, H, N)
    Cf = _heads(Cm, rep).reshape(Bsz, nc, chunk, H, N)

    la = dtf * Af[None, None, None]                       # (B, nc, Q, H)
    cum = torch.cumsum(la, dim=2)
    # intra-chunk: y_i += sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, Qi, Qj, H)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(seg), torch.zeros((), device=x.device))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    xdt = xf * dtf[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, xdt)

    # chunk summaries: S_c = sum_j exp(cum_last - cum_j) dt_j B_j^T x_j
    last = cum[:, :, -1:, :]
    tail = torch.exp(last - cum)
    states = torch.einsum("bcjhn,bcjhp->bchpn", Bf * (tail * dtf)[..., None],
                          xf)
    chunk_decay = torch.exp(last[:, :, 0, :])             # (B, nc, H)

    h = _initial_state(h0, x, N)
    h_ins = []
    for c in range(nc):  # state entering each chunk
        h_ins.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_ins = torch.stack(h_ins, dim=1)                     # (B, nc, H, P, N)

    y_inter = torch.einsum("bcihn,bchpn->bcihp", Cf * torch.exp(cum)[..., None],
                           h_ins)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    return (y, h) if return_state else y
