"""Plain PyTorch oracles of the LM kernels (the port of ``repro.kernels.ref``).

``attention_ref`` is grouped-query softmax attention with per-batch query
offsets and key positions (ring caches, serving slots), and
``attention_ref_chunked`` the same over query chunks; q (B, Sq, Hq, D), k
and v (B, Skv, Hkv, D).  ``ssd_ref`` is the sequential scan over time and
``ssd_chunked_ref`` the matmul-form chunked algorithm, both in float32
with the reference's shapes: x (B, S, H, P), dt (B, S, H), A (H,), B and C
(B, S, G, N), an optional skip D (H,) and initial state h0 (B, H, P, N).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


# ------------------------------------------------------------ attention
def attention_ref(q, k, v, causal: bool = True, window: Optional[int] = None,
                  q_offset=0, kv_positions: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query softmax attention oracle, float32 accumulation.

    ``window=w`` allows key j for query i iff i - w < j <= i.  ``q_offset``
    (int, 0-d or (B,) tensor) is the absolute position of q[0];
    ``kv_positions`` ((Skv,) or (B, Skv)) gives keys arbitrary positions,
    negative ones marking invalid slots.  As in the reference: q is scaled
    in its own type, the logits and softmax are float32, the probabilities
    are rounded to v's type before the PV product, and a query with no
    allowed key gets the mean of v (a softmax over equal -1e30 logits).
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(D)
    dev = q.device

    # the reference multiplies by the scale rounded to q's type; a Python
    # float of that value keeps the product on the device, with no copy
    qs = q * torch.tensor(scale, dtype=q.dtype).item()
    qo = torch.as_tensor(q_offset, device=dev)
    rows = torch.arange(Sq, device=dev)[None, :, None]
    qpos = rows + (qo[:, None, None] if qo.ndim == 1 else qo)
    if kv_positions is None:
        kpos = torch.arange(Skv, device=dev)[None, None, :]
    else:
        kvp = torch.as_tensor(kv_positions, device=dev)
        kpos = kvp[None, None, :] if kvp.ndim == 1 else kvp[:, None, :]
    mask = kpos >= 0  # (Bm, Sq, Skv), Bm in {1, B}
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)

    if Sq == 1:  # decode: grouped over the un-repeated K/V
        qg = qs.reshape(B, Sq, Hkv, group, D).float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
        return out.reshape(B, Sq, Hq, D).to(q.dtype)

    kf = torch.repeat_interleave(k, group, dim=2).float()
    vf = torch.repeat_interleave(v, group, dim=2).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kf)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), vf)
    return out.to(q.dtype)


def attention_ref_chunked(q, k, v, causal: bool = True,
                          window: Optional[int] = None, q_offset=0,
                          kv_positions: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          q_chunk: int = 1024) -> torch.Tensor:
    """``attention_ref`` over query chunks of ``q_chunk`` rows: the logits
    held at once are (B, H, q_chunk, Skv).  A length that is not a multiple
    of the chunk runs as one chunk, as in the reference."""
    B, Sq, Hq, D = q.shape
    q_chunk = min(q_chunk, Sq)
    if Sq % q_chunk:
        q_chunk = Sq
    outs = [attention_ref(q[:, i:i + q_chunk], k, v, causal=causal,
                          window=window, q_offset=q_offset + i,
                          kv_positions=kv_positions, scale=scale)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1)


# ------------------------------------------------------------------- SSD


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
