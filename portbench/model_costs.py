"""The operations and bytes of a model's decode step, and of the parts of
it timed alone, for the cells that decode through the port's engine.

The peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity, at its 700 W limit): 989.4 TFLOP/s in bfloat16 and 3.35 TB/s of
HBM3.  Bytes follow ``costs.py``'s rule: each input byte read once, each
output byte written once, counting what the step needs.  Operations count
a multiply and an add as two.

``graph`` is what ``reference/granite_hybrid.graph_of`` gives: the model's
numbers under ``graph["model"]`` (one chip's share of the experts), the
slots, the chunk.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

BF16_PEAK_FLOPS = 989.4e12
HBM_PEAK_BYTES_S = 3.35e12
BF16, F32 = 2, 4


class Work(NamedTuple):
    ops: float
    bytes: float

    @property
    def bound_s(self) -> float:
        return max(self.ops / BF16_PEAK_FLOPS,
                   self.bytes / HBM_PEAK_BYTES_S)


def _dims(graph: Mapping):
    c = graph["model"]
    d = c["hidden_size"]
    H, P = c["mamba_n_heads"], c["mamba_d_head"]
    GN = c["mamba_n_groups"] * c["mamba_d_state"]
    d_in = c["mamba_expand"] * d
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    Dh = d // Hq
    lo, hi = c["experts_held"]
    n_m = c["layer_types"].count("mamba")
    n_a = c["layer_types"].count("attention")
    return c, d, H, P, GN, d_in, Hq, Hkv, Dh, hi - lo, n_m, n_a


def mixer_params(graph: Mapping):
    """(a Mamba-2 mixer's matrix parameters, an attention mixer's)."""
    c, d, H, P, GN, d_in, Hq, Hkv, Dh, _, _, _ = _dims(graph)
    mamba = d * (2 * d_in + 2 * GN + H) + d_in * d
    attn = d * (Hq + 2 * Hkv) * Dh + Hq * Dh * d
    return mamba, attn


def weight_bytes(graph: Mapping) -> float:
    """Every weight held here, read once a step: the mixers (with the
    conv, its bias and the norms), each layer's router, held experts and
    shared expert, and the tied table (the head reads all of it)."""
    c, d, H, P, GN, d_in, Hq, Hkv, Dh, held, n_m, n_a = _dims(graph)
    K = c["mamba_d_conv"]
    f, fs, E = (c["intermediate_size"], c["shared_intermediate_size"],
                c["num_local_experts"])
    mamba, attn = mixer_params(graph)
    per_m = BF16 * (mamba + (K + 1) * (d_in + 2 * GN) + d + d_in) \
        + F32 * 3 * H
    per_a = BF16 * (attn + d)
    ffn = BF16 * (held * 3 * d * f + 3 * d * fs + d) + F32 * d * E
    return n_m * per_m + n_a * per_a + (n_m + n_a) * ffn \
        + BF16 * (c["vocab_size"] * d + d)


def state_bytes(graph: Mapping, slots: int) -> float:
    """The float32 SSM states and the conv tails of every slot."""
    c, d, H, P, GN, d_in, _, _, _, _, n_m, _ = _dims(graph)
    tails = BF16 * (c["mamba_d_conv"] - 1) * (d_in + 2 * GN)
    return n_m * slots * (F32 * H * P * c["mamba_d_state"] + tails)


def step_work(graph: Mapping, depths: Sequence[int], held_pairs: float
              ) -> Work:
    """One decode step over every slot, each at its depth (the position of
    the token it feeds), with ``held_pairs`` (token, held expert) pairs
    served over the step's layers: the active weights each token uses,
    attention over the slot's cached rows, the SSM update; the bytes of
    every weight held, the states read and written, the K/V rows read and
    the new row written, and the rows in and the logits out."""
    c, d, H, P, GN, d_in, Hq, Hkv, Dh, held, n_m, n_a = _dims(graph)
    B, V = len(depths), c["vocab_size"]
    f, fs, E = (c["intermediate_size"], c["shared_intermediate_size"],
                c["num_local_experts"])
    mamba, attn = mixer_params(graph)
    N = c["mamba_d_state"]
    per_token = 2 * (n_m * mamba + n_a * attn
                     + (n_m + n_a) * (3 * d * fs + d * E) + V * d) \
        + n_m * 5 * H * P * N
    ops = B * per_token + 2 * 3 * d * f * held_pairs \
        + n_a * 4 * Hq * Dh * sum(depths)
    kv_row = 2 * Hkv * Dh * BF16
    by = weight_bytes(graph) + 2 * state_bytes(graph, B) \
        + n_a * kv_row * (sum(depths) + B) + BF16 * B * (d + V)
    return Work(float(ops), float(by))


def expert_work(graph: Mapping, pairs: float, rows: int) -> Work:
    """One layer's expert part at ``rows`` rows: the router, the held
    experts over ``pairs`` routed (token, held expert) pairs and the shared
    expert; the bytes of those weights and of the rows in and out."""
    c, d, _, _, _, _, _, _, _, held, _, _ = _dims(graph)
    f, fs, E = (c["intermediate_size"], c["shared_intermediate_size"],
                c["num_local_experts"])
    ops = 2 * (3 * d * f * pairs + rows * (3 * d * fs + d * E))
    by = BF16 * (held * 3 * d * f + 3 * d * fs) + F32 * d * E \
        + BF16 * 2 * rows * d
    return Work(float(ops), float(by))


def ssm_step_work(graph: Mapping, rows: int) -> Work:
    """One layer's Mamba-2 decode step (``ops.ssd_decode_step``) at
    ``rows`` rows: the state read and written, and its rows (x, dt, B, C
    in, y out)."""
    c, d, H, P, GN, _, _, _, _, _, _, _ = _dims(graph)
    N = c["mamba_d_state"]
    ops = rows * 5 * H * P * N
    by = 2 * F32 * rows * H * P * N \
        + rows * (BF16 * (2 * H * P + 2 * GN) + F32 * H)
    return Work(float(ops), float(by))
