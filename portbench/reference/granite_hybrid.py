"""Granite 4.0-H Small's forward in plain float32 PyTorch, the yardstick of
the configurations that name ``granite_hybrid``, with the benchmark's
inputs and its comparison.

The forward (``forward`` and the functions above it) is the same code as
``tests/plain/granite_hybrid.py``, and the port's tests hold the two
copies bit for bit equal.  The model (``granitemoehybrid``, config.json of
ibm-granite/granite-4.0-h-small): ``layer_types`` sets each layer's mixer,
Mamba-2 or attention; every layer is

    x <- x + r * mixer(rms(x))
    x <- x + r * (moe(rms(x)) + shared(rms(x)))

with r the ``residual_multiplier``; embeddings times
``embedding_multiplier``, logits through the tied table over
``logits_scaling``.  It imports nothing of the program and no JAX; it sets
TF32 off, so a float32 product on a card is a float32 product.

``c`` is a plain dict of the model's numbers under config.json's keys
(``model_numbers``), with ``num_local_experts`` the router's width and
``experts_held`` the experts [lo, hi) of one chip's share.  ``params``
holds the weights under the port's keys (``embed``, ``final_norm``,
``blocks``), in any dtype: each is used in float32.  ``rnd``, where given,
is applied to every product's operands and to the SSM state after each
step (the control computes in float8_e4m3fn, ``fp8``).

Departures from the published description, each at its line: the experts
are one chip's share (the others' outputs are left out, as on the chip);
the router's softmax over all experts then top-k renormalised equals the
published top-k then softmax over the k.

The benchmark's inputs, the weights and the prompts, are made here from
the seed (``inputs``, ``prompts``), on the device the caller names: the
loop hands them to the program, and ``check`` makes them again on the
device the harness gives it, so both sides see the same numbers and the
reference takes nothing the program made.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

Rnd = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(scale)


def mm(a: torch.Tensor, w: torch.Tensor, rnd=_same) -> torch.Tensor:
    """a @ w over a's last dim and w's first (w may have more dims)."""
    w2 = rnd(_f(w)).reshape(w.shape[0], -1)
    return (rnd(a) @ w2).reshape(*a.shape[:-1], *w.shape[1:])


def swiglu(h, wg, wu, wd, rnd=_same) -> torch.Tensor:
    return mm(F.silu(mm(h, wg, rnd)) * mm(h, wu, rnd), wd, rnd)


def moe(h: torch.Tensor, p: Mapping, c: Mapping, rnd=_same) -> torch.Tensor:
    """The routed experts held here: softmax over all ``num_local_experts``
    router outputs, top ``num_experts_per_tok``, gates renormalised over
    them; each token gets the gated outputs of the held experts it was
    routed to.  The absent experts' outputs are left out (one chip's
    share, as the program computes it)."""
    x = h.reshape(-1, h.shape[-1])
    probs = torch.softmax(mm(x, p["router"], rnd), dim=-1)
    top, idx = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    lo, hi = c["experts_held"]
    y = torch.zeros_like(x)
    for e in range(lo, hi):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            k = e - lo
            out = swiglu(x[tok], p["w_gate"][k], p["w_up"][k],
                         p["w_down"][k], rnd)
            y.index_add_(0, tok, gates[tok, slot, None] * out)
    return y.reshape(h.shape)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time with a bias: x (B, T, C), w (K, C)."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, k:k + T] * _f(w[k]) for k in range(K)) + _f(b)


def mamba(x: torch.Tensor, p: Mapping, c: Mapping, rnd=_same) -> torch.Tensor:
    """Mamba-2 mixer on the normed x: in-projections z, x, B|C, dt; the
    conv with its bias and SiLU; the SSD as its sequential recurrence from
    a zero state, h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t + D x_t; the gated RMSNorm of y * silu(z); the
    out-projection."""
    Bsz, T, _ = x.shape
    H, P = c["mamba_n_heads"], c["mamba_d_head"]
    G, N = c["mamba_n_groups"], c["mamba_d_state"]
    z = mm(x, p["wz"], rnd)
    xs = F.silu(_conv(mm(x, p["wx"], rnd), p["conv_x"], p["conv_x_bias"]))
    bc = F.silu(_conv(mm(x, p["wbc"], rnd), p["conv_bc"],
                      p["conv_bc_bias"]))
    dt = F.softplus(mm(x, p["wdt"], rnd) + _f(p["dt_bias"]))  # (B, T, H)
    A = -torch.exp(_f(p["A_log"]))
    xh = xs.reshape(Bsz, T, H, P)
    Bm = bc[..., :G * N].reshape(Bsz, T, G, N).repeat_interleave(H // G, 2)
    Cm = bc[..., G * N:].reshape(Bsz, T, G, N).repeat_interleave(H // G, 2)
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        dtx = rnd(dt[:, t, :, None] * xh[:, t])                # (B, H, P)
        h = rnd(torch.exp(dt[:, t] * A)[..., None, None] * h
                + dtx[..., None] * rnd(Bm[:, t])[:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, rnd(Cm[:, t])))
    y = torch.stack(ys, 1) + xh * _f(p["D"])[:, None]
    g = y.reshape(Bsz, T, H * P) * F.silu(z)
    return mm(rms(g, p["gnorm"], c["rms_norm_eps"]), p["wo"], rnd)


def attention(x: torch.Tensor, p: Mapping, c: Mapping,
              rnd=_same) -> torch.Tensor:
    """Causal GQA attention on the normed x with no positional embedding
    (NoPE), scaled by ``attention_multiplier``."""
    Bsz, T, _ = x.shape
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    q = mm(x, p["wq"], rnd)                                  # (B, T, Hq, D)
    k = mm(x, p["wk"], rnd).repeat_interleave(Hq // Hkv, 2)
    v = mm(x, p["wv"], rnd).repeat_interleave(Hq // Hkv, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", rnd(q), rnd(k))
    s = s * c["attention_multiplier"]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", rnd(a), rnd(v))
    return mm(o.reshape(Bsz, T, -1), p["wo"].reshape(-1, p["wo"].shape[-1]),
              rnd)


def block(x: torch.Tensor, p: Mapping, kind: str, c: Mapping,
          rnd=_same) -> torch.Tensor:
    r, eps = c["residual_multiplier"], c["rms_norm_eps"]
    if kind == "mamba":
        x = x + r * mamba(rms(x, p["ssd"]["norm"]["scale"], eps), p["ssd"],
                          c, rnd)
    else:
        x = x + r * attention(rms(x, p["norm1"]["scale"], eps), p["attn"],
                              c, rnd)
    h = rms(x, p["norm2"]["scale"], eps)
    m = p["mlp"]
    return x + r * (moe(h, p["moe"], c, rnd)
                    + swiglu(h, m["wi_gate"], m["wi_up"], m["wo"], rnd))


def forward(params: Mapping, c: Mapping, tokens: torch.Tensor,
            at: Optional[torch.Tensor] = None, rnd: Rnd = None
            ) -> torch.Tensor:
    """(B, T) tokens -> float32 logits (B, T, vocab), or with ``at`` ((B, m)
    positions) the logits at those positions alone, (B, m, vocab)."""
    rnd = rnd or _same
    table = params["embed"]["table"]
    x = _f(table[tokens]) * c["embedding_multiplier"]
    for p, kind in zip(params["blocks"], c["layer_types"]):
        x = block(x, p, kind, c, rnd)
    if at is not None:
        x = torch.gather(x, 1, at[..., None].expand(*at.shape, x.shape[-1]))
    h = rms(x, params["final_norm"]["scale"], c["rms_norm_eps"])
    return mm(h, table.T, rnd) / c["logits_scaling"]


# ------------------------------------------------- the benchmark's harness
def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn (clamped to its largest finite
    value), in its own dtype: the control's ``rnd``."""
    return t.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(t.dtype)


def model_numbers(config: Mapping) -> Dict:
    """The model's numbers (``c``) from a configuration file: the cut's
    ``num_local_experts`` is the experts held here, the router's width the
    published count."""
    E = config.get("published", {}).get("num_local_experts",
                                        config["num_local_experts"])
    lo, hi = config["experts_held"]
    if hi - lo != config["num_local_experts"] or not 0 <= lo < hi <= E:
        raise ValueError(f"experts_held {config['experts_held']} is not "
                         f"{config['num_local_experts']} of {E} experts")
    n = config["num_hidden_layers"]
    keys = ("hidden_size", "num_attention_heads", "num_key_value_heads",
            "intermediate_size", "shared_intermediate_size", "vocab_size",
            "num_experts_per_tok", "mamba_n_heads", "mamba_d_head",
            "mamba_n_groups", "mamba_d_state", "mamba_d_conv",
            "mamba_expand", "rms_norm_eps", "embedding_multiplier",
            "residual_multiplier", "logits_scaling", "attention_multiplier")
    c = {k: config[k] for k in keys}
    c.update(num_local_experts=E, experts_held=[lo, hi],
             layer_types=list(config["layer_types"][:n]),
             num_hidden_layers=n)
    if len(c["layer_types"]) != n:
        raise ValueError("layer_types is shorter than num_hidden_layers")
    return c


def graph_of(config: Mapping, traffic: Mapping, seed: int) -> Dict:
    """The work a cell does, as plain data."""
    lo, hi = traffic["prompt_tokens"]
    return {"model": model_numbers(config), "precision": config["precision"],
            "slots": int(traffic["slots"]),
            "checked_slots": int(traffic["checked_slots"]),
            "prompt_tokens": [int(lo), int(hi)],
            "max_len": int(traffic["max_len"]), "chunk": int(traffic["chunk"]),
            "seed": int(seed)}


def prompts(graph: Mapping):
    """(every slot's prompt, the checked slots), from the seed: lengths
    log-uniform over ``prompt_tokens`` (both ends included), token ids
    uniform over the vocabulary."""
    rng = np.random.default_rng(graph["seed"])
    lo, hi = graph["prompt_tokens"]
    lengths = np.exp(rng.uniform(np.log(lo), np.log(hi + 1),
                                 graph["slots"])).astype(np.int64)
    lengths = np.clip(lengths, lo, hi)
    vocab = graph["model"]["vocab_size"]
    out = [rng.integers(0, vocab, n, dtype=np.int64) for n in lengths]
    checked = np.sort(rng.choice(graph["slots"], graph["checked_slots"],
                                 replace=False))
    return out, [int(s) for s in checked]


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def inputs(graph: Mapping, device) -> Dict:
    """The weights under the port's keys and in its dtypes, drawn from the
    seed on ``device``, one stacked draw a weight a layer kind, in a fixed
    order: matrices normal over sqrt(fan-in) and rounded to the
    configuration's precision (the router kept float32 with those
    values); norms 1; the Mamba-2 parameters as Mamba-2 initialises them
    (dt's bias the softplus inverse of a log-uniform dt in [1e-3, 1e-1],
    A_log the log of a uniform in [1, 16], D 1, the conv's bias uniform in
    +-1/sqrt(K))."""
    c, dt = graph["model"], DTYPES[graph["precision"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(graph["seed"])
    d, V = c["hidden_size"], c["vocab_size"]
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    Dh = d // Hq
    H, P = c["mamba_n_heads"], c["mamba_d_head"]
    GN, K = c["mamba_n_groups"] * c["mamba_d_state"], c["mamba_d_conv"]
    d_in = c["mamba_expand"] * d
    f, fs = c["intermediate_size"], c["shared_intermediate_size"]
    lo, hi = c["experts_held"]
    E, kinds = c["num_local_experts"], c["layer_types"]
    n = {k: kinds.count(k) for k in ("mamba", "attention")}

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device) * fan_in ** -0.5
        return w.to(dt)

    def uniform(shape, a, b):
        return torch.empty(shape, device=device).uniform_(a, b,
                                                          generator=gen)

    def ones(shape, dtype=dt):
        return torch.ones(shape, dtype=dtype, device=device)

    embed = normal((V, d), d)
    m = n["mamba"]
    ssd = {"wz": normal((m, d, d_in), d), "wx": normal((m, d, d_in), d),
           "wbc": normal((m, d, 2 * GN), d), "wdt": normal((m, d, H), d),
           "conv_x": normal((m, K, d_in), K),
           "conv_bc": normal((m, K, 2 * GN), K),
           "conv_x_bias": uniform((m, d_in), -K ** -0.5, K ** -0.5).to(dt),
           "conv_bc_bias": uniform((m, 2 * GN), -K ** -0.5,
                                   K ** -0.5).to(dt),
           "wo": normal((m, d_in, d), d_in)}
    dt0 = torch.exp(uniform((m, H), np.log(1e-3), np.log(1e-1)))
    ssd["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))
    ssd["A_log"] = torch.log(uniform((m, H), 1.0, 16.0))
    a = n["attention"]
    attn = {"wq": normal((a, d, Hq, Dh), d), "wk": normal((a, d, Hkv, Dh), d),
            "wv": normal((a, d, Hkv, Dh), d),
            "wo": normal((a, Hq, Dh, d), Hq * Dh)}
    L = len(kinds)
    held = hi - lo
    experts = {"router": normal((L, d, E), d).float(),
               "w_gate": normal((L, held, d, f), d),
               "w_up": normal((L, held, d, f), d),
               "w_down": normal((L, held, f, d), f)}
    shared = {"wi_gate": normal((L, d, fs), d), "wi_up": normal((L, d, fs), d),
              "wo": normal((L, fs, d), fs)}
    blocks, seen = [], {"mamba": 0, "attention": 0}
    for i, kind in enumerate(kinds):
        j = seen[kind]
        seen[kind] += 1
        if kind == "mamba":
            p = {"ssd": {k: v[j] for k, v in ssd.items()}}
            p["ssd"].update(norm={"scale": ones((d,))}, gnorm=ones((d_in,)),
                            D=ones((H,), torch.float32))
        else:
            p = {"norm1": {"scale": ones((d,))},
                 "attn": {k: v[j] for k, v in attn.items()}}
        p["norm2"] = {"scale": ones((d,))}
        p["moe"] = {k: v[i] for k, v in experts.items()}
        p["mlp"] = {k: v[i] for k, v in shared.items()}
        blocks.append(p)
    return {"embed": {"table": embed}, "final_norm": {"scale": ones((d,))},
            "blocks": blocks}


# The comparison that decides ``correct``.  A run returns, for each checked
# slot, the positions of the decode steps whose last-token logits it
# returns (the last step of its chunk; the witness run the first decode
# position after the prompt and every step of its chunk), the chunk's
# tokens and those logits; the witness's state is every token each checked
# slot has generated since its prefill.  The reference teacher-forces each
# checked slot's prompt and those tokens and computes the logits at every
# returned position.
#   max_err_over_scale  the largest absolute difference of a returned
#                       logit from the reference's, over the largest
#                       absolute logit of the reference at that position,
#                       the largest over every position of every run; a
#                       value that is not finite reads infinity.  The
#                       program computes in bfloat16 with float32
#                       accumulation, and its router sees bfloat16
#                       activations: on an H100 at the cell's size (4
#                       seeds, 52-92 positions a run) it read 0.037-0.050
#                       (medians 0.025-0.027), with 25 % of its (token,
#                       layer) routings choosing another top-10 than the
#                       float32 reference's (near-ties of the 10th and
#                       11th router logits); the reference in
#                       float8_e4m3fn put in its place, the control, read
#                       0.66-0.93.  At the CPU cut of the tests
#                       (kinds/granite_hybrid.py) the program reads
#                       0.033-0.036, the control 0.138-0.271 and the
#                       faults 0.18 and above.  The limit lies between,
#                       with room on both sides.
#   runs_malformed      runs that returned the wrong arrays or shapes,
#                       positions outside what the slot has generated, or
#                       tokens that disagree with the slot's history
LIMITS = {"max_err_over_scale": 0.1, "runs_malformed": 0}


def wanted(graph, outputs, state):
    """The positions each checked slot's runs returned logits for, the
    number of malformed runs, and the runs' well-formed parts."""
    K, C = graph["checked_slots"], graph["chunk"]
    V = graph["model"]["vocab_size"]
    hist = [np.asarray(h, np.int64) for h in state["history"]]
    plen = np.asarray(state["prompt_lengths"], np.int64)
    ok, malformed, need = [], 0, [set() for _ in range(K)]
    for run in outputs:
        try:
            pos, tok, lg = (np.asarray(a) for a in run)
            m = pos.shape[1]
            good = (pos.shape == (K, m) and tok.shape == (K, C)
                    and lg.shape == (K, m, V) and lg.dtype == np.float32
                    and pos.dtype == np.int64)
        except (ValueError, TypeError, IndexError, AttributeError):
            good = False
        if good:
            for s in range(K):
                n = pos[s] - plen[s]  # index in the history of each input
                last = int(pos[s].max() - plen[s])
                if n.min() < 0 or last + 2 - C < 0 or last + 2 > len(hist[s]) \
                        or not np.array_equal(hist[s][last + 2 - C:last + 2],
                                              tok[s]):
                    good = False
        if not good:
            malformed += 1
            continue
        ok.append((pos, lg))
        for s in range(K):
            need[s].update(int(p) for p in pos[s])
    return ok, malformed, need


def compare(want: Dict, runs, malformed: int) -> Dict[str, float]:
    """``want[(s, p)]``: the reference's logits of checked slot s at
    position p (float64)."""
    worst = 0.0
    for pos, lg in runs:
        for s in range(pos.shape[0]):
            for j, p in enumerate(pos[s]):
                ref = want[(s, int(p))]
                err = float(np.max(np.abs(lg[s, j].astype(np.float64) - ref)))
                scale = float(np.max(np.abs(ref)))
                worst = max(worst, err / scale if np.isfinite(err)
                            else np.inf)
    return {"max_err_over_scale": worst, "runs_malformed": malformed}


def reference_logits(graph: Mapping, params: Mapping, state, need,
                     device, rnd: Rnd = None) -> Dict:
    """The reference's logits at the needed positions of each checked
    slot, the checked slots' sequences right-padded into one batch (causal
    layers: a pad after a position changes nothing there)."""
    allp, _ = prompts(graph)
    slots = state["slots"]
    seqs = [np.concatenate([allp[s], np.asarray(h, np.int64)])
            for s, h in zip(slots, state["history"])]
    last = [max(nd) if nd else 0 for nd in need]
    T = max(last) + 1
    tokens = torch.zeros((len(seqs), T), dtype=torch.int64)
    for s, seq in enumerate(seqs):
        tokens[s, :last[s] + 1] = torch.from_numpy(seq[:last[s] + 1])
    order = [sorted(nd) or [0] for nd in need]
    M = max(len(o) for o in order)
    at = torch.tensor([o + o[:1] * (M - len(o)) for o in order])
    with torch.no_grad():
        lg = forward(params, graph["model"], tokens.to(device),
                     at.to(device), rnd).double().cpu().numpy()
    return {(s, p): lg[s, j] for s, o in enumerate(order)
            for j, p in enumerate(o)}


def check(graph: Mapping, outputs, ngraphs: int, state,
          device=None) -> Dict[str, Dict]:
    """Each number compared beside its limit.  ``state`` is the checked
    slots' histories (``slots``, ``prompt_lengths``, ``history``)."""
    device = device or torch.device("cpu")
    if state is None:
        got = {"max_err_over_scale": np.inf, "runs_malformed": len(outputs)}
        return {k: {"value": v, "limit": LIMITS[k]} for k, v in got.items()}
    runs, malformed, need = wanted(graph, outputs, state)
    params = inputs(graph, device)
    want = reference_logits(graph, params, state, need, device)
    del params
    got = compare(want, runs, malformed)
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in got.items()}
