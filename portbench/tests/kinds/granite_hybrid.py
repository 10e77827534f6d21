"""The test kind of configurations judged by ``reference/granite_hybrid.py``
(what a kind module gives: ``kinds/taskbench.py``).

The CPU cut keeps the published depth (four periods of 9 Mamba-2 layers
and one attention layer), the published state size, 4 of 8 experts held
with top-3 routing, and widths of 256 and below; the traffic 6 slots with
30-60-token prompts.  Shallower or narrower cuts err less in bfloat16 and
in float8 alike, and leave too little room between the two for the
cell's limit (PERF.md).  The control and the reference run at that cut
too, the full widths being for the card (``tools/granite_phase.py``
measures the control there): the reference in float8_e4m3fn (every
product's operands and the SSM state rounded, ``reference.fp8``), the
nearest precision below the configuration's bfloat16, put in the
program's place.  The faults break the program's shared expert, its
router, its SSM state, its conv bias, or one logit a run returns.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import harness

CPU = torch.device("cpu")
LAYERS = 40
CUT = {"hidden_size": 256, "num_attention_heads": 4,
       "num_key_value_heads": 2, "intermediate_size": 256,
       "shared_intermediate_size": 128, "vocab_size": 512,
       "mamba_n_heads": 32, "mamba_d_head": 16, "mamba_d_state": 128,
       "num_local_experts": 4, "published": {"num_local_experts": 8},
       "experts_held": [0, 4], "num_experts_per_tok": 3,
       "num_hidden_layers": LAYERS}
CUT_TRAFFIC = {"slots": 6, "prompt_tokens": [30, 60], "max_len": 200}
RUNS = 3


def cut_config(config):
    return dict(CUT, layer_types=list(config["layer_types"][:LAYERS]))


def cut_traffic(traffic):
    return dict(CUT_TRAFFIC)


def _reference_module(cell):
    name = cell.config["reference"]
    return harness.load_module(
        cell.root / harness.PKG / "reference" / f"{name}.py",
        "reference_" + name)


def _readings(cell, seed, rnd):
    """The reference with ``rnd`` put in the program's place at the CPU
    cut: RUNS window runs and a witness over a history of random tokens,
    returned and judged as the loop's runs are."""
    ref = _reference_module(cell)
    config = dict(cell.config, **cut_config(cell.config))
    g = ref.graph_of(config, dict(cell.traffic, **cut_traffic(cell.traffic)),
                     seed)
    allp, slots = ref.prompts(g)
    K, C = g["checked_slots"], g["chunk"]
    plen = np.array([len(allp[s]) for s in slots])
    rng = np.random.default_rng(seed)
    n = 1 + C * (RUNS + 1)  # set-up's chunk, the runs' chunks
    state = {"slots": slots, "prompt_lengths": plen.tolist(),
             "history": [rng.integers(0, g["model"]["vocab_size"], n)
                         for _ in range(K)]}
    ends = [C * (j + 1) - 1 for j in range(1, RUNS + 1)]
    runs = [plen[:, None] + e for e in ends]
    witness = np.concatenate([plen[:, None], runs[-1] - C + 1
                              + np.arange(C)], axis=1)
    need = [set(int(p) for r in runs + [witness] for p in r[s])
            for s in range(K)]
    want = ref.reference_logits(g, ref.inputs(g, CPU), state, need, CPU, rnd)

    def as_run(pos):
        tok = np.stack([state["history"][s][pos[s].max() - plen[s] + 2 - C:
                                            pos[s].max() - plen[s] + 2]
                        for s in range(K)])
        lg = np.stack([[want[(s, int(p))] for p in pos[s]]
                       for s in range(K)]).astype(np.float32)
        return [pos.astype(np.int64), tok.astype(np.int64), lg]

    outputs = [as_run(r) for r in runs] + [as_run(witness)]
    return ref.check(g, outputs, g["slots"], state, device=CPU)


def control(cell, seed):
    return _readings(cell, seed, _reference_module(cell).fp8)


def reference(cell, seed):
    return _readings(cell, seed, None)


def sound(checks):
    return set(checks) == {"max_err_over_scale", "runs_malformed"} and \
        all(c["value"] <= c["limit"] for c in checks.values())


def _shared_expert_dropped(monkeypatch):
    """The shared expert (the MLP beside the experts) adds nothing."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "apply_mlp",
                        lambda p, x, cfg: torch.zeros_like(x))


def _router_top_k_less_one(monkeypatch):
    """The router keeps one expert fewer a token (top-9 of Granite's
    top-10; top-2 of the cut's top-3), its gates renormalised over them."""
    from repro_torch.models import moe

    router = moe._router
    monkeypatch.setattr(moe, "_router",
                        lambda x2d, wr, E, k: router(x2d, wr, E, k - 1))


def _ssm_state_not_carried(monkeypatch):
    """Each Mamba-2 decode step starts from a zero state."""
    from repro_torch.kernels import ops

    step = ops.ssd_decode_step
    monkeypatch.setattr(
        ops, "ssd_decode_step",
        lambda x, dt, A, Bm, Cm, h, D=None: step(x, dt, A, Bm, Cm,
                                                 torch.zeros_like(h), D))


def _conv_bias_dropped(monkeypatch):
    """The depthwise conv adds no bias, in the prefill and in decode."""
    from repro_torch.models import ssm

    conv, conv_step = ssm._causal_conv, ssm._conv_step
    monkeypatch.setattr(ssm, "_causal_conv",
                        lambda x, w, b=None: conv(x, w))
    monkeypatch.setattr(ssm, "_conv_step",
                        lambda x_t, state, w, b=None: conv_step(x_t, state, w))


def _logit_sign_flipped(monkeypatch):
    """One answer altered where it is produced: the largest logit of one
    checked slot of a window's run changes sign."""
    def hook(loop):
        run_once, calls = loop.run, [0]
        seed = int(loop.graph["seed"])

        def run_flipped():
            out = run_once()
            calls[0] += 1
            if calls[0] == 3:  # set-up makes 2 warm runs: a window's run
                lg = out[2][seed % out[2].shape[0], 0]
                lg[int(np.argmax(np.abs(lg)))] *= -1
            return out

        loop.run = run_flipped
    return hook


FAULTS = {
    "shared_expert_dropped": _shared_expert_dropped,
    "router_top_k_less_one": _router_top_k_less_one,
    "ssm_state_not_carried": _ssm_state_not_carried,
    "conv_bias_dropped": _conv_bias_dropped,
    "logit_sign_flipped": _logit_sign_flipped,
}
