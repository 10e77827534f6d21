"""The test kind of configurations judged by ``reference/ffn_swiglu.py``
(what a kind module gives: ``kinds/taskbench.py``).

The control is the reference in bfloat16, the nearest precision below the
configuration's float32.  The faults break the program's MLP layer
(``repro_torch.models.layers.apply_mlp``) or one value a run returns.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import harness

CPU = torch.device("cpu")
SMALL_ROWS = 8


def cut_config(config):
    return {}


def cut_traffic(traffic):
    return {"rows": SMALL_ROWS}


def _readings(cell, seed, dtype):
    """The reference in ``dtype`` put in the program's place, returned as a
    run returns it, judged as a window's runs."""
    name = cell.config["reference"]
    ref = harness.load_module(
        cell.root / harness.PKG / "reference" / f"{name}.py",
        "reference_" + name)
    g = ref.graph_of(cell.config, cell.traffic, seed)
    layers, x = ref.inputs(g, CPU)
    out = ref.forward(layers, x, dtype).float().numpy()
    return ref.check(g, [[out]] * 3, 1, None, device=CPU)


def control(cell, seed):
    return _readings(cell, seed, torch.bfloat16)


def reference(cell, seed):
    return _readings(cell, seed, torch.float32)


def sound(checks):
    return set(checks) == {"max_err_over_scale", "runs_malformed"} and \
        all(c["value"] <= c["limit"] for c in checks.values())


def _state_unchanged(monkeypatch):
    """Each layer adds nothing: its rows pass through unchanged."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "apply_mlp",
                        lambda p, x, cfg: torch.zeros_like(x))


def _half_left_out(monkeypatch):
    """Each layer computes the first half of its rows; the rest get
    nothing."""
    from repro_torch.models import layers

    apply_mlp = layers.apply_mlp

    def half(p, x, cfg):
        out = torch.zeros_like(x)
        n = x.shape[0] // 2
        out[:n] = apply_mlp(p, x[:n], cfg)
        return out

    monkeypatch.setattr(layers, "apply_mlp", half)


def _answer_altered(monkeypatch):
    """One answer altered where it is produced: the largest value of one
    row of a window's run changes sign."""
    def hook(loop):
        run_once, calls = loop.run, [0]
        seed = int(loop.graph["seed"])

        def run_flipped():
            out = run_once()
            calls[0] += 1
            if calls[0] == 4:  # set-up makes 2 runs: a window's run
                row = seed % out[0].shape[0]
                col = int(np.argmax(np.abs(out[0][row])))
                out[0].view(np.uint32)[row, col] ^= np.uint32(1 << 31)
            return out

        loop.run = run_flipped
    return hook


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_left_out": _half_left_out,
    "answer_altered": _answer_altered,
}
