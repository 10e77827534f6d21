"""A stack of SwiGLU feed-forward layers in plain PyTorch, the yardstick of
the configurations that name ``ffn_swiglu``.

Each layer is Shazeer's FFN_SwiGLU (arXiv:2002.05202, sec. 2) with the
residual a transformer block puts around it::

    x <- x + (silu(x W_gate) * (x W_up)) W_out

It imports nothing of the program.  The benchmark's inputs, the weights
and the rows, are made here from the seed (``inputs``), on the device the
caller names: the loop hands them to the program, and ``check`` makes
them again on the device the harness gives it, so both sides see the same
numbers and the reference takes nothing the program made.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def graph_of(config: Mapping, traffic: Mapping, seed: int) -> Dict:
    """The work a run does, as plain data."""
    return {"d_model": int(config["d_model"]), "d_ff": int(config["d_ff"]),
            "num_layers": int(config["num_layers"]),
            "rows": int(traffic["rows"]), "seed": int(seed)}


def flops(graph: Mapping) -> int:
    """The three matrix products of every layer, for every row."""
    return 2 * 3 * graph["rows"] * graph["d_model"] * graph["d_ff"] \
        * graph["num_layers"]


def inputs(graph: Mapping, device) -> Tuple[List[Dict], torch.Tensor]:
    """Each layer's weights (``wi_gate``, ``wi_up``, ``wo``) and the rows,
    float32, drawn from the seed on ``device`` in one call a kind."""
    d, f, n = graph["d_model"], graph["d_ff"], graph["num_layers"]
    gen = torch.Generator(device=device)
    gen.manual_seed(graph["seed"])
    w_in = torch.randn((2, n, d, f), generator=gen, device=device) * d ** -0.5
    w_out = torch.randn((n, f, d), generator=gen, device=device) * f ** -0.5
    x = torch.randn((graph["rows"], d), generator=gen, device=device)
    layers = [{"wi_gate": w_in[0, k], "wi_up": w_in[1, k], "wo": w_out[k]}
              for k in range(n)]
    return layers, x


def forward(layers: List[Dict], x: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The stack in ``dtype``: float32 as the configuration states, or a
    lower precision for the control."""
    h = x.to(dtype)
    for p in layers:
        gate = h @ p["wi_gate"].to(dtype)
        up = h @ p["wi_up"].to(dtype)
        h = h + (F.silu(gate) * up) @ p["wo"].to(dtype)
    return h


# The comparison that decides ``correct``.
#   max_err_over_scale  the largest absolute difference of any returned
#                       value from the reference's, over the largest
#                       absolute value of the reference's output; a value
#                       that is not finite reads infinity.  CPU readings
#                       at 64 rows, five seeds: 0 for the program in
#                       float32 (the same products), 5.6e-3 to 7.5e-3 for
#                       the reference in bfloat16 (the control), 6.9e-4 to
#                       8.1e-4 in float16; the limit lies between them.
#   runs_malformed      runs that returned the wrong number of arrays, or
#                       an array of the wrong shape or type
LIMITS = {"max_err_over_scale": 1e-4, "runs_malformed": 0}


def compare(want: np.ndarray, outputs, ngraphs: int) -> Dict[str, float]:
    scale = float(np.max(np.abs(want)))
    worst, malformed = 0.0, 0
    for run in outputs:
        got = [np.asarray(a) for a in run]
        if len(got) != ngraphs or any(a.shape != want.shape
                                      or a.dtype != np.float32 for a in got):
            malformed += 1
            continue
        for a in got:
            err = float(np.max(np.abs(a.astype(np.float64) - want)))
            worst = max(worst, err / scale if np.isfinite(err) else np.inf)
    return {"max_err_over_scale": worst, "runs_malformed": malformed}


def check(graph: Mapping, outputs, ngraphs: int, state,
          device=None) -> Dict[str, Dict]:
    """Each number compared beside its limit.  The program keeps no state
    that its outputs do not show, so ``state`` is not read."""
    layers, x = inputs(graph, device or torch.device("cpu"))
    want = forward(layers, x).cpu().numpy().astype(np.float64)
    got = compare(want, outputs, ngraphs)
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in got.items()}
