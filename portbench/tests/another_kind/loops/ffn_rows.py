"""Rows through a stack of the port's SwiGLU MLP layers
(``repro_torch.models.layers.apply_mlp``), one client, a closed loop.

The configuration gives the widths and the layers, the traffic the rows a
run.  Set-up makes the weights and the rows from the seed on the device
(``reference.inputs``); a run is every layer once, ``x + apply_mlp(x)``,
and the output copied to the host.  The program keeps no state that the
output does not show.
"""
from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Mapping

import numpy as np
import torch

from portbench import harness


class Loop:
    def __init__(self, config: Mapping, traffic: Mapping, seed: int,
                 device: torch.device):
        ref = harness.load_module(
            Path(__file__).resolve().parents[1] / "reference"
            / f"{config['reference']}.py", "reference_" + config["reference"])
        self.graph = ref.graph_of(config, traffic, seed)
        self.ngraphs = 1
        self.tasks_per_run = self.graph["rows"]
        self.useful_flops = ref.flops(self.graph)
        self.useful_bytes = 0
        self.layers, self.x = ref.inputs(self.graph, device)
        self.cfg = SimpleNamespace(act=config["act"])

    def program(self) -> torch.Tensor:
        from repro_torch.models import layers

        x = self.x
        for p in self.layers:
            x = x + layers.apply_mlp(p, x, self.cfg)
        return x

    def run(self) -> List[np.ndarray]:
        return [self.program().cpu().numpy()]

    def run_split(self, before, after) -> List[np.ndarray]:
        before.record()
        out = self.program()
        after.record()
        return [out.cpu().numpy()]

    def launches(self) -> Dict[str, int]:
        return {}

    def kernel_calls(self) -> Dict[str, object]:
        return {}

    def witness_run(self):
        return self.run(), None
