"""The control of the comparison that decides ``correct``.

The control is the reference put in the program's place, computed in the
nearest precision below the configurations' float32: bfloat16, for the
kernel body, its state and the payload alike.  At every cell's own size
and on three seeds, its runs and its state, compared as a window's runs
and the witnessed state are, have to come out not correct.  The reference itself runs on the host in well under a second at
these sizes, so this is the control's run at the cell's size.
"""
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.loops.graph_runs import graph_of
from portbench.reference import taskbench as ref
from portbench.tests.conftest import REPO, workloads

SEEDS = [2**31 + 11, 2**31 + 12, 3 * 2**30 + 5]


def cell_graph(workload, seed):
    cell = harness.resolve(workload, REPO)
    return graph_of(cell.config, cell.traffic, seed), cell


def state(g, ngraphs, dtype):
    """Every column's state (all columns run the same iterations), in
    ``dtype`` and stored as float32, as the witness reads it."""
    row = ref.body_state(g, g["iterations"], dtype).float().numpy()
    return np.broadcast_to(row, (ngraphs * g["width"], row.size))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", workloads())
def test_the_bfloat16_control_fails_at_the_cells_size(workload, seed):
    g, cell = cell_graph(workload, seed)
    ngraphs = int(cell.traffic.get("graphs", 1))
    control = ref.final_wave(g, torch.bfloat16).float().numpy()
    checks = ref.check(g, [[control] * ngraphs] * 3, ngraphs,
                       state(g, ngraphs, torch.bfloat16))
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    print(workload, seed, json.dumps({k: c["value"]
                                      for k, c in checks.items()}))


@pytest.mark.parametrize("workload", workloads())
def test_the_float32_reference_passes_at_the_cells_size(workload):
    g, cell = cell_graph(workload, SEEDS[0])
    ngraphs = int(cell.traffic.get("graphs", 1))
    wave = ref.final_wave(g).numpy()
    checks = ref.check(g, [[wave] * ngraphs] * 3, ngraphs,
                       state(g, ngraphs, torch.float32))
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
