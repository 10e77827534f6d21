"""The control of the comparison that decides ``correct``.

The control is the reference put in the program's place, computed in the
nearest precision below the configuration's: each cell's test kind gives
it (``kinds/<reference>.py``; for Task Bench graphs bfloat16, for the
kernel body, its state and the payload alike).  At every cell's own size
and on three seeds, its runs, compared as a window's runs are, have to
come out not correct, and the reference in the configuration's precision
has to come out correct.  The references run on the host in well under a
second at these sizes, so this is the control's run at the cell's size.
"""
import json

import pytest

from portbench import harness
from portbench.tests.conftest import cells, kind, root_of

SEEDS = [2**31 + 11, 2**31 + 12, 3 * 2**30 + 5]


def kind_and_cell(workload, another_tree):
    root = root_of(workload, another_tree)
    return kind(root, workload), harness.resolve(workload, root)


@pytest.mark.parametrize("workload,seed",
                         [(w, s) for w in cells() for s in SEEDS])
def test_the_bfloat16_control_fails_at_the_cells_size(workload, seed,
                                                      another_tree):
    k, cell = kind_and_cell(workload, another_tree)
    checks = k.control(cell, seed)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    print(workload, seed, json.dumps({k: c["value"]
                                      for k, c in checks.items()}))


@pytest.mark.parametrize("workload", cells())
def test_the_float32_reference_passes_at_the_cells_size(workload,
                                                        another_tree):
    k, cell = kind_and_cell(workload, another_tree)
    checks = k.reference(cell, SEEDS[0])
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
