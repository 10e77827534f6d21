"""The benchmark's frozen reference, held to the port's own oracle.

This is where the two meet: the reference under ``portbench/reference/``
imports nothing of ``repro_torch``, and this test holds its last wave equal
to ``repro_torch.core.validate.execute_reference`` (the port's numpy
oracle) on small graphs.  The second half shows that the comparison which
decides ``correct`` fails on a single flipped payload bit and on a body
computed in a lower precision.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.reference import taskbench as ref
from portbench.tests.conftest import REPO
from repro_torch.core.graph import make_graph
from repro_torch.core.validate import execute_reference

CASES = [
    # (pattern, params, kind, width, height, iterations, imbalance)
    ("stencil", {}, "compute", 1, 6, 7, 0.0),
    ("stencil", {}, "compute", 13, 11, 64, 0.0),
    ("stencil", {}, "memory", 5, 9, 3, 0.0),
    ("stencil", {}, "memory", 31, 7, 19, 0.0),
    ("nearest", {"radix": 5}, "compute", 3, 8, 9, 0.0),
    ("nearest", {"radix": 5}, "memory", 17, 12, 8, 0.0),
    ("nearest", {"radix": 4}, "compute", 10, 10, 33, 0.5),
    ("stencil", {}, "memory", 9, 6, 12, 0.7),
]


def graph_pair(pattern, params, kind, width, height, iterations, imbalance,
               seed=3, output_bytes=24):
    g = {"pattern": pattern, "pattern_params": params, "kind": kind,
         "width": width, "height": height, "iterations": iterations,
         "imbalance": imbalance, "seed": seed, "output_bytes": output_bytes,
         "span_bytes": 256, "scratch_bytes": 2048}
    port = make_graph(width=width, height=height, pattern=pattern,
                      kernel=kind, iterations=iterations,
                      output_bytes=output_bytes, imbalance=imbalance,
                      span_bytes=256, scratch_bytes=2048, seed=seed, **params)
    return g, port


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(map(str, c[:6])))
def test_reference_equals_the_ports_oracle(case):
    g, port = graph_pair(*case)
    want = execute_reference(port)
    got = ref.final_wave(g).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert ref.compare(want, [[got]], 1) == {
        "payload_exact_mismatches": 0, "payload_kernel_mismatches": 0,
        "runs_malformed": 0}


@pytest.mark.parametrize("iterations", [0, 1, 5, 13, 33, 64])
@pytest.mark.parametrize("kind", ["compute", "memory"])
def test_body_state_equals_the_ports_plain_bodies(kind, iterations):
    """The state the reference walks is the port's plain body's output,
    bit for bit: the whole tile, or every window of the scratch row."""
    from repro_torch.kernels import compute, memory

    g, _ = graph_pair("stencil", {}, kind, 3, 2, iterations, 0.0)
    its = torch.full((3,), iterations, dtype=torch.int32)
    if kind == "compute":
        tiles = torch.full((3, 8, 128), 0.5)
        port = compute.taskbench_compute_plain(tiles, its, iterations)
    else:
        x = torch.ones(3, 2048 // 4)
        port = memory.taskbench_memory_plain(x, its, 256 // 4)
    want = ref.body_state(g, iterations).numpy()
    assert np.array_equal(port.reshape(3, -1).numpy().view(np.uint32),
                          np.broadcast_to(want.view(np.uint32),
                                          (3, want.size)))
    assert ref.compare_state(g, port.reshape(3, -1).numpy(), 1) == 0


def cell_graph(workload):
    from portbench import harness
    from portbench.loops.graph_runs import graph_of

    cell = harness.resolve(workload, REPO)
    return graph_of(cell.config, cell.traffic, 2**31 + 7)


def broadcast_state(g, iterations):
    row = ref.body_state(g, iterations).numpy()
    return np.broadcast_to(row, (g["width"], row.size))


@pytest.mark.parametrize("workload", ["stencil-memory.graph",
                                      "stencil-memory.fused"])
def test_a_partial_walk_fails_the_state_at_the_cells_size(workload):
    """At the memory cells' own size, a walk of half the iterations, or of
    the first window alone, leaves the first value as it should be and
    fails on the state."""
    g = cell_graph(workload)
    n = g["iterations"]
    assert ref.compare_state(g, broadcast_state(g, n), 1) == 0
    for part in (n // 2, 1):
        assert ref.body_state(g, part)[0] == ref.body_state(g, n)[0]
        bad = ref.compare_state(g, broadcast_state(g, part), 1)
        assert bad == g["width"] * (n - part) * 16384, (part, bad)


@pytest.mark.parametrize("workload", ["stencil-compute.fused-i64",
                                      "stencil-compute.graph-i64"])
def test_the_compute_tile_cannot_count_iterations_from_15(workload):
    """The blind spot of the compute cells' check, pinned: ``a*a - 1``
    from 0.5 settles on {0, -1} by 15 iterations, so every count of the
    same parity from 16 leaves the cells' 64-iteration tile; an odd count,
    or fewer than 16, fails."""
    g = cell_graph(workload)
    assert g["iterations"] == 64
    for n in (16, 32, 62):
        assert ref.compare_state(g, broadcast_state(g, n), 1) == 0
    for n in (14, 15, 63):
        assert ref.compare_state(g, broadcast_state(g, n), 1) > 0


def test_a_missing_or_misshapen_state_counts_every_value():
    g, _ = graph_pair("stencil", {}, "memory", 4, 3, 5, 0.0)
    good = broadcast_state(g, 5)
    assert ref.compare_state(g, np.ascontiguousarray(good), 1) == 0
    every = 4 * 512
    assert ref.compare_state(g, None, 1) == every
    assert ref.compare_state(g, good[:3], 1) == every
    assert ref.compare_state(g, good.astype(np.float64), 1) == every
    assert ref.compare_state(g, good, 2) == 2 * every


@pytest.mark.parametrize("kind", ["compute", "memory"])
def test_one_flipped_bit_fails(kind):
    g, _ = graph_pair("stencil", {}, kind, 12, 10, 5, 0.0)
    want = ref.final_wave(g).numpy()
    for row, slot, bit in ((3, 1, 0), (7, 3, 0), (11, 4, 0), (2, 4, 31)):
        bad = want.copy()
        bits = bad.view(np.uint32)
        bits[row, slot] ^= np.uint32(1 << bit)
        got = ref.compare(want, [[want], [bad], [want]], 1)
        assert any(got[k] > ref.LIMITS[k] for k in got), (row, slot, got)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("kind", ["compute", "memory"])
def test_a_lower_precision_fails(kind, dtype):
    g, _ = graph_pair("stencil", {}, kind, 12, 10, 5, 0.0)
    want = ref.final_wave(g).numpy()
    low = ref.final_wave(g, dtype).float().numpy()
    got = ref.compare(want, [[low]], 1)
    assert any(got[k] > ref.LIMITS[k] for k in got), got


def test_a_lower_precision_body_fails_on_its_own():
    """The body alone in float16, the checksums exact: every kernel slot
    fails."""
    g, _ = graph_pair("stencil", {}, "memory", 12, 10, 5, 0.0)
    want = ref.final_wave(g).numpy()
    low = want.copy()
    low[:, 4:] = ref.kernel_result(g, g["iterations"], torch.float16)
    got = ref.compare(want, [[low]], 1)
    assert got["payload_exact_mismatches"] == 0
    assert got["payload_kernel_mismatches"] == low[:, 4:].size


def test_malformed_runs_are_counted():
    g, _ = graph_pair("stencil", {}, "compute", 6, 4, 3, 0.0)
    want = ref.final_wave(g).numpy()
    got = ref.compare(want, [[want], [want[:5]], [want, want],
                             [want.astype(np.float64)]], 1)
    assert got["runs_malformed"] == 3


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.taskbench; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
