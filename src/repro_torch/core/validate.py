"""Self-validating reference execution (paper §II).

``execute_reference`` runs a task graph with the pure-numpy task body,
asserting at every task that the received payloads identify the expected
dependencies.  Backends are validated by comparing their final-timestep
outputs against this oracle: checksum/coordinate slots bitwise, kernel
slots with tolerance (matmul reduction order is backend-dependent).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .graph import TaskGraph


def execute_reference(graph: TaskGraph, return_all: bool = False):
    """Run the graph with the numpy task body, validating every input.

    Returns the final-timestep payload array [width, payload_elems]
    (or the full [height, width, payload_elems] history if return_all).
    """
    store: Dict[Tuple[int, int], np.ndarray] = {}
    hist = []
    for t in range(graph.height):
        row = []
        for i in range(graph.width):
            inputs = [store[(t - 1, j)] for j in graph.deps(t, i)]
            row.append(graph.execute_point(t, i, inputs))
        for i in range(graph.width):
            store[(t, i)] = row[i]
        if return_all:
            hist.append(np.stack(row))
        # free old timestep (only t-1 is ever read)
        for i in range(graph.width):
            store.pop((t - 2, i), None)
    if return_all:
        return np.stack(hist)
    return np.stack([store[(graph.height - 1, i)] for i in range(graph.width)])


def check_outputs(
    graph: TaskGraph,
    got: np.ndarray,
    expected: np.ndarray | None = None,
    kernel_rtol: float = 1e-5,
) -> None:
    """Assert a backend's final outputs match the oracle.

    Slots 0..3 (t, i, checksum, combined checksum) must match exactly;
    slot 4+ (kernel result and ballast) within ``kernel_rtol``.
    """
    if expected is None:
        expected = execute_reference(graph)
    got = np.asarray(got, dtype=np.float32)
    assert got.shape == expected.shape, (got.shape, expected.shape)
    exact_slots = got[:, :4], expected[:, :4]
    if not (exact_slots[0] == exact_slots[1]).all():
        bad = np.argwhere(exact_slots[0] != exact_slots[1])
        t0, s0 = bad[0]
        raise AssertionError(
            f"validation failed at column {t0} slot {s0}: "
            f"got {exact_slots[0][t0, s0]}, expected {exact_slots[1][t0, s0]} "
            f"(graph pattern={graph.pattern} kernel={graph.kernel.kind})"
        )
    np.testing.assert_allclose(
        got[:, 4:], expected[:, 4:], rtol=kernel_rtol, atol=1e-6,
        err_msg=f"kernel slots diverged (pattern={graph.pattern})",
    )


def check_multi(graphs: Sequence[TaskGraph], outputs: Sequence[np.ndarray], **kw) -> None:
    assert len(graphs) == len(outputs)
    for g, o in zip(graphs, outputs):
        check_outputs(g, o, **kw)
