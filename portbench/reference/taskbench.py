"""Task Bench's semantics in plain NumPy and PyTorch, frozen for the benchmark.

This is the yardstick the benchmark holds the program's outputs to.  It
follows the paper (Slaughter et al., SC'20, sections II and III) and the
upstream ``task_bench`` core, written from that description: it imports
nothing of the program and reads nothing the program made.

A graph is W columns by H timesteps.  Task (t, i) depends on the tasks of
timestep t-1 that its pattern names, and produces a payload of P float32
slots::

    [t, i, checksum(t, i), combined(t, i), result, result, ...]

``checksum(t, i)`` is a hash of the coordinates, ``combined(t, i)`` is that
hash plus the sum of the dependencies' ``combined`` values (both mod 2^20,
so exact in float32), and ``result`` is what the task's kernel computed:

* ``compute``: an 8 x 128 tile, every element starting at 0.5, iterating
  ``a = a*a - 1`` (a multiply, then a subtract, each rounded);
* ``memory``: a scratch of ``scratch_bytes`` float32 values, all 1.0, cut
  into windows of ``span_bytes``; iteration k applies ``x = x*1.0001 + 1``
  (a multiply, then an add) to window ``k % nwin``; the result is x[0].

Every task starts its kernel afresh, so its result is a function of its own
iteration count alone.  ``final_wave`` therefore runs the kernel once for
each distinct count in the graph and looks the result up for each task.

A run returns only the last wave, and its result slot is one value of the
kernel's state.  So the comparison also holds the whole state that the last
timestep's bodies leave on the device (``body_state``: every value of each
column's tile or scratch row) to the reference's walk: a memory body that
walks part of its windows, or a body that computes part of its tile, shows
there.  What no output shows: the bodies of the earlier timesteps, whose
state the next task overwrites, and the compute body's iteration count from
15 on, where ``a*a - 1`` from 0.5 has settled on the cycle {0, -1}: every
count of the same parity from 15 leaves the same tile.

``dtype`` is the precision of the kernel's arithmetic and of the payload.
The graph states float32; ``bfloat16`` and ``float16`` give the lower
precisions the benchmark's controls use.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Mapping

import numpy as np
import torch

CHECKSUM_MOD = 1 << 20
MIN_PAYLOAD = 5
TILE = (8, 128)

COMPUTE_START, COMPUTE_SUB = 0.5, 1.0
MEMORY_START, MEMORY_SCALE, MEMORY_BIAS = 1.0, 1.0001, 1.0

# patterns whose dependencies do not change with t (one matrix serves all)
TIME_INVARIANT = {"trivial", "no_comm", "stencil", "sweep", "nearest"}


def pattern_deps(pattern: str, params: Mapping, t: int, i: int,
                 width: int) -> List[int]:
    """Columns of timestep t-1 that task (t, i) depends on, sorted.

    Timestep 0 has no dependencies; columns outside [0, width) are dropped.
    """
    if t == 0:
        return []
    if pattern == "trivial":
        cand = []
    elif pattern == "no_comm":
        cand = [i]
    elif pattern == "stencil":
        cand = [i - 1, i, i + 1]
    elif pattern == "sweep":
        cand = [i - 1, i]
    elif pattern == "nearest":
        radix = int(params.get("radix", 3))
        lo = i - radix // 2
        cand = [lo + k for k in range(max(radix, 0))]
    elif pattern == "spread":
        radix = int(params.get("radix", 3))
        shift = t % max(1, width // max(radix, 1))
        cand = [(i + k * width // radix + shift) % width
                for k in range(max(radix, 0))]
    elif pattern == "fft":
        s = 2 ** (t - 1)
        cand = [i, i - s, i + s]
    else:
        raise KeyError(f"the reference has no pattern {pattern!r}")
    return sorted({j for j in cand if 0 <= j < width})


def dependency_matrix(pattern: str, params: Mapping, t: int,
                      width: int) -> np.ndarray:
    """int64 (width, width): M[i, j] = 1 iff (t, i) depends on (t-1, j)."""
    m = np.zeros((width, width), np.int64)
    for i in range(width):
        m[i, pattern_deps(pattern, params, t, i, width)] = 1
    return m


def checksums(t: int, width: int) -> np.ndarray:
    """int64 (width,): the coordinate hash of every task of timestep t."""
    i = np.arange(width, dtype=np.uint64)
    h = (np.uint64(t) * np.uint64(2654435761) + i * np.uint64(40503)) \
        % np.uint64(1 << 32)
    return (h % np.uint64(CHECKSUM_MOD)).astype(np.int64)


def task_iterations(graph: Mapping, t: int, i: int) -> int:
    """A task's iterations: the graph's, scaled by U[1 - imbalance, 1]
    drawn from a hash of (seed, t, i) where the graph is imbalanced."""
    its, imb = int(graph["iterations"]), float(graph.get("imbalance", 0.0))
    if imb <= 0.0:
        return its
    h = hashlib.blake2b(f"imb:{int(graph.get('seed', 0))}:{t}:{i}".encode(),
                        digest_size=8).digest()
    u = int.from_bytes(h, "little") / 2.0 ** 64
    return max(1, int(round(its * (1.0 - imb * u))))


def memory_geometry(graph: Mapping):
    """(span, size, nwin) in float32 values: whole windows only."""
    span = max(1, int(graph["span_bytes"]) // 4)
    size = max(span, int(graph["scratch_bytes"]) // 4)
    size -= size % span
    return span, size, size // span


def state_elems(graph: Mapping) -> int:
    """float32 values of one task's kernel state: the compute tile, or the
    memory kernel's scratch row."""
    if graph["kind"] == "compute":
        return TILE[0] * TILE[1]
    if graph["kind"] == "memory":
        return memory_geometry(graph)[1]
    raise KeyError(f"the reference has no kernel {graph['kind']!r}")


def body_state(graph: Mapping, iterations: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The state one task's kernel leaves after ``iterations`` iterations,
    flat: the whole compute tile, or every window of the memory scratch."""
    kind = graph["kind"]
    if kind == "compute":
        a = torch.full(TILE, COMPUTE_START, dtype=dtype)
        for _ in range(iterations):
            a = a * a
            a = a - COMPUTE_SUB
        return a.reshape(-1)
    if kind == "memory":
        span, size, nwin = memory_geometry(graph)
        x = torch.full((size,), MEMORY_START, dtype=dtype)
        for k in range(iterations):
            w = (k % nwin) * span
            win = x[w:w + span] * MEMORY_SCALE
            x[w:w + span] = win + MEMORY_BIAS
        return x
    raise KeyError(f"the reference has no kernel {kind!r}")


def kernel_result(graph: Mapping, iterations: int,
                  dtype: torch.dtype = torch.float32) -> float:
    """What one task's kernel computes in ``iterations`` iterations: the
    first value of its state."""
    return float(body_state(graph, iterations, dtype)[0])


def payload_elems(graph: Mapping) -> int:
    return max(MIN_PAYLOAD, int(graph["output_bytes"]) // 4)


def final_wave(graph: Mapping, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """The payloads of the last timestep, (width, P) in ``dtype``: what a
    run of the graph returns."""
    H, W = int(graph["height"]), int(graph["width"])
    pattern = graph["pattern"]
    params = dict(graph.get("pattern_params", {}))
    invariant = pattern in TIME_INVARIANT
    m_inv = dependency_matrix(pattern, params, 1, W) if invariant else None
    combined = np.zeros(W, np.int64)
    for t in range(H):
        if t == 0:
            acc = np.zeros(W, np.int64)
        else:
            m = m_inv if invariant else dependency_matrix(pattern, params,
                                                          t, W)
            acc = (m @ combined) % CHECKSUM_MOD
        base = checksums(t, W)
        combined = (base + acc) % CHECKSUM_MOD
    its = [task_iterations(graph, H - 1, i) for i in range(W)]
    results: Dict[int, float] = {n: kernel_result(graph, n, dtype)
                                 for n in set(its)}
    P = payload_elems(graph)
    wave = torch.empty((W, P), dtype=dtype)
    wave[:, 0] = float(H - 1)
    wave[:, 1] = torch.arange(W, dtype=torch.float64).to(dtype)
    wave[:, 2] = torch.from_numpy(checksums(H - 1, W)).to(dtype)
    wave[:, 3] = torch.from_numpy(combined).to(dtype)
    res = torch.tensor([results[n] for n in its], dtype=torch.float64)
    wave[:, 4:] = res.to(dtype)[:, None]
    return wave


def last_iterations(graph: Mapping) -> List[int]:
    """Each column's iterations at the last timestep."""
    H = int(graph["height"])
    return [task_iterations(graph, H - 1, i) for i in range(int(graph["width"]))]


# The comparison that decides ``correct``.  The configurations state float32
# arithmetic with every multiply and add rounded, so every value is exact:
# each number below counts departures, and its limit is 0.
#   payload_exact_mismatches   slots 0-3 (t, i, checksum, combined checksum)
#                              of every returned payload that differ from the
#                              reference's
#   payload_kernel_mismatches  slots 4 and up (the kernel's result) whose bits
#                              differ from the reference's
#   runs_malformed             runs that returned the wrong number of graphs,
#                              or a payload of the wrong shape or type
#   body_state_mismatches      values of the state the last timestep's bodies
#                              leave on the device (every column's whole tile
#                              or scratch row) whose bits differ from the
#                              reference's walk; a state not found, or of the
#                              wrong shape or type, counts every value
LIMITS = {"payload_exact_mismatches": 0, "payload_kernel_mismatches": 0,
          "runs_malformed": 0, "body_state_mismatches": 0}
STATE_BLOCK_ROWS = 16


def compare(want: np.ndarray, outputs, ngraphs: int) -> Dict[str, int]:
    """The numbers compared, over every run in ``outputs`` (each a list of
    ``ngraphs`` (W, P) float32 arrays) against the wave ``want``."""
    want = np.ascontiguousarray(want, np.float32)
    want_bits = want.view(np.uint32)
    exact = kernel = malformed = 0
    for run in outputs:
        waves = [np.asarray(g) for g in run]
        if len(waves) != ngraphs or any(
                g.shape != want.shape or g.dtype != np.float32
                for g in waves):
            malformed += 1
            continue
        for got in waves:
            bits = np.ascontiguousarray(got).view(np.uint32)
            diff = bits != want_bits
            exact += int(diff[:, :4].sum())
            kernel += int(diff[:, 4:].sum())
    return {"payload_exact_mismatches": exact,
            "payload_kernel_mismatches": kernel,
            "runs_malformed": malformed}


def compare_state(graph: Mapping, state, ngraphs: int) -> int:
    """``body_state_mismatches`` of ``state``, a (ngraphs * W, elems)
    float32 array: row g * W + i is column i of graph g."""
    its = last_iterations(graph)
    W, elems = len(its), state_elems(graph)
    rows = ngraphs * W
    if state is None or state.shape != (rows, elems) \
            or state.dtype != np.float32:
        return rows * elems
    want = {n: body_state(graph, n).numpy().view(np.uint32)
            for n in set(its)}
    want_rows = [want[its[r % W]] for r in range(rows)]
    bits = state.view(np.uint32)
    bad = 0
    for r0 in range(0, rows, STATE_BLOCK_ROWS):
        r1 = min(rows, r0 + STATE_BLOCK_ROWS)
        bad += int((bits[r0:r1] != np.stack(want_rows[r0:r1])).sum())
    return bad


def check(graph: Mapping, outputs, ngraphs: int, state,
          device=None) -> Dict[str, Dict]:
    """Each number compared beside its limit: ``outputs`` are the runs'
    returned payloads, ``state`` the state the last run's bodies left.
    Every value is exact, so this computes on the host whatever
    ``device`` the harness offers."""
    got = compare(final_wave(graph).numpy(), outputs, ngraphs)
    got["body_state_mismatches"] = compare_state(graph, state, ngraphs)
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in got.items()}
