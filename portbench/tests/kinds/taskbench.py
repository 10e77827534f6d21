"""The test kind of configurations judged by ``reference/taskbench.py``.

Every configuration's ``reference`` names a kind module beside this one
(``portbench/tests/kinds/<reference>.py``), and the tests that run on
every cell take their cases from it:

* ``cut_config(config)``, ``cut_traffic(traffic)``: the changes that bring
  a cell to a size the CPU runs in a fraction of a second;
* ``control(cell, seed)``: the checks of the reference put in the
  program's place in the nearest precision below the configuration's, at
  the cell's own size; they have to come out not correct;
* ``reference(cell, seed)``: the same in the configuration's precision;
  it has to come out correct;
* ``FAULTS``: each a function of pytest's ``monkeypatch`` that breaks the
  timed path underneath and returns a loop hook or None; a run with any
  of them has to come out not correct;
* ``sound(checks)``: what a correct run's checks read on the CPU.

Here the control is the reference in bfloat16 (kernel body, its state and
the payload alike); the faults break the program's task bodies, its
dependency tables, or one payload bit.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import harness

SMALL = {"width": 7, "height": 9}
SMALL_MEMORY = {"scratch_bytes": 8192, "span_bytes": 1024}
SMALL_ITERATIONS = 5


def cut_config(config):
    return dict(SMALL, **(SMALL_MEMORY if config["kind"] == "memory"
                          else {}))


def cut_traffic(traffic):
    return {"iterations": SMALL_ITERATIONS}


def modules(cell):
    """The cell's loop and reference modules, from its own tree."""
    pb = cell.root / harness.PKG
    loop = harness.load_module(pb / "loops" / f"{cell.traffic['loop']}.py",
                               "loop_" + cell.traffic["loop"])
    ref = harness.load_module(
        pb / "reference" / f"{cell.config['reference']}.py",
        "reference_" + cell.config["reference"])
    return loop, ref


def _readings(cell, seed, dtype):
    """The reference's wave and state in ``dtype``, stored as float32 as a
    run returns and the witness reads them, judged as a window's runs."""
    loop, ref = modules(cell)
    g = loop.graph_of(cell.config, cell.traffic, seed)
    ngraphs = int(cell.traffic.get("graphs", 1))
    wave = ref.final_wave(g, dtype).float().numpy()
    # every column runs the same iterations, so one row serves them all
    row = ref.body_state(g, g["iterations"], dtype).float().numpy()
    state = np.broadcast_to(row, (ngraphs * g["width"], row.size))
    return ref.check(g, [[wave] * ngraphs] * 3, ngraphs, state)


def control(cell, seed):
    return _readings(cell, seed, torch.bfloat16)


def reference(cell, seed):
    return _readings(cell, seed, torch.float32)


def sound(checks):
    return set(checks) == {"payload_exact_mismatches",
                           "payload_kernel_mismatches", "runs_malformed",
                           "body_state_mismatches"} and \
        all(c["value"] == 0 and c["limit"] == 0 for c in checks.values())


def deps_only(keep):
    """Patches of a graph's dependency tables so that column i keeps only
    the dependencies ``keep(i, j, width)`` allows."""
    from repro_torch.core.graph import TaskGraph

    table, mats = TaskGraph.dependency_table, TaskGraph.dependence_matrices

    def dependency_table(self, radix=None):
        idx, mask = table(self, radix)
        mask = mask.copy()
        H, W, R = idx.shape
        for i in range(W):
            for r in range(R):
                if not keep(i, int(idx[0, i, r]), W):
                    mask[:, i, r] = 0
        return idx, mask

    def dependence_matrices(self):
        m = mats(self).copy()
        W = m.shape[1]
        for i in range(W):
            for j in range(W):
                if not keep(i, j, W):
                    m[:, i, j] = False
        return m

    return dependency_table, dependence_matrices


def part_of_the_body(what):
    """Patches of the plain task bodies (what the CPU path runs) that do
    part of their work: ``half`` the iterations, or only the ``first``
    part of their state (the tile's first value, the scratch's first
    window)."""
    from repro_torch.kernels import compute, memory

    tile, walk = compute.taskbench_compute_plain, memory.taskbench_memory_plain

    def compute_part(tiles, iters, max_iters):
        if what == "half":
            return tile(tiles, iters // 2, max_iters // 2)
        out = tiles.clone()
        out[:, 0, 0] = tile(tiles, iters, max_iters)[:, 0, 0]
        return out

    def memory_part(x, iterations, span):
        if what == "half":
            return walk(x, iterations // 2, span)
        return walk(x, iterations.clamp(max=1), span)

    return {(compute, "taskbench_compute_plain"): compute_part,
            (memory, "taskbench_memory_plain"): memory_part}


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: the body never advances."""
    from repro_torch.kernels import compute, memory

    monkeypatch.setattr(compute, "compute_step", lambda a: a + 0.0)
    monkeypatch.setattr(memory, "memory_step", lambda a: a + 0.0)


def _half_iterations(monkeypatch):
    """Every body runs half its iterations."""
    for (mod, name), fn in part_of_the_body("half").items():
        monkeypatch.setattr(mod, name, fn)


def _dependencies(keep):
    def fault(monkeypatch):
        from repro_torch.core.graph import TaskGraph

        table, mats = deps_only(keep)
        monkeypatch.setattr(TaskGraph, "dependency_table", table)
        monkeypatch.setattr(TaskGraph, "dependence_matrices", mats)
    return fault


def _answer_altered(monkeypatch):
    """One answer altered where it is produced: a bit of a window's run."""
    def hook(loop):
        run_once, calls = loop.run, [0]
        seed = int(loop.graph["seed"])

        def run_flipped():
            out = run_once()
            calls[0] += 1
            if calls[0] == 4:  # set-up makes 2 runs: a window's run
                bits = out[0].view(np.uint32)
                bits[seed % out[0].shape[0], seed % 5] ^= np.uint32(1)
            return out

        loop.run = run_flipped
    return hook


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_iterations": _half_iterations,
    # half the columns' dependencies left out of the combine
    "half_left_out": _dependencies(lambda i, j, W: i < W // 2),
    # the exchange between columns left out: each keeps only its own
    "no_exchange": _dependencies(lambda i, j, W: i == j),
    "answer_altered": _answer_altered,
}
