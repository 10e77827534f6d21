"""Task Bench graph runs through the port's own entry.

The cell's configuration gives the graph (pattern, kernel, width, height,
payload), its traffic the backend, the iterations a task and the graphs in
flight.  Set-up builds the graphs with ``repro_torch.core.graph.make_graph``,
the backend with ``repro_torch.backends.get_backend`` and the runner with
``Backend.prepare_many``, which stages the tables and, on ``cuda-graph``,
captures the program.  A run is one call of that runner: every graph run
once, the last wave copied to the host as numpy.

The state that the last timestep's task bodies leave on the device is
witnessed for the check (``witness_run``), where the program keeps it:

* the tiles and scratch rows that the body functions return
  (``repro_torch.kernels.compute.taskbench_compute`` for K1,
  ``repro_torch.kernels.memory.taskbench_memory`` for K2, and their plain
  versions on the CPU), kept from the latest call.  Set-up observes them,
  so on ``cuda-graph`` the tensor kept is the captured graph's last body
  output, which every replay writes again;
* K3 (``taskbench_fused``) allocates its per-task scratch rows with
  ``torch.empty`` for each run: the witness run keeps what that makes.

Observing is a wrapper around those functions that keeps a reference to
what they return.  It is in place only while set-up builds the runner and
during the witness run, never in the measured window, and a replay of a
captured graph calls no Python at all.
"""
from __future__ import annotations

import importlib
from contextlib import contextmanager
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from portbench import costs
from portbench.reference import taskbench as ref

# the program's task-body functions whose return value is the body's state
BODY_FUNCTIONS = (("repro_torch.kernels.compute", "taskbench_compute"),
                  ("repro_torch.kernels.compute", "taskbench_compute_plain"),
                  ("repro_torch.kernels.memory", "taskbench_memory"),
                  ("repro_torch.kernels.memory", "taskbench_memory_plain"))


def graph_of(config: Mapping, traffic: Mapping, seed: int) -> Dict:
    """The graph a cell runs, as plain data (what the reference reads)."""
    g = {k: config[k] for k in ("pattern", "kind", "width", "height",
                                "output_bytes")}
    g["pattern_params"] = dict(config.get("pattern_params", {}))
    g["imbalance"] = float(config.get("imbalance", 0.0))
    g["span_bytes"] = int(config.get("span_bytes", 64 * 1024))
    g["scratch_bytes"] = int(config.get("scratch_bytes", 1 << 20))
    g["iterations"] = int(traffic["iterations"])
    g["seed"] = int(seed)
    steps = range(1, g["height"]) if g["pattern"] not in ref.TIME_INVARIANT \
        else range(1, min(2, g["height"]))
    g["radix"] = max([1] + [len(ref.pattern_deps(
        g["pattern"], g["pattern_params"], t, i, g["width"]))
        for t in steps for i in range(g["width"])])
    return g


class Held:
    """The tensor the observed body functions returned last.

    A tensor made outside a CUDA graph capture is never let go inside one
    (freeing memory there can touch another stream and void the capture):
    it waits in ``stash`` until ``drop_stash``.
    """

    def __init__(self):
        self.latest: Optional[torch.Tensor] = None
        self.latest_captured = False
        self.stash: List[torch.Tensor] = []
        self.calls = 0

    def keep(self, out) -> None:
        if not isinstance(out, torch.Tensor):
            return
        capturing = out.is_cuda and torch.cuda.is_current_stream_capturing()
        if capturing and self.latest is not None \
                and not self.latest_captured:
            self.stash.append(self.latest)
        self.latest, self.latest_captured = out, capturing
        self.calls += 1

    def drop_stash(self) -> None:
        self.stash.clear()


class Observed:
    """One of the program's functions, called as it is; what it returns is
    kept in ``held``.  Attributes are the function's own (its launch
    counter is read and written through)."""

    def __init__(self, fn, held: Held):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_held", held)

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self._held.keep(out)
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextmanager
def observed_bodies(held: Held):
    """The body functions observed into ``held`` for the block."""
    saved = []
    for module, name in BODY_FUNCTIONS:
        mod = importlib.import_module(module)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, Observed(getattr(mod, name), held))
    try:
        yield held
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@contextmanager
def kept_empties(made: List[torch.Tensor]):
    """Every tensor ``torch.empty`` makes in the block is kept in ``made``
    (K3's wrapper makes its scratch rows with it)."""
    empty = torch.empty

    def kept(*args, **kwargs):
        out = empty(*args, **kwargs)
        made.append(out)
        return out

    torch.empty = kept
    try:
        yield made
    finally:
        torch.empty = empty


def to_host(out) -> List[np.ndarray]:
    """What the runner returns for the program's device output: one numpy
    array per graph (a stacked (G, W, P) tensor is split)."""
    if isinstance(out, torch.Tensor):
        host = out.cpu().numpy()
        return [host[k] for k in range(host.shape[0])]
    return [o.cpu().numpy() for o in out]


class Loop:
    """One client running whole graph runs back to back (a closed loop)."""

    def __init__(self, config: Mapping, traffic: Mapping, seed: int,
                 device: torch.device):
        from repro_torch.backends import get_backend, with_options
        from repro_torch.core.graph import make_graph

        self.graph = graph_of(config, traffic, seed)
        self.ngraphs = int(traffic.get("graphs", 1))
        self.device = device
        g = self.graph
        graph = make_graph(
            width=g["width"], height=g["height"], pattern=g["pattern"],
            kernel=g["kind"], iterations=g["iterations"],
            output_bytes=g["output_bytes"], imbalance=g["imbalance"],
            span_bytes=g["span_bytes"], scratch_bytes=g["scratch_bytes"],
            seed=g["seed"], **g["pattern_params"])
        spec = traffic["backend"]
        if device.type == "cpu":
            spec = with_options(spec, device="cpu")
        self.backend = get_backend(spec)
        self.held = Held()
        with observed_bodies(self.held):
            self.runner = self.backend.prepare_many([graph] * self.ngraphs)
        self.held.drop_stash()
        self.tasks_per_run = self.ngraphs * g["width"] * g["height"]
        self.useful_flops = self.ngraphs * costs.useful_flops(g)
        self.useful_bytes = self.ngraphs * costs.useful_bytes(g)

    def run(self) -> List[np.ndarray]:
        return self.runner()

    def run_split(self, before, after) -> List[np.ndarray]:
        """A run with CUDA events recorded on the stream before and after
        the runner's program: the runner's work, split where its device
        program ends and its copy to the host begins."""
        before.record()
        out = self.runner.program()
        after.record()
        return to_host(out)

    def launches(self) -> Dict[str, int]:
        """Each hand-written kernel's launches so far by the program's
        counters: each wrapper counts the launches it makes; a capture's
        nodes (``CapturedProgram.nodes``, counted once at capture) run once
        a replay, and are counted here a run by the caller."""
        from repro_torch.backends.megakernel import taskbench_fused
        from repro_torch.kernels import taskbench_compute, taskbench_memory

        return {"k1": taskbench_compute.launches,
                "k2": taskbench_memory.launches,
                "k3": taskbench_fused.launches}

    def nodes(self) -> Dict[str, int]:
        """Launches of each kernel a run makes as captured graph nodes."""
        nodes = getattr(self.runner.program, "nodes", {})
        return {k: nodes.get(fn, 0) for k, fn in
                (("k1", "taskbench_compute"), ("k2", "taskbench_memory"))
                if nodes.get(fn, 0)}

    def kernel_calls(self) -> Dict[str, object]:
        """For K1 and K2, where the runner's captured program holds them as
        nodes: a call that launches the kernel once with the cell's
        arguments (every column's tile or scratch row, the cell's
        iterations), on inputs of the benchmark's own."""
        from repro_torch.kernels import taskbench_compute, taskbench_memory

        g, calls = self.graph, {}
        rows, n = self.ngraphs * g["width"], g["iterations"]
        iters = torch.full((rows,), n, dtype=torch.int32, device=self.device)
        nodes = self.nodes()
        if "k1" in nodes:
            tiles = torch.full((rows,) + ref.TILE, ref.COMPUTE_START,
                               dtype=torch.float32, device=self.device)
            calls["k1"] = lambda: taskbench_compute(tiles, iters, n)
        if "k2" in nodes:
            span, size, _ = ref.memory_geometry(g)
            x = torch.full((rows, size), ref.MEMORY_START,
                           dtype=torch.float32, device=self.device)
            calls["k2"] = lambda: taskbench_memory(x, iters, span)
        return calls

    def witness_run(self):
        """One more run of the runner, with the body functions observed and
        the program's allocations kept: ``(outputs, state)``, ``state`` the
        (ngraphs * W, elems) float32 numpy array of what the last
        timestep's bodies left, or None where none was found."""
        elems = ref.state_elems(self.graph)
        before = self.held.calls
        made: List[torch.Tensor] = []
        with observed_bodies(self.held), kept_empties(made):
            out = self.runner.program()
            outputs = to_host(out)
        outs = out if isinstance(out, (list, tuple)) else [out]
        ptrs = {o.untyped_storage().data_ptr() for o in outs}
        made = [t for t in made
                if t.dtype == torch.float32 and t.dim() == 2
                and t.shape[1] >= elems
                and t.untyped_storage().data_ptr() not in ptrs]
        if self.held.calls > before or not made:
            state = self.held.latest
            if state is not None:
                state = state.reshape(state.shape[0], -1)
        else:
            state = torch.cat([t[:, :elems] for t in made])
        found = None if state is None else state.cpu().numpy()
        del made, state
        self.held = Held()
        return outputs, found
