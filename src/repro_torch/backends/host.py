"""Host-dispatch backend ``torch-host``: one dispatch per task from the host.

Counterpart of ``host-dynamic``, the analogue of the paper's dynamic,
centrally-scheduled systems (Dask, Spark, Swift/T): every task is a
separate sequence of device operations issued by the Python host.  This
is the high-overhead end of the METG spectrum — per-task cost is dominated
by dispatch, like the paper's §V-C findings for data-analytics systems.

A task is the reference's jitted task function written out as PyTorch
operations on one stream (13 launches on the card for a task with
dependencies): gather its dependencies' t-1 payload rows, combine slot 3
mod 2^20 in int64, run the body for a single column (K1 or K2 on the card,
looping the task's own iterations: the dynamic mode of ``masked_loop``)
and build the payload row.  What the reference's task computes from host
scalars (``t``, ``i``, ``iters[t, i]``) is staged on the device in
``prepare`` and sliced per task — the ``(H, W)`` iteration counts, the
base checksums and the payload head ``[t, i, base]`` — so nothing goes
from host memory to the device inside a run, and nothing syncs before the
final copy to numpy.  Kernels on one stream run one after another, so a
task's K1 (one CTA) has the card to itself and at most one SM of it.

Two executor schedules (paper §V-G, the load-imbalance study):

``schedule="static"``
    Column-order dispatch — each wavefront's tasks issue in static column
    ownership order, the per-task analogue of an MPI rank walking its
    block.

``schedule="steal"``
    Work-stealing dispatch — each wavefront's tasks issue in the greedy
    claim order of ``core.schedule.steal_schedule``: whenever a simulated
    worker goes idle it claims the longest unclaimed task, so imbalanced
    wavefronts re-pack instead of waiting on the slowest static block.
    Values are bit-identical to static (only issue *order* changes);
    the deterministic fake clock (``SyntheticTimer(workers=...)``) charges
    the matching makespan, which is where the mitigation shows up.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import CHECKSUM_MOD, TaskGraph
from ..core.kernel_ref import mxu_weight
from ..core.schedule import steal_schedule
from . import body
from .base import Backend, register_backend, resolve_device

SCHEDULES = ("static", "steal")


class _Staged(NamedTuple):
    """One graph's inputs, staged by ``prepare``."""

    graph: TaskGraph
    deps: List[List[List[int]]]  # [t][i] -> the columns of t-1 it reads
    iters: np.ndarray  # (H, W) int32: the dynamic trip counts, host ints
    iters_dev: torch.Tensor  # the same on the device, sliced per task
    bases: torch.Tensor  # (H, W) int64 base checksums
    heads: torch.Tensor  # (H, W, 3) float32 payload slots 0-2: t, i, base
    zero: torch.Tensor  # (1,) int64, the acc of a task with no dependency
    orders: List[List[int]]  # issue order of every wavefront
    mxu_w: Optional[torch.Tensor]


@register_backend("torch-host")
class HostBackend(Backend):
    paradigm = "dynamic per-task host dispatch (Dask/Spark analogue)"

    def __init__(self, schedule: str = "static", workers: int = 4,
                 device: Optional[str] = None):
        if schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r}; known: {SCHEDULES}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.schedule = schedule
        self.workers = workers
        # the schedules are core.schedule's policy names (the synthetic
        # clock reads the spec's ``schedule`` option as the policy)
        self.sched_policy = schedule
        self.device = resolve_device(device)

    @functools.cached_property
    def _mxu_w(self) -> torch.Tensor:
        """The compute_mxu weight, staged on the device once per backend."""
        return torch.as_tensor(mxu_weight(), device=self.device)

    def _wavefront_order(self, graph: TaskGraph, iters: np.ndarray,
                         t: int) -> List[int]:
        """Column issue order for timestep ``t`` under this schedule."""
        if self.schedule == "static":
            return list(range(graph.width))
        return steal_schedule(iters[t].astype(np.float64), self.workers)[0]

    def _wavefront_orders(self, graph: TaskGraph,
                          iters: np.ndarray) -> List[List[int]]:
        """Issue order of every wavefront, precomputed at prepare time so
        the timed runner pays dispatch only (the claim order is a pure
        function of the graph — recomputing it per run would charge the
        steal schedule scheduling overhead static never pays)."""
        return [self._wavefront_order(graph, iters, t)
                for t in range(graph.height)]

    def dispatch_order(self, graph: TaskGraph) -> List[Tuple[int, int]]:
        """The full (t, i) issue sequence ``prepare`` walks (pure, no torch).

        Wavefronts issue strictly in timestep order — all dependencies
        live in t-1, so any within-wavefront permutation is legal — which
        is what the work-stealing property tests assert.
        """
        _, iters = body.graph_static_inputs(graph)
        return [(t, i)
                for t, order in enumerate(self._wavefront_orders(graph, iters))
                for i in order]

    def _stage(self, graph: TaskGraph) -> _Staged:
        _, iters = body.graph_static_inputs(graph)
        bases = graph.checksum_table().astype(np.int64)
        t, i = np.meshgrid(np.arange(graph.height), np.arange(graph.width),
                           indexing="ij")
        heads = np.stack([t, i, bases], axis=-1).astype(np.float32)
        dev = self.device
        return _Staged(
            graph,
            [[graph.deps(t, i) for i in range(graph.width)]
             for t in range(graph.height)],
            iters,
            torch.as_tensor(iters, device=dev),
            torch.as_tensor(bases, device=dev),
            torch.as_tensor(heads, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            self._wavefront_orders(graph, iters),
            self._mxu_w if graph.kernel.kind == "compute_mxu" else None)

    @staticmethod
    def _task(s: _Staged, t: int, i: int,
              prev: List[torch.Tensor]) -> torch.Tensor:
        """Issue task (t, i); ``prev`` holds timestep t-1's (1, P) rows.

        The payload row is ``body.make_payload``'s: ``[t, i, base,
        combined, result]``, then ``result`` as ballast up to P slots."""
        g = s.graph
        base = s.bases[t, i:i + 1]
        deps = s.deps[t][i]
        if deps:
            inputs = torch.cat([prev[j] for j in deps])
            acc = inputs[:, 3].to(torch.int64).sum(0, keepdim=True) \
                % CHECKSUM_MOD
            combined = (base + acc) % CHECKSUM_MOD
        else:
            acc, combined = s.zero, base
        result = body.run_kernel_vec(g.kernel, s.iters_dev[t, i:i + 1], acc,
                                     int(s.iters[t, i]), s.mxu_w,
                                     dynamic=True)[:, None]
        row = [s.heads[t, i:i + 1], combined.to(torch.float32)[:, None],
               result]
        if g.payload_elems > 5:
            row.append(result.expand(1, g.payload_elems - 5))
        return torch.cat(row, dim=1)

    def _dispatch_timestep(self, s: _Staged, t: int,
                           prev: List[torch.Tensor]) -> List[torch.Tensor]:
        """Issue every task of timestep ``t`` in its wavefront's order and
        return its rows.  The caller keeps only those, so timestep t-1's
        rows are freed once t is issued (the reference pops t-2 after t;
        the stream orders the reuse of their memory)."""
        rows: List[Optional[torch.Tensor]] = [None] * s.graph.width
        for i in s.orders[t]:
            rows[i] = self._task(s, t, i, prev)
        return rows

    @staticmethod
    def _runner(issue):
        """The runner of ``issue``, a call that issues a run's tasks and
        returns each graph's final ``(W, P)`` rows on the device: a run
        is the issue and the copy to numpy, the only sync.  The runner
        keeps ``issue`` as ``runner.issue``."""
        def runner() -> List[np.ndarray]:
            return [f.cpu().numpy() for f in issue()]

        runner.issue = issue
        return runner

    def prepare(self, graphs: Sequence[TaskGraph]):
        staged = [self._stage(g) for g in graphs]

        def issue() -> List[torch.Tensor]:
            finals = []
            for s in staged:
                rows: List[torch.Tensor] = []
                for t in range(s.graph.height):
                    rows = self._dispatch_timestep(s, t, rows)
                finals.append(torch.cat(rows))
            return finals

        return self._runner(issue)

    def prepare_many(self, graphs: Sequence[TaskGraph]):
        """Concurrent execution: wavefronts of the graphs interleave.

        A dynamic scheduler with several ready task graphs issues whichever
        tasks are runnable; here the host walks timesteps outermost and
        dispatches every graph's timestep-t tasks before any graph's t+1,
        so the stream holds work from all graphs at once (the paper's
        task-parallelism scenario, Fig 9d).  Graphs of any shapes mix.
        """
        graphs = list(graphs)
        if len(graphs) <= 1:
            return self.prepare(graphs)
        staged = [self._stage(g) for g in graphs]

        def issue() -> List[torch.Tensor]:
            rows: List[List[torch.Tensor]] = [[] for _ in staged]
            for t in range(max(g.height for g in graphs)):
                for k, s in enumerate(staged):
                    if t < s.graph.height:
                        rows[k] = self._dispatch_timestep(s, t, rows[k])
            return [torch.cat(r) for r in rows]

        return self._runner(issue)
