"""Timers: how a scenario's wall time is produced.

The ``Timer`` protocol, ``WallClockTimer`` and ``SyntheticTimer``, copied
from the reference's ``repro.bench.timers`` with backend names resolved in
the port's registry:

``WallClockTimer``
    Real measurement: prepares the backend's concurrent program once and
    times repeated blocking executions.  A runner returns numpy, which
    waits for the device, so each sample covers the device's work.

``SyntheticTimer``
    The deterministic fake clock: the paper's overhead model
    ``wall = sum_tasks (overhead + iterations * seconds_per_iteration)``
    evaluated in closed form.  No device, no timing noise — tests assert
    exact METG crossovers against the analytic curve, and the charged
    seconds equal the reference's for every counterpart pair.

``DryRunTimer``
    The roofline cost model: runs each whole-graph program of the backend
    (``Backend.lowered_programs``) once under ``launch.roofline``'s
    counter and charges its binding term.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Protocol, Sequence, Tuple, runtime_checkable

from ..core.graph import TaskGraph


@runtime_checkable
class Timer(Protocol):
    """Produces the wall time of one complete multi-graph execution."""

    name: str

    def measure(self, backend_name: str, graphs: Sequence[TaskGraph]) -> float:
        """Seconds for one blocking execution of ``graphs`` (concurrently)."""
        ...


def timer_config(timer: Timer) -> Dict[str, object]:
    """The timer's public parameters, for the result record.

    A custom (non-dataclass) Timer may expose its own ``config()`` dict;
    otherwise its settings are unrecorded (empty dict).
    """
    if hasattr(timer, "config") and callable(timer.config):
        return dict(timer.config())
    if dataclasses.is_dataclass(timer):
        return {f.name: getattr(timer, f.name)
                for f in dataclasses.fields(timer)
                if f.repr and f.name != "name"}
    return {}


def cached_backend(cache: Dict[str, object], backend_name: str):
    """Per-timer backend cache (one backend object per spec string)."""
    if backend_name not in cache:
        from ..backends import get_backend

        cache[backend_name] = get_backend(backend_name)
    return cache[backend_name]


def backend_dispatch_model(backend_name: str) -> str:
    """Which dispatch-cost model a backend's execution implies.

    Resolved *leniently* from the registered class's ``dispatch_model``
    attribute — by name only, never by instantiation, and unknown or
    malformed names fall back to ``"per-task"`` — so the default
    synthetic configuration stays backend-free (the model tests feed it
    nonexistent backend names on purpose).
    """
    try:
        from ..backends.base import _BACKENDS, parse_backend_spec

        base, _ = parse_backend_spec(backend_name)
        cls = _BACKENDS.get(base)
    except Exception:
        return "per-task"
    if cls is None:
        return "per-task"
    return getattr(cls, "dispatch_model", "per-task")


def backend_comm_hints(backend_name: str) -> Tuple[bool, bool]:
    """``(onesided, overlap)`` for a backend spec, resolved by name only.

    The multi-rank synthetic model (``SyntheticTimer.ranks > 1``) needs
    the spec's communication mode without instantiating the backend —
    the rank sweep runs in relaunched subprocesses and the charged model
    must be a pure function of the spec string, never of the runtime's
    device count.  Malformed specs resolve to blocking two-sided (the
    conservative model), mirroring ``backend_dispatch_model``'s lenient
    fallback.
    """
    try:
        from ..backends.base import parse_backend_spec

        _, kw = parse_backend_spec(backend_name)
    except Exception:
        return False, False
    return kw.get("comm") == "onesided", kw.get("comm_overlap") is True


def backend_model_hints(backend_name: str,
                        workers: int) -> Tuple[str, bool, bool, int]:
    """``(policy, overlap, onesided, workers)`` of a backend spec.

    What the reference's timer reads off a constructed backend, read here
    from the registered class and the spec's options (the constructor's
    defaults filled in), never by construction: the port's constructors
    need a card unless the spec asks for the CPU, and the charged seconds
    must not depend on the machine.  A backend's ``schedule`` option,
    where it has one, is its ``core.schedule`` policy (``torch-host``'s
    constructor sets ``sched_policy`` to it); ``workers`` is the backend's
    own pool size where it has one, else the timer's.  An unknown backend
    raises ``KeyError``, as constructing it would.
    """
    from ..backends.base import (_BACKENDS, backend_option_signature,
                                 parse_backend_spec)

    base, kw = parse_backend_spec(backend_name)
    opts = {**backend_option_signature(base), **kw}
    cls = _BACKENDS[base]
    return (opts.get("schedule", cls.sched_policy),
            bool(opts.get("comm_overlap", cls.comm_overlap)),
            opts.get("comm") == "onesided",
            int(opts.get("workers", workers)))


def pick_sample(samples: Sequence[float], percentile: float) -> float:
    """Select the reported time: <=0 -> min (best-of-N), else percentile."""
    if not samples:
        raise ValueError("no timing samples")
    if percentile <= 0:
        return min(samples)
    ordered = sorted(samples)
    idx = max(0, min(len(ordered) - 1,
                     math.ceil(percentile / 100.0 * len(ordered)) - 1))
    return ordered[idx]


@dataclass
class WallClockTimer:
    """Times real backend executions (prepare once, run repeatedly)."""

    warmup: int = 1
    repeats: int = 3
    percentile: float = 0.0  # 0 => best-of-repeats
    name: str = field(default="wallclock", init=False)
    _backends: Dict[str, object] = field(default_factory=dict, repr=False)

    def measure(self, backend_name: str, graphs: Sequence[TaskGraph]) -> float:
        runner = cached_backend(self._backends, backend_name).prepare_many(graphs)
        for _ in range(max(self.warmup, 0)):
            runner()
        samples: List[float] = []
        for _ in range(max(self.repeats, 1)):
            t0 = time.perf_counter()
            runner()
            samples.append(time.perf_counter() - t0)
        return pick_sample(samples, self.percentile)


@dataclass
class SyntheticTimer:
    """Closed-form fake clock: ``tasks * (overhead + iters * per_iter)``.

    Imbalance-aware (uses each task's true duration), dependency-aware when
    ``seconds_per_dependency`` is set, and — in its default configuration —
    independent of the backend: the same model ``tests/test_metg.py``
    builds points from by hand, so METG crossovers are exactly
    predictable: efficiency hits 50 % where ``iters *
    seconds_per_iteration == overhead_per_task``, i.e. at granularity
    ``2 * overhead_per_task``.

    Two study extensions consult the backend's deterministic-model hints
    (``Backend.sched_policy`` / ``Backend.comm_overlap``), which
    ``backend_model_hints`` reads from the class and the spec's options;
    both are off by default.  No backend is ever instantiated:

    ``workers > 1``
        Compute time becomes the sum of per-wavefront makespans under the
        backend's scheduling policy (``core.schedule``): static column
        ownership pays the slowest block, work stealing re-packs greedily
        — the paper's §V-G imbalance-mitigation axis.  A backend that
        declares its own pool size (``torch-host``'s ``workers`` option,
        given or defaulted) overrides ``workers``, so the charged
        makespan always models the schedule the executor actually
        computed.

    ``seconds_per_byte > 0`` or ``seconds_per_rendezvous > 0``
        Each dependency moves ``output_bytes`` of payload; the per-graph
        communication term is ``ndeps * (seconds_per_dependency +
        output_bytes * seconds_per_byte)``.  Backends that double-buffer
        (``comm_overlap``) hide it behind compute — ``max(compute,
        comm)`` — while blocking backends pay ``compute + comm`` — the
        paper's §V-F communication-hiding axis.

        ``seconds_per_rendezvous`` models the two-sided matching cost: a
        per-dependency surcharge paid by every *rendezvous* comm mode
        (the sender and receiver must meet at a collective, so each
        message carries the synchronization latency).  One-sided
        backends (``Backend.comm == "onesided"``) skip it — a put/signal
        pair has no rendezvous — and their comm term is *always*
        overlappable (``max(compute, comm)``): the producer's put
        returns immediately and the consumer only spins on the signal
        word when the data hasn't already landed.

    Backends whose class declares ``dispatch_model = "per-launch"`` (the
    fused megakernel) are charged a *per-launch* model instead: one
    ``overhead_per_launch`` for the whole batch plus a small in-kernel
    ``fused_overhead_per_task`` (grid-step + table-indexing cost) per
    task, and no per-message comm term (dependencies are read inside
    the launch).  Resolution is by name only (``backend_dispatch_model``)
    — no instantiation.  With the default constants the fused METG floor
    sits ~50x below the per-task floor.

    ``ranks >= 1``
        The deterministic *rank-count* model behind the reference's
        ``metg_scaling`` weak-scaling family; 0 (the default) leaves it
        off.  Columns are owned in contiguous static blocks
        (``core.schedule.static_owners``, matching the ``CommPlan``
        shard layout), each wavefront's compute is the slowest rank's
        block, and only *cross-rank* dependencies pay the per-message
        term (intra-rank payloads are local reads) — at ``ranks=1``
        everything is local, so the weak-scaling reference ``T(1)`` is
        communication-free by construction, the same model family the
        ``n``-rank cells are charged (never the single-rank all-deps
        comm model above, which would inflate the reference).  Comm-mode
        hints resolve by spec string alone (``backend_comm_hints``) —
        never by instantiation — so the charged wall time is a pure
        function of ``(graph, ranks, spec)``, machine- and device-count-
        independent.  Per-launch backends divide their task term by
        ``ranks`` instead (one persistent kernel per rank, no message
        cost in the model — the documented idealization).
    """

    overhead_per_task: float = 20e-6
    seconds_per_iteration: float = 50e-9
    seconds_per_dependency: float = 0.0
    seconds_per_byte: float = 0.0
    seconds_per_rendezvous: float = 0.0
    workers: int = 1
    overhead_per_launch: float = 100e-6
    fused_overhead_per_task: float = 400e-9
    ranks: int = 0  # 0 = rank model off; >= 1 charges the scaling model
    name: str = field(default="synthetic", init=False)

    def _compute_seconds(self, g: TaskGraph, policy: str,
                         workers: int) -> float:
        if workers <= 1 or policy == "serial":
            return (g.num_tasks * self.overhead_per_task
                    + g.total_iterations() * self.seconds_per_iteration)
        from ..core.schedule import wavefront_makespan

        wall = 0.0
        for t in range(g.height):
            costs = [self.overhead_per_task
                     + g.task_iterations(t, i) * self.seconds_per_iteration
                     for i in range(g.width)]
            wall += wavefront_makespan(costs, workers, policy)
        return wall

    def _comm_seconds(self, g: TaskGraph, onesided: bool = False) -> float:
        per_dep = (self.seconds_per_dependency
                   + g.output_bytes * self.seconds_per_byte)
        if not onesided:
            per_dep += self.seconds_per_rendezvous
        if per_dep <= 0:
            return 0.0
        return int(g.dependence_matrices().sum()) * per_dep

    def _ranked_seconds(self, g: TaskGraph, onesided: bool,
                        overlap: bool) -> float:
        """Multi-rank weak-scaling model: block-owned compute, cross-rank
        messages only (see the ``ranks > 1`` section of the class doc)."""
        import numpy as np

        from ..core.schedule import static_owners, wavefront_makespan

        compute = 0.0
        for t in range(g.height):
            costs = [self.overhead_per_task
                     + g.task_iterations(t, i) * self.seconds_per_iteration
                     for i in range(g.width)]
            compute += wavefront_makespan(costs, self.ranks, "static")
        owners = static_owners(g.width, self.ranks)
        cross = (g.dependence_matrices()
                 & (owners[None, :, None] != owners[None, None, :]))
        per_dep = (self.seconds_per_dependency
                   + g.output_bytes * self.seconds_per_byte)
        if not onesided:
            per_dep += self.seconds_per_rendezvous
        comm = int(np.asarray(cross).sum()) * max(per_dep, 0.0)
        return max(compute, comm) if (overlap or onesided) else compute + comm

    def measure(self, backend_name: str, graphs: Sequence[TaskGraph]) -> float:
        # "torch-auto" is the planner, not a cost model: resolve it to the
        # tuning table's winner first (a pure lookup — tuner.auto_resolve
        # uses ndev=1 here so fake-clock artifacts stay machine-
        # independent) and charge THAT backend's model.  Other specs pass
        # through unchanged, so the default path stays backend-free.
        from .tuner import auto_resolve

        backend_name = auto_resolve(backend_name, graphs)
        if backend_dispatch_model(backend_name) == "per-launch":
            # one launch for the whole batch (the stacked grid covers all
            # graphs); dependencies are in-kernel refs, so no comm term.
            # ranks > 1 runs one persistent kernel per rank, so the task
            # term is divided across the rank count
            return self.overhead_per_launch + sum(
                g.num_tasks * self.fused_overhead_per_task
                + g.total_iterations() * self.seconds_per_iteration
                for g in graphs) / max(1, self.ranks)
        if self.ranks >= 1:
            onesided, overlap = backend_comm_hints(backend_name)
            return sum(self._ranked_seconds(g, onesided, overlap)
                       for g in graphs)
        policy, overlap, workers = "serial", False, self.workers
        onesided = False
        if (self.workers > 1 or self.seconds_per_byte > 0
                or self.seconds_per_rendezvous > 0):
            policy, overlap, onesided, workers = backend_model_hints(
                backend_name, self.workers)
        wall = 0.0
        for g in graphs:
            compute = self._compute_seconds(g, policy, workers)
            comm = self._comm_seconds(g, onesided)
            wall += (max(compute, comm) if overlap or onesided
                     else compute + comm)
        return wall


@dataclass
class DryRunTimer:
    """Roofline cost model over the backend's whole-graph programs.

    Requires a backend that exposes its programs
    (``Backend.lowered_programs``); host-dynamic dispatch has no
    whole-graph program and is not supported.  Each program runs once
    under ``launch.roofline.CostCounter`` and is charged its binding term
    (``launch.roofline.step_seconds``: matmul FLOPs, the kernels'
    elementwise operations, HBM bytes, collective bytes, each at its
    rate).  ``dispatch_overhead_s`` charges a fixed launch cost per
    program (per-graph programs pay it per graph).
    """

    dispatch_overhead_s: float = 0.0
    name: str = field(default="dryrun", init=False)
    _backends: Dict[str, object] = field(default_factory=dict, repr=False)

    def measure(self, backend_name: str, graphs: Sequence[TaskGraph]) -> float:
        from ..launch.roofline import count_program, step_seconds

        programs = cached_backend(self._backends,
                                  backend_name).lowered_programs(graphs)
        if not programs:
            raise ValueError(
                f"backend {backend_name!r} does not expose compiled HLO; "
                "the dry-run timer needs a whole-graph program "
                "(use wallclock or synthetic timers instead)")
        # programs execute back-to-back, so each one's *own* binding term
        # is summed (max-of-sums would let one program's compute hide
        # another's communication)
        wall = 0.0
        for program in programs:
            _, a = count_program(program)
            wall += step_seconds(a)
        return max(wall, 1e-12) + self.dispatch_overhead_s * len(programs)
