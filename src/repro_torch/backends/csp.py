"""CSP backend ``torch-csp``: rank processes exchanging rows every timestep.

Counterpart of ``shardmap-csp``, the analogue of the paper's MPI
implementation (Listing 2): the graph's columns are blocked over ranks,
and every timestep each rank receives the payload rows its tasks depend
on, runs its tasks, and sends its rows on.  A rank is a process of
``dist.ranks`` (the reference's ``shard_map`` over a mesh axis); the rows
move through ``CommPlan.exchange`` and the one-sided push, staged through
host buffers over gloo, and each rank's body runs K1 or K2 on its device
for its ``local`` columns.  All planning — halo sizing, ragged-width
padding, dependence re-indexing, mode selection — is
``dist.collectives.CommPlan``'s; this module only owns execution.

``PlannedSPMDBackend`` is the shared machinery: a backend that blocks
graph columns over ranks and moves rows with a ``CommPlan`` (CSP over
``cols``, the pipeline backend over ``stage``) subclasses it and picks an
axis and a mode preference.  The controller hands each rank its slice of
the plan's tables, never the whole ``(H, W, W)`` stack, and a run collects
each rank's ``(local, P)`` rows and trims the padding.

The reference's four program shapes, each over the graphs of one program
in lockstep (timestep t of every graph in one loop step):

blocking
    exchange, then the body — communication and computation strictly
    alternate, as in MPI CSP (paper §V-F/G).
``comm_overlap=True``
    double-buffered (the MPI_Isend/Irecv analogue): right after step t's
    rows are produced the exchange for step t+1 is posted (async gloo
    ops), and it is waited on only before step t+1's body reads it, so one
    graph's exchange is in flight while the next graph's body is issued.
    The last timestep runs outside the loop, so exactly H exchanges.
``comm="onesided"``
    put/signal: each rank keeps receive buffers and signal counters
    across steps (``CommPlan.onesided_state``), pushes its rows with the
    flag (``onesided_push``) and builds its context through the masked
    wait (``onesided_wait``); with ``comm_overlap`` the push is posted
    after the body and completed before the next body.

Every form gives the same values; a rank with ``local == 1`` runs the
kernel loop's dynamic mode, the trip count the host int from its staged
numpy iterations.  ``prepare_many`` is the combined program when the
graphs' heights agree, else ``prepare`` (each graph its own program).

``ranks`` defaults to what the reference's default mesh counts: the
cards (``torch.cuda.device_count()``) on CUDA, 1 on the CPU; ``ranks=N``
puts N ranks on one device.  A runner keeps each rank's split of its last
run in ``runner.stats`` (host seconds in the body, waiting for the device,
staging copies and gloo; the launches by kernel id) and ``runner.profile()``
runs once more under ``torch.profiler`` in every rank.
"""
from __future__ import annotations

import functools
import time
import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed

from ..core.graph import TaskGraph
from ..core.kernel_ref import mxu_weight
from ..dist import collectives as CC
from ..dist import ranks as R
from ..kernels import _build
from . import body
from .base import Backend, register_backend, resolve_device

AXIS = "cols"


# ------------------------------------------------------------ on a rank
class _Part(NamedTuple):
    """One graph of a job, staged on a rank."""

    graph: TaskGraph
    plan: CC.CommPlan  # without its tables
    mats: torch.Tensor  # (H, local, ctx) uint8
    iters: torch.Tensor  # (H, local) int32
    iters_np: np.ndarray  # the same on the host: the dynamic trip counts
    cols: torch.Tensor
    mxu_w: Optional[torch.Tensor]
    dynamic: bool


def _rank_stage(ctx: R.RankContext, job: int, items) -> None:
    """Stage a job's graphs on this rank: ``items`` are ``(graph, plan
    without tables, mats, iters)``, the rank's shard of each plan."""
    parts = []
    for graph, plan, mats, iters in items:
        mxu_w = None
        if graph.kernel.kind == "compute_mxu":
            if "mxu_w" not in ctx.cache:
                ctx.cache["mxu_w"] = torch.as_tensor(mxu_weight(),
                                                     device=ctx.device)
            mxu_w = ctx.cache["mxu_w"]
        parts.append(_Part(
            graph, plan, torch.as_tensor(mats, device=ctx.device),
            torch.as_tensor(iters, device=ctx.device), iters,
            plan.local_cols(ctx.comm), mxu_w, plan.local == 1))
    ctx.jobs[job] = parts


def _program(parts: List[_Part], comm: R.RankComm,
             clock: dict) -> List[torch.Tensor]:
    """The rank program: every part's timesteps in lockstep, in the shape
    the plans ask for.  Returns each part's final ``(local, P)`` rows."""
    plan0 = parts[0].plan
    height = parts[0].graph.height
    tags = [k * p.plan.tag_span for k, p in enumerate(parts)]

    def run_body(p: _Part, t: int, ctx_rows: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out = body.timestep(p.graph, t, ctx_rows, p.mats[t], p.iters[t],
                            p.cols, p.mxu_w, p.dynamic,
                            int(p.iters_np[t].max()) if p.dynamic else None)
        clock["body_s"] += time.perf_counter() - t0
        return out

    payloads = [torch.zeros((p.plan.local, p.graph.payload_elems),
                            dtype=torch.float32, device=comm.device)
                for p in parts]
    onesided = plan0.mode == "onesided"
    states = ([p.plan.onesided_state(p.graph.payload_elems, comm.device)
               for p in parts] if onesided else None)

    if plan0.comm_overlap:
        # the exchange of step t+1 posted right after step t's rows, and
        # waited on before step t+1's body reads them
        def post(k: int, t: int, rows: torch.Tensor):
            p = parts[k]
            if not onesided:
                return p.plan.exchange(rows, comm, True, tags[k])
            recv, sig = states[k]
            return p.plan.onesided_push(rows, recv, sig, comm, True,
                                        tags[k]).then(
                lambda rs: p.plan.onesided_wait(*rs, t + 1, rows))

        if onesided:
            pending = [R.Done(p.plan.onesided_wait(*s, 0, rows))
                       for p, s, rows in zip(parts, states, payloads)]
        else:
            pending = [post(k, -1, rows) for k, rows in enumerate(payloads)]
        for t in range(height - 1):
            for k, p in enumerate(parts):
                pending[k] = post(k, t, run_body(p, t, pending[k].wait()))
        return [run_body(p, height - 1, pend.wait())
                for p, pend in zip(parts, pending)]

    for t in range(height):
        for k, p in enumerate(parts):
            if onesided:
                recv, sig = states[k]
                rows = run_body(p, t, p.plan.onesided_wait(recv, sig, t,
                                                           payloads[k]))
                p.plan.onesided_push(rows, recv, sig, comm, tag=tags[k])
            else:
                rows = run_body(p, t, p.plan.exchange(payloads[k], comm,
                                                      tag=tags[k]))
            payloads[k] = rows
    return payloads


def _rank_run(ctx: R.RankContext, job: int, profile: bool = False):
    """Run a staged job once: each part's ``(local, P)`` rows as numpy,
    and this run's split of the rank's time."""
    parts = ctx.jobs[job]
    comm = ctx.comm
    comm.reset_stats()
    clock = {"body_s": 0.0}
    before = _build.launch_counts()
    prof = None

    def timed_run():
        # start together: a rank's profiler may take longer to start, and
        # its neighbours' first exchange would count the difference
        torch.distributed.barrier()
        t0 = time.perf_counter()
        outs = [o.cpu().numpy() for o in _program(parts, comm, clock)]
        return outs, time.perf_counter() - t0

    if profile:
        # the device's activity only: recording every host op as well made
        # a profiled 1000-step run take ~25 s to collect on an H100 host
        from torch.profiler import ProfilerActivity
        act = (ProfilerActivity.CUDA if ctx.device.type == "cuda"
               else ProfilerActivity.CPU)
        with torch.profiler.profile(activities=[act]) as prof:
            outs, wall = timed_run()
    else:
        outs, wall = timed_run()
    stats = dict(comm.stats, **clock, wall_s=wall,
                 launches=_build.launch_counts(before))
    if prof is not None:
        stats["profile"] = _device_summary(prof)
    return outs, stats


def _device_summary(prof) -> dict:
    """What a profiled run's device did: kernel and copy time and counts."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith("Memcpy")]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    return {"kernels": len(kernels),
            "kernel_s": sum(e.time_range.elapsed_us() for e in kernels) / 1e6,
            "copies": len(copies),
            "copy_s": sum(e.time_range.elapsed_us() for e in copies) / 1e6}


def launch_counts(ctx: R.RankContext) -> dict:
    """This rank's launches by kernel (``kernels._build.launch_counts``)."""
    return _build.launch_counts()


def reset_launch_counts(ctx: R.RankContext) -> None:
    _build.reset_launches()


def rank_memory(ctx: R.RankContext) -> dict:
    """This rank's device memory: what its allocator holds, and the card's
    free and total bytes as the rank sees them."""
    if ctx.device.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(ctx.device)
    return {"allocated": torch.cuda.memory_allocated(ctx.device),
            "reserved": torch.cuda.memory_reserved(ctx.device),
            "free": free, "total": total}


# ---------------------------------------------------------- controller
class PlannedSPMDBackend(Backend):
    """Columns blocked over rank processes; movement per a ``CommPlan``.

    Ragged widths are handled by the plan's dead-column padding, so any
    graph width runs on any rank count (including width < ranks).
    """

    axis = AXIS
    prefer_ring = False

    def __init__(self, comm: str = "auto", comm_overlap: bool = False,
                 ranks: Optional[int] = None, device: Optional[str] = None):
        if comm not in CC.MODES:
            raise ValueError(f"unknown comm mode {comm!r}; known: {CC.MODES}")
        self.device = resolve_device(device)
        if ranks is None:
            ranks = (torch.cuda.device_count()
                     if self.device.type == "cuda" else 1)
        if isinstance(ranks, bool) or not isinstance(ranks, int) \
                or ranks < 1:
            raise ValueError(f"ranks must be a positive int, got {ranks!r}")
        self.comm = comm
        self.comm_overlap = bool(comm_overlap)
        self.ndev = ranks

    def plan(self, graph: TaskGraph) -> CC.CommPlan:
        return CC.plan_comm(graph, self.ndev, self.axis, comm=self.comm,
                            prefer_ring=self.prefer_ring,
                            comm_overlap=self.comm_overlap)

    def pool(self) -> R.RankPool:
        """The ranks, started on first use.  On a card the kernels are
        built here first, so N ranks do not run N builds."""
        if self.device.type == "cuda":
            _build.library()
        return R.get_pool(self.ndev, self.device)

    def _stage(self, graphs: Sequence[TaskGraph]) -> Callable:
        """Stage one program (the graphs in lockstep) on the ranks; returns
        ``run(profile=False) -> (outputs, each rank's stats)``."""
        plans = [self.plan(g) for g in graphs]
        pool = self.pool()
        job = pool.new_job()
        pool.map(_rank_stage, [
            (job, [(g, p.without_tables(), *p.shard(r))
                   for g, p in zip(graphs, plans)])
            for r in range(self.ndev)])

        def run(profile: bool = False):
            res = pool.call(_rank_run, job, profile)
            outs = [p.trim(np.concatenate([blocks[k] for blocks, _ in res]))
                    for k, p in enumerate(plans)]
            return outs, [stats for _, stats in res]

        weakref.finalize(run, pool.drop_job, job)
        return run

    @staticmethod
    def _runner(runs: List[Callable]):
        def runner() -> List[np.ndarray]:
            outs, stats = [], []
            for run in runs:
                o, s = run()
                outs += o
                stats.append(s)
            runner.stats = stats
            return outs

        runner.profile = lambda: [run(profile=True)[1] for run in runs]
        return runner

    def lowered_programs(self, graphs: Sequence[TaskGraph]
                         ) -> List[Callable[[], object]]:
        """Rank 0's program for each program ``run_many`` runs, staged in
        this process; a call runs it on a fake process group of ``ranks``
        ranks (``launch.dryrun.fake_group``): its exchanges are issued and
        move nothing.  Every rank runs the same program on its own
        columns."""
        graphs = list(graphs)
        combined = len(graphs) >= 2 and len({g.height for g in graphs}) == 1
        programs = []
        for group in ([graphs] if combined else [[g] for g in graphs]):
            ctx = R.RankContext(0, self.ndev, self.device,
                                R.DEFAULT_TIMEOUT_S)
            _rank_stage(ctx, 0, [(g, p.without_tables(), *p.shard(0))
                                 for g, p in ((g, self.plan(g))
                                              for g in group)])
            programs.append(functools.partial(self._fake_run, ctx))
        return programs

    def _fake_run(self, ctx: R.RankContext) -> List[torch.Tensor]:
        from ..launch.dryrun import fake_group

        with fake_group(self.ndev):
            return _program(ctx.jobs[0], ctx.comm, {"body_s": 0.0})

    def prepare(self, graphs: Sequence[TaskGraph]):
        """Each graph its own program, run one after another."""
        return self._runner([self._stage([g]) for g in graphs])

    def prepare_many(self, graphs: Sequence[TaskGraph]):
        """One program advancing every graph's timestep t in the same loop
        step (one graph's exchange in flight while another's body runs);
        graphs of different heights fall back to ``prepare``."""
        graphs = list(graphs)
        if len(graphs) < 2 or len({g.height for g in graphs}) != 1:
            return self.prepare(graphs)
        return self._runner([self._stage(graphs)])


@register_backend("torch-csp")
class CSPBackend(PlannedSPMDBackend):
    paradigm = "explicit SPMD message passing (MPI CSP analogue)"
