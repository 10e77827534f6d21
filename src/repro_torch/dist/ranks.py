"""Rank processes: the port's counterpart of a mesh axis plus ``shard_map``.

The reference runs a rank program on every device of a mesh axis inside
``shard_map``, and its collectives (``ppermute``, ``all_gather``,
``all_to_all``) find the other ranks through the axis name.  Here a rank is
a process: ``RankPool`` starts N of them ("spawn": forking a process that
has started CUDA is unsafe), each joins one gloo process group over a
localhost ``TCPStore`` that the controller hosts, and the controller — the
process that built the backend, which is not a rank — drives them over a
pipe each.  A call sends every rank a module-level function and its own
arguments (the controller hands each rank its slice of the plan, as
``in_specs`` would) and collects one result a rank in rank order.

``RankComm`` is a rank's communicator, what the reference's implicit axis
stands for: ``CommPlan.exchange`` and the one-sided push take it.  Every
op moves its tensors through host buffers — wait for the device, copy
the rows out (pinned memory on a card), run the gloo op, copy the rows
back — on the CPU as on a card, so each op has one path and its copies
are counted.  NCCL would refuse two ranks on one card ("duplicate GPU"),
and gloo takes no CUDA tensors; this is MPI without a CUDA-aware
transport.  ``RankComm.stats`` splits a rank's host time into waiting
for the device, staging copies and gloo calls.

Every wait has a timeout: the gloo group's (``timeout`` seconds) inside a
rank, and the controller's on each call.  A rank that raises sends its
traceback, and the controller raises ``RankError`` with it at once and
closes the pool, so a failure never hangs the caller.  ``get_pool`` keeps
one pool per ``(ranks, device)`` and process, and every pool is closed at
exit.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import itertools
import os
import socket
import time
import traceback
from multiprocessing import connection, get_context
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0  # a call, and every gloo op inside a rank
START_TIMEOUT_S = 300.0  # the ranks' start: import torch, reach the card


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class RankError(RuntimeError):
    """A rank raised (its traceback in the message), died or timed out."""


# ---------------------------------------------------------------- ranks
def _same(value):
    return value


class Pending:
    """An exchange in flight: ``wait()`` completes its gloo works, copies
    the received host buffers to the device and returns
    ``finish(received)``."""

    def __init__(self, comm: "RankComm", works: list, host_recvs: list,
                 finish: Callable[[List[torch.Tensor]], object]):
        self.comm, self.works, self.host_recvs = comm, works, host_recvs
        self.finish = finish

    def wait(self):
        comm = self.comm
        t0 = time.perf_counter()
        for w in self.works:
            w.wait(comm.timeout)
        t1 = time.perf_counter()
        got = [comm._to_device(h) for h in self.host_recvs]
        comm.stats["gloo_s"] += t1 - t0
        comm.stats["stage_s"] += time.perf_counter() - t1
        return self.finish(got)

    def then(self, fn: Callable) -> "Pending":
        """This exchange with ``fn`` applied to its result."""
        finish = self.finish
        return Pending(self.comm, self.works, self.host_recvs,
                       lambda got: fn(finish(got)))


class Done:
    """An exchange that moved nothing: ``wait()`` returns its value."""

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value

    def then(self, fn: Callable) -> "Done":
        return Done(fn(self.value))


class RankComm:
    """The calling rank's communicator: gloo ops staged through host
    buffers.

    ``p2p`` posts every receive before any send (each pair and direction
    of a ppermute, and each offset of a one-sided put, has its own tag, so
    no two messages in flight between two ranks share one);
    ``all_gather`` is tiled in rank order; ``all_to_all`` exchanges the
    ``(ndev, ...)`` slabs of its input; ``all_reduce`` sums (``psum``) or
    takes the maximum (``pmax``).  Each returns
    a ``Pending``.  A communicator over a subgroup (``grid``'s axes) runs
    the collectives on it; ``p2p`` takes the pool's rank numbers.
    Before it posts anything an op waits for the device (timed as
    ``sync_s``): the rows it sends come from the body just issued, and a
    host buffer it receives into may still feed an earlier copy to the
    device.  ``stats`` accumulates over the rank's life; ``reset_stats``
    zeroes it.
    """

    STATS = ("sync_s", "stage_s", "gloo_s", "ops", "copies", "bytes",
             "a2a_bytes")

    def __init__(self, rank: int, size: int, device: torch.device,
                 timeout_s: float = DEFAULT_TIMEOUT_S, group=None):
        self.rank, self.size, self.device = rank, size, device
        self.group = group  # None: every rank of the pool
        self.timeout_s = timeout_s
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self._buffers: Dict[tuple, torch.Tensor] = {}
        self._constants: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
        self._grids: Dict[Tuple[int, int], "GridComm"] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats = {k: 0.0 if k.endswith("_s") else 0 for k in self.STATS}

    def constant(self, array: np.ndarray) -> torch.Tensor:
        """``array`` on the device, uploaded once (the cache holds the
        array, so its id stays its own)."""
        hit = self._constants.get(id(array))
        if hit is None:
            hit = (array, torch.as_tensor(array, device=self.device))
            self._constants[id(array)] = hit
        return hit[1]

    def _buffer(self, key: tuple, like: torch.Tensor) -> torch.Tensor:
        shape = tuple(like.shape)
        buf = self._buffers.get((key, shape, like.dtype))
        if buf is None:
            buf = torch.empty(shape, dtype=like.dtype,
                              pin_memory=self.device.type == "cuda")
            self._buffers[(key, shape, like.dtype)] = buf
        return buf

    def _sync(self) -> None:
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            torch.cuda.current_stream(self.device).synchronize()
            self.stats["sync_s"] += time.perf_counter() - t0

    def _to_host(self, x: torch.Tensor, key: tuple) -> torch.Tensor:
        buf = self._buffer(key, x)
        buf.copy_(x)
        self.stats["copies"] += 1
        self.stats["bytes"] += buf.numel() * buf.element_size()
        return buf

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        self.stats["copies"] += 1
        self.stats["bytes"] += host.numel() * host.element_size()
        if self.device.type == "cpu":
            return host.clone()
        return host.to(self.device, non_blocking=True)

    def _post(self, outgoing: Sequence[Tuple[torch.Tensor, tuple]],
              post: Callable[[List[torch.Tensor]], list],
              hosts: List[torch.Tensor], finish: Callable) -> Pending:
        """Wait for the device, copy ``outgoing`` (rows, buffer key) to
        host buffers, and post the gloo works ``post`` returns for them;
        the receives fill ``hosts``."""
        self._sync()
        t0 = time.perf_counter()
        outs = [self._to_host(x, key) for x, key in outgoing]
        t1 = time.perf_counter()
        works = post(outs)
        self.stats["ops"] += len(works)
        self.stats["stage_s"] += t1 - t0
        self.stats["gloo_s"] += time.perf_counter() - t1
        return Pending(self, works, hosts, finish)

    def p2p(self, sends: Sequence[Tuple[torch.Tensor, int, int]],
            recvs: Sequence[Tuple[torch.Tensor, int, int]],
            finish: Callable = list) -> Pending:
        """Point-to-point: ``sends`` are ``(rows, dst, tag)``, ``recvs``
        ``(like, src, tag)`` with ``like`` giving the shape and type; the
        received rows reach ``finish`` in the order of ``recvs``."""
        hosts = [self._buffer(("recv", src, tag), like)
                 for like, src, tag in recvs]

        def post(outs):
            works = [dist.irecv(h, src, tag=tag)
                     for h, (_, src, tag) in zip(hosts, recvs)]
            return works + [dist.isend(h, dst, tag=tag)
                            for h, (_, dst, tag) in zip(outs, sends)]

        return self._post([(x, ("send", dst, tag)) for x, dst, tag in sends],
                          post, hosts, finish)

    def all_gather(self, x: torch.Tensor, tag: int,
                   finish: Callable = _same) -> Pending:
        """Every rank's ``x`` concatenated in rank order (tiled)."""
        parts = [self._buffer(("gather", tag, r), x) for r in range(self.size)]

        def post(outs):
            return [dist.all_gather(parts, outs[0], group=self.group,
                                    async_op=True)]

        return self._post([(x, ("gather-in", tag))], post, parts,
                          lambda got: finish(torch.cat(got)))

    def all_to_all(self, x: torch.Tensor, tag: int,
                   finish: Callable = _same) -> Pending:
        """Slab ``s`` of ``x`` (``(ndev, ...)``) goes to rank ``s``; slab
        ``s`` of the result came from rank ``s``.  ``a2a_bytes`` counts
        the bytes of ``x``, the slab a rank keeps included."""
        got = self._buffer(("a2a", tag), x)
        self.stats["a2a_bytes"] += x.numel() * x.element_size()

        def post(outs):
            return [dist.all_to_all_single(got, outs[0], group=self.group,
                                           async_op=True)]

        return self._post([(x, ("a2a-in", tag))], post, [got],
                          lambda got: finish(got[0]))

    def all_reduce(self, x: torch.Tensor, tag: int,
                   finish: Callable = _same, op: str = "sum") -> Pending:
        """The elementwise sum (``op="sum"``, ``psum``) or maximum
        (``"max"``, ``pmax``) of every rank's ``x``."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown all_reduce op {op!r}; known: "
                             f"{sorted(_REDUCE_OPS)}")
        buf = self._buffer((op, tag), x)  # reduced in place

        def post(outs):
            return [dist.all_reduce(outs[0], op=_REDUCE_OPS[op],
                                    group=self.group, async_op=True)]

        return self._post([(x, (op, tag))], post, [buf],
                          lambda got: finish(got[0]))

    def grid(self, data: int, model: int) -> "GridComm":
        """Communicators over the two axes of a ``(data, model)`` grid of
        this communicator's ranks (what the mesh-axis names stand for in
        the reference): rank ``r`` sits at ``(r // model, r % model)``;
        the ``data`` axis joins the ranks of one model index, the
        ``model`` axis those of one data index.  The gloo subgroups are
        made collectively and kept, so every rank asks for the same grids
        in the same order (a rank function the controller runs on all of
        them does)."""
        if data * model != self.size or min(data, model) < 1:
            raise ValueError(f"a ({data}, {model}) grid over {self.size} "
                             f"ranks")
        hit = self._grids.get((data, model))
        if hit is None:
            # the default group's backend: gloo in a pool, fake in a dry
            # run (launch.dryrun.fake_group)
            kw = dict(timeout=self.timeout, backend=dist.get_backend())
            dgroup, _ = dist.new_subgroups_by_enumeration(
                [[i * model + m for i in range(data)] for m in range(model)],
                **kw)
            mgroup, _ = dist.new_subgroups_by_enumeration(
                [[i * model + m for m in range(model)] for i in range(data)],
                **kw)
            di, mi = divmod(self.rank, model)
            hit = GridComm(
                self,
                RankComm(di, data, self.device, self.timeout_s, dgroup),
                RankComm(mi, model, self.device, self.timeout_s, mgroup))
            self._grids[(data, model)] = hit
        return hit


@dataclasses.dataclass(frozen=True)
class GridComm:
    """A rank's communicators on a ``(data, model)`` grid: ``world`` over
    every rank, ``data`` and ``model`` over its two axes (``.rank`` is the
    rank's index on that axis, ``.size`` the axis size)."""
    world: RankComm
    data: RankComm
    model: RankComm


class RankContext:
    """What a rank's functions see: its communicator, device, the state
    the controller's calls leave on it (``jobs``, freed by job id) and a
    cache for the rank's life."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 timeout_s: float):
        self.rank, self.size, self.device = rank, size, device
        self.comm = RankComm(rank, size, device, timeout_s)
        self.jobs: Dict[int, object] = {}
        self.cache: Dict[str, object] = {}


def _rank_main(rank: int, size: int, port: int, device: str, conn,
               timeout_s: float) -> None:
    """A rank's life: join the gloo group, then run the controller's calls
    until it says stop or its pipe closes."""
    try:
        if "GLOO_SOCKET_IFNAME" not in os.environ and "lo" in {
                name for _, name in socket.if_nameindex()}:
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"  # ranks share one host
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=timeout)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=size, timeout=timeout)
        ctx = RankContext(rank, size, dev, timeout_s)
        conn.send(("ok", {"pid": os.getpid(),
                          "affinity": sorted(os.sched_getaffinity(0))}))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg is None:
                break
            fn, args, drops = msg
            for job in drops:
                ctx.jobs.pop(job, None)
            try:
                reply = ("ok", fn(ctx, *args))
            except Exception:
                reply = ("err", traceback.format_exc())
            conn.send(reply)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- controller
class RankPool:
    """N rank processes on ``device`` and a pipe to each.

    ``map(fn, args)`` runs ``fn(ctx, *args[r])`` on rank r, ``call(fn,
    *args)`` the same arguments on every rank; both return the results in
    rank order.  ``info`` holds each rank's pid and CPU affinity.
    ``device`` is where the ranks run: every rank on it, except that a bare
    ``cuda`` spreads rank r over card ``r % device_count``.
    """

    def __init__(self, ranks: int, device: torch.device,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if ranks < 1:
            raise ValueError(f"need at least one rank, got {ranks}")
        self.ranks, self.device, self.timeout_s = ranks, device, timeout_s
        self._jobs = itertools.count()
        self._drops: List[int] = []
        self._store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                    wait_for_workers=False,
                                    timeout=datetime.timedelta(
                                        seconds=START_TIMEOUT_S))
        mp = get_context("spawn")
        self._conns, self._procs = [], []
        for r in range(ranks):
            mine, theirs = mp.Pipe()
            proc = mp.Process(
                target=_rank_main, daemon=True,
                args=(r, ranks, self._store.port, self._rank_device(r),
                      theirs, timeout_s))
            proc.start()
            theirs.close()
            self._conns.append(mine)
            self._procs.append(proc)
        self.info = self._collect(START_TIMEOUT_S)

    def _rank_device(self, r: int) -> str:
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            return f"cuda:{r % torch.cuda.device_count()}"
        return str(dev)

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def new_job(self) -> int:
        """A fresh job id for state a call leaves on the ranks."""
        return next(self._jobs)

    def drop_job(self, job: int) -> None:
        """Free a job's state on the ranks with the next call (safe from a
        finalizer: it sends nothing)."""
        self._drops.append(job)

    def _collect(self, timeout_s: float) -> list:
        """One reply a rank, in rank order; raise at the first error, on a
        dead rank or when ``timeout_s`` passes."""
        results: List[object] = [None] * self.ranks
        waiting = dict(zip(self._conns, range(self.ranks)))
        deadline = time.monotonic() + timeout_s
        while waiting:
            left = deadline - time.monotonic()
            ready = connection.wait(list(waiting), timeout=max(left, 0))
            if not ready:
                self.close(graceful=False)
                raise RankError(f"ranks {sorted(waiting.values())} did not "
                                f"answer within {timeout_s} s")
            for conn in ready:
                r = waiting.pop(conn)
                try:
                    status, value = conn.recv()
                except (EOFError, OSError):
                    proc = self._procs[r]
                    self.close(graceful=False)
                    raise RankError(f"rank {r} died (exit code "
                                    f"{proc.exitcode})")
                if status == "err":
                    self.close(graceful=False)
                    raise RankError(f"rank {r} raised:\n{value}")
                results[r] = value
        return results

    def map(self, fn: Callable, args: Sequence[tuple],
            timeout_s: Optional[float] = None) -> list:
        if not self.alive:
            raise RankError("the rank pool is closed")
        if len(args) != self.ranks:
            raise ValueError(f"{len(args)} argument tuples for "
                             f"{self.ranks} ranks")
        drops, self._drops = self._drops, []
        for conn, a in zip(self._conns, args):
            conn.send((fn, tuple(a), drops))
        return self._collect(self.timeout_s if timeout_s is None
                             else timeout_s)

    def call(self, fn: Callable, *args, timeout_s: Optional[float] = None):
        return self.map(fn, [args] * self.ranks, timeout_s)

    def close(self, graceful: bool = True) -> None:
        """Stop every rank: ask (``graceful``), then terminate, then kill.
        After a failure the other ranks may wait in gloo for the one that
        failed, so they are terminated at once."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            if graceful:
                p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        for key, pool in list(_POOLS.items()):
            if pool is self:
                del _POOLS[key]


_POOLS: Dict[Tuple[int, str], RankPool] = {}


def get_pool(ranks: int, device: torch.device) -> RankPool:
    """The process's pool of ``ranks`` ranks on ``device`` (started on
    first use, started again after a failure closed it)."""
    key = (ranks, str(device))
    pool = _POOLS.get(key)
    if pool is None or not pool.alive:
        if pool is not None:
            pool.close()
        pool = _POOLS[key] = RankPool(ranks, device)
    return pool


@atexit.register
def close_pools() -> None:
    """Close every cached pool."""
    for pool in list(_POOLS.values()):
        pool.close()
