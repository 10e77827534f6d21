"""Wavefront scheduling models: static column ownership vs work stealing.

The paper's load-imbalance study (§V-G) separates runtimes by *how tasks
are laid over workers*: statically-partitioned systems (MPI ranks, BSP)
pay the slowest worker's column block every wavefront, while dynamically-
scheduled systems (work stealing, task pools) re-pack a wavefront's tasks
greedily and recover most of the imbalance.

This module is the pure (numpy-only) form of both policies, a copy of
``repro.core.schedule`` shared by

* ``backends.host.HostBackend`` (``torch-host[schedule=steal]``) — the
  *claim order* a work-stealing executor dispatches a wavefront in, and
* ``bench.timers.SyntheticTimer`` (``workers > 1``) — the deterministic
  per-wavefront makespan the fake clock charges for each policy,

so the executor and the timing model cannot drift apart.

Policies
--------

``"serial"``   one worker: makespan = sum of task costs.
``"static"``   columns blocked over workers exactly like
               ``dist.collectives`` blocks them over ranks (each worker
               owns ``ceil(n / workers)`` consecutive columns); makespan
               is the slowest worker's block sum.
``"steal"``    greedy claiming: whenever a worker goes idle it claims the
               longest unclaimed task of the wavefront (LPT list
               scheduling); makespan is the last worker's finish time.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

POLICIES = ("serial", "static", "steal")


def static_owners(ncols: int, workers: int) -> np.ndarray:
    """Worker id owning each column under blocked static partitioning.

    Matches the comm-plan layout: worker ``w`` owns columns
    ``[w * local, (w + 1) * local)`` with ``local = ceil(ncols/workers)``.
    """
    if ncols < 1 or workers < 1:
        raise ValueError(f"need ncols >= 1 and workers >= 1, "
                         f"got {ncols}, {workers}")
    local = -(-ncols // workers)
    return np.arange(ncols) // local


def steal_schedule(costs, workers: int) -> Tuple[List[int], np.ndarray, float]:
    """Greedy (LPT) claim schedule for one wavefront.

    Returns ``(order, start, makespan)``: ``order`` is the task-index
    sequence in claim order (ties broken by column id — deterministic),
    ``start`` the per-task start time, ``makespan`` the last finish.
    Each task appears in ``order`` exactly once.
    """
    costs = np.asarray(costs, dtype=np.float64)
    if costs.ndim != 1 or costs.size < 1:
        raise ValueError("costs must be a non-empty 1-D array")
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    # longest task first; lexsort's last key dominates, so sort by
    # (-cost, column) for a deterministic claim sequence
    claim = np.lexsort((np.arange(costs.size), -costs))
    free = np.zeros(workers, dtype=np.float64)
    start = np.empty(costs.size, dtype=np.float64)
    for i in claim:
        w = int(np.argmin(free))
        start[i] = free[w]
        free[w] += costs[i]
    order = [int(i) for i in claim]
    return order, start, float(free.max())


def wavefront_makespan(costs, workers: int, policy: str) -> float:
    """Seconds one wavefront takes under ``policy`` with ``workers``."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
    costs = np.asarray(costs, dtype=np.float64)
    if workers <= 1 or policy == "serial":
        return float(costs.sum())
    if policy == "static":
        owners = static_owners(costs.size, workers)
        return float(max(costs[owners == w].sum()
                         for w in range(workers)))
    return steal_schedule(costs, workers)[2]
