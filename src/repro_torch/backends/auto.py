"""``get_backend("torch-auto")``: table-driven backend selection.

Counterpart of the reference's ``auto`` planner, under a port name of its
own.  The paper's core finding is that no single runtime wins everywhere
— the fastest system flips with task granularity, dependence pattern,
payload size and node count (§V).  This backend closes the loop: at
dispatch time it reduces the workload to its tuning key
(``bench.tuner.graphs_cutout``), looks the key up in the committed tuning
table (``bench/tuning/TUNE_torch.json``, regenerated with ``python -m
repro_torch.bench.run --tune``), and delegates every ``prepare`` /
``prepare_many`` call to the winning backend.

Resolution is a pure table lookup — **zero per-dispatch measurement** —
with deterministic nearest-key semantics on a miss (exact key, then
nearest bucket within the same graph shape, then nearest same-pattern
key; see ``TuningTable.resolve_entry``) and a documented fallback
(``tuner.DEFAULT_FALLBACK``) when the table has never seen the pattern
or there is no table at all.  Because execution is pure delegation,
``torch-auto`` is bit-exact with whatever backend it resolves to.  A
winner that fails to build or run raises; nothing falls back to another
backend then.

Options (the ``torch-auto[key=value]`` spec grammar):

``table=<path>``
    An explicit ``TUNE_*.json`` to consult.  Must exist and validate —
    pointing at a missing/corrupt table is a configuration error, not a
    silent fallback.  Default: the committed table (absent is fine; every
    dispatch then uses the fallback).
``timer=<name>``
    Which timer the consulted table must have been tuned on (default
    ``synthetic``).  A mismatched table is refused — wall-clock winners
    and fake-clock winners are different claims.
``fallback=<spec>``
    What a table miss dispatches (default ``torch-scan``).
``device=<device>``
    Where the winner runs, passed on to it: ``cuda`` unless the spec asks
    (``torch-auto[device=cpu]``); with no card and no device asked for,
    construction raises, as for every port backend.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..bench.tuner import (AUTO, DEFAULT_FALLBACK, check_table_timer,
                           graphs_cutout, load_tuning_table)
from ..core.graph import TaskGraph
from .base import (Backend, backend_names, get_backend, parse_backend_spec,
                   register_backend, resolve_device)


@register_backend(AUTO)
class AutoBackend(Backend):
    """Delegates execution to the tuning table's winner for the workload.

    The planner in front of the paper's 'n systems': holds no execution
    machinery of its own, so its outputs are its winner's by construction.
    """

    paradigm = "self-tuning planner (table-driven dispatch)"

    def __init__(self, table: Optional[str] = None,
                 fallback: Optional[str] = None,
                 timer: str = "synthetic",
                 device: Optional[str] = None):
        if fallback is None:
            fallback = DEFAULT_FALLBACK
        base, _ = parse_backend_spec(fallback)
        if base == AUTO:
            raise ValueError(f"backend {AUTO!r} cannot fall back to itself")
        if base not in backend_names():
            raise ValueError(
                f"{AUTO} fallback names unknown backend {base!r}; "
                f"known: {backend_names()}")
        self.fallback = fallback
        self.timer = timer
        self.device = device
        self._ndev = (torch.cuda.device_count()
                      if resolve_device(device).type == "cuda" else 1)
        # eager load: an explicit table= that is missing or corrupt is a
        # configuration error and must fail at get_backend() time, not
        # on the first dispatch
        self.table = load_tuning_table(table)
        check_table_timer(self.table, timer)
        self._delegates: Dict[str, Backend] = {}

    # -- resolution (pure lookup, nothing measured) ----------------------
    def resolve_spec(self, graphs: Sequence[TaskGraph]) -> str:
        """The concrete backend spec this workload dispatches to."""
        if self.table is None:
            return self.fallback
        winner = self.table.resolve(graphs_cutout(graphs, ndev=self._ndev))
        return winner if winner is not None else self.fallback

    def delegate(self, graphs: Sequence[TaskGraph]) -> Backend:
        """The (cached) backend instance the workload resolves to."""
        spec = self.resolve_spec(graphs)
        if spec not in self._delegates:
            kw = {} if self.device is None else {"device": self.device}
            self._delegates[spec] = get_backend(spec, **kw)
        return self._delegates[spec]

    # -- execution: pure delegation --------------------------------------
    def prepare(self, graphs: Sequence[TaskGraph]
                ) -> Callable[[], List[np.ndarray]]:
        return self.delegate(graphs).prepare(graphs)

    def lowered_programs(self, graphs: Sequence[TaskGraph]):
        return self.delegate(graphs).lowered_programs(graphs)

    def prepare_many(self, graphs: Sequence[TaskGraph]
                     ) -> Callable[[], List[np.ndarray]]:
        return self.delegate(graphs).prepare_many(graphs)
