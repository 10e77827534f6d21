"""Scan backend ``torch-scan``: an eager loop over timesteps, columns vectorized.

Counterpart of ``xla-scan``, and the analogue of the paper's vectorized
on-node runtimes (OpenMP forall / MPI+OpenMP inner loop): one timestep
body re-issued H times.  PyTorch runs it eagerly, so every timestep pays
the launch cost of each of its operations; on the card the task kernel of
a timestep is one launch of K1 (compute) or K2 (memory).
"""
from __future__ import annotations

from typing import List

import torch

from ..core.graph import TaskGraph
from . import body
from .base import StackedProgramBackend, register_backend


def _scan(graph: TaskGraph, mats: torch.Tensor, iters: torch.Tensor,
          lead: tuple) -> torch.Tensor:
    """Run all timesteps; ``mats`` (H, *lead, W, W), ``iters`` (H, *lead, W)."""
    payload = torch.zeros(*lead, graph.width, graph.payload_elems,
                          dtype=torch.float32, device=mats.device)
    cols = torch.arange(graph.width, device=mats.device)
    for t in range(graph.height):
        payload = body.timestep(graph, t, payload, mats[t], iters[t], cols)
    return payload


@register_backend("torch-scan")
class ScanBackend(StackedProgramBackend):
    paradigm = "eager timestep loop (OpenMP-forall analogue)"

    def _build(self, graphs: List[TaskGraph]):
        """Each graph scanned in turn (independent execution)."""
        staged = []
        for g in graphs:
            mats, iters = body.graph_static_inputs(g)
            staged.append((g, torch.as_tensor(mats, device=self.device),
                           torch.as_tensor(iters, device=self.device)))

        def program() -> List[torch.Tensor]:
            return [_scan(g, m, i, ()) for g, m, i in staged]

        return program

    def _build_stacked(self, graphs: List[TaskGraph]):
        """One loop over a stacked (graph, width) payload — the concurrent
        form: all graphs advance in the same timestep (paper Fig 9d).
        None if the graphs cannot share a body."""
        if not body.stackable(graphs):
            return None
        g0 = graphs[0]
        mats, iters = body.stacked_static_inputs(graphs)
        mats_t = torch.as_tensor(mats.transpose(1, 0, 2, 3).copy(),
                                 device=self.device)  # (H, G, W, W)
        iters_t = torch.as_tensor(iters.transpose(1, 0, 2).copy(),
                                  device=self.device)  # (H, G, W)
        return lambda: _scan(g0, mats_t, iters_t, (len(graphs),))
