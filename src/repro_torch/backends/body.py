"""Shared PyTorch task body used by every backend (the O(m+n) trick).

Counterpart of ``repro.backends.body``.  All backends execute the *same*
width-vectorized task body; they differ only in how timesteps are
scheduled.  Every function takes optional leading dimensions, so a stack
of G graphs is one ``(G, W, ...)`` batch written out, not a ``vmap``.

Numerical contract (must match core.kernel_ref bitwise for elementwise
kernels): the checksums are exact int64 math — 2^20 divides 2^32, so the
reference's ``% 2^32 % 2^20`` is ``& (2^20 - 1)`` — and the dependency
combine is an int64 product-sum, never a float matmul (a sum of up to W
values below 2^20 is not exact in f32).  The kernel state is seeded with
``start + acc * 2**-46`` in float32, which rounds to exactly ``start``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import CHECKSUM_MOD, TaskGraph
from ..core.kernel_spec import KernelSpec
from ..kernels import bodies

_MASK = CHECKSUM_MOD - 1


def checksum_vec(t, cols: torch.Tensor) -> torch.Tensor:
    """int64 base checksums; match TaskGraph.checksum exactly."""
    return (cols.to(torch.int64) * 40503 + int(t) * 2654435761) & _MASK


def combine_acc(dep_matrix: torch.Tensor,
                prev_combined: torch.Tensor) -> torch.Tensor:
    """acc_i = sum_j M[i,j] * combined_j  (mod 2^20), exact int64 math.

    ``dep_matrix`` is ``(..., W, W_ctx)``, ``prev_combined`` ``(..., W_ctx)``.
    """
    prod = dep_matrix.to(torch.int64) * prev_combined.unsqueeze(-2)
    return prod.sum(-1) % CHECKSUM_MOD


def run_kernel_vec(kernel: KernelSpec, iters_per_col: torch.Tensor,
                   acc: torch.Tensor, max_iters: int,
                   mxu_w: Optional[torch.Tensor] = None,
                   dynamic: bool = False) -> torch.Tensor:
    """Vectorized kernel over the columns of ``acc``'s shape; f32 results.

    Thin rank adapter over ``kernels.bodies.run_kernel_columns``: leading
    dimensions fold into the column axis, so a graph stack runs as one
    launch per timestep.  ``mxu_w`` is the compute_mxu weight staged on
    ``acc``'s device (uploaded from the host on every call when None).
    ``dynamic`` selects the loop's dynamic mode, ``max_iters`` then being
    the trip count (per-task dispatch: the task's own iterations).
    """
    seed = acc.to(torch.float32) * bodies.FOLD_BLOCK
    out = bodies.run_kernel_columns(kernel, iters_per_col.reshape(-1, 1),
                                    seed.reshape(-1, 1), max_iters,
                                    dynamic=dynamic, mxu_w=mxu_w)
    return out.reshape(acc.shape)


def make_payload(t, cols: torch.Tensor, base: torch.Tensor,
                 combined: torch.Tensor, result: torch.Tensor,
                 payload_elems: int) -> torch.Tensor:
    """Assemble the (..., n, P) payload rows for global column ids ``cols``."""
    lead = result.shape
    head = torch.stack(
        [torch.full(lead, float(t), dtype=torch.float32,
                    device=result.device),
         cols.to(torch.float32).expand(lead), base.to(torch.float32),
         combined.to(torch.float32), result],
        dim=-1,
    )
    if payload_elems > 5:
        ballast = result.unsqueeze(-1).expand(*lead, payload_elems - 5)
        return torch.cat([head, ballast], dim=-1)
    return head


def timestep(graph: TaskGraph, t, prev_payload: torch.Tensor,
             dep_matrix: torch.Tensor, iters_per_col: torch.Tensor,
             cols: Optional[torch.Tensor] = None,
             mxu_w: Optional[torch.Tensor] = None, dynamic: bool = False,
             trip: Optional[int] = None) -> torch.Tensor:
    """Execute one timestep of ``graph``, vectorized over a column block.

    prev_payload: (..., W_ctx, P) f32 from t-1.
    dep_matrix:   (..., n, W_ctx) uint8 — rows select deps within the context.
    iters_per_col:(..., n) int32 — per-task durations (imbalance-aware).
    cols:         (n,) global column ids (defaults to arange(W_ctx)).
    mxu_w:        the staged compute_mxu weight (see ``run_kernel_vec``).
    dynamic:      the kernel loop's dynamic mode, ``trip`` its trip count:
                  ``max(iters_per_col)`` as a host int the caller holds
                  (the reference traces ``jnp.max``; reading a device
                  tensor here would sync).  Values are bitwise the same.
    Returns the new (..., n, P) payload block.
    """
    if dynamic and trip is None:
        raise ValueError("the dynamic mode needs its trip count as a host "
                         "int")
    if cols is None:
        cols = torch.arange(graph.width, device=prev_payload.device)
    prev_combined = prev_payload[..., 3].to(torch.int64)
    acc = combine_acc(dep_matrix, prev_combined)
    base = checksum_vec(t, cols).expand(acc.shape)
    combined = (base + acc) % CHECKSUM_MOD
    result = run_kernel_vec(graph.kernel, iters_per_col, acc,
                            trip if dynamic else graph.kernel.iterations,
                            mxu_w, dynamic)
    return make_payload(t, cols, base, combined, result, graph.payload_elems)


def graph_static_inputs(graph: TaskGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side constants: dep matrices (H,W,W) u8 and iteration counts (H,W) i32."""
    mats = graph.dependence_matrices().astype(np.uint8)
    iters = np.array(
        [[graph.task_iterations(t, i) for i in range(graph.width)]
         for t in range(graph.height)],
        dtype=np.int32,
    )
    return mats, iters


def stackable(graphs: Sequence[TaskGraph]) -> bool:
    """Can these graphs share one vectorized program with a graph axis?

    The task body closes over shape (width/payload) and kernel spec; the
    dependence matrices and iteration counts are data.  So graphs stack iff
    those static parts agree — patterns may differ freely.
    """
    if len(graphs) < 2:
        return False
    g0 = graphs[0]
    return all(
        g.width == g0.width
        and g.height == g0.height
        and g.output_bytes == g0.output_bytes
        and g.kernel == g0.kernel
        for g in graphs[1:]
    )


def stacked_static_inputs(
    graphs: Sequence[TaskGraph],
) -> Tuple[np.ndarray, np.ndarray]:
    """Static inputs with a leading graph axis: (G,H,W,W) u8, (G,H,W) i32."""
    per_graph = [graph_static_inputs(g) for g in graphs]
    mats = np.stack([m for m, _ in per_graph])
    iters = np.stack([i for _, i in per_graph])
    return mats, iters
