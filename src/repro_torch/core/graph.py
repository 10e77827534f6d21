"""Task graphs: the paper's 2-D iteration space + dependence relation.

The core API mirrors paper Table 3::

    Graph.contains_point(t, i)   -- is task (t, i) in the graph?
    Graph.deps(t, i)             -- predecessors of (t, i) (in timestep t-1)
    Graph.reverse_deps(t, i)     -- successors of (t, i) (in timestep t+1)
    Graph.execute_point(t, i, inputs) -- reference task body (numpy)

Task payloads are float32 vectors of ``payload_elems`` entries:

    payload[0] = t, payload[1] = i        (self-identification, paper §II)
    payload[2] = checksum(t, i)           (locally verifiable by consumers)
    payload[3] = combined history checksum (base + sum of dep slot-3 values)
    payload[4] = kernel result            (proves work was done)
    payload[5:] = kernel result broadcast (communication ballast)

Checksums are exact in float32 (kept < 2^20), so every backend must
reproduce them bit-for-bit; the kernel-result slot is compared with a small
tolerance (matmul reduction order may differ between backends).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .kernel_spec import KernelSpec
from .patterns import PatternInstance, get_pattern

CHECKSUM_MOD = 1 << 20  # keep exact in f32
MIN_PAYLOAD_ELEMS = 5


def _imbalance_u(t: int, i: int, seed: int) -> float:
    """Deterministic uniform in [0,1) per task (paper §V-G)."""
    import hashlib

    h = hashlib.blake2b(f"imb:{seed}:{t}:{i}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") / 2.0**64


@dataclass(frozen=True)
class TaskGraph:
    """One parameterized task graph (paper Table 1)."""

    width: int = 16
    height: int = 32
    pattern: str = "stencil"
    pattern_params: Tuple[Tuple[str, object], ...] = ()
    kernel: KernelSpec = field(default_factory=KernelSpec)
    output_bytes: int = 16  # bytes per dependency payload

    def __post_init__(self):
        if self.width < 1 or self.height < 1:
            raise ValueError("width and height must be >= 1")
        object.__setattr__(self, "_pat", get_pattern(self.pattern, **dict(self.pattern_params)))

    # -- core API (paper Table 3) -------------------------------------------
    def contains_point(self, t: int, i: int) -> bool:
        return 0 <= t < self.height and 0 <= i < self.width

    def deps(self, t: int, i: int) -> List[int]:
        if not self.contains_point(t, i):
            return []
        return self._pat.deps(t, i, self.width)

    def reverse_deps(self, t: int, i: int) -> List[int]:
        if not self.contains_point(t, i):
            return []
        return self._pat.reverse_deps(t, i, self.width, self.height)

    def dependence_matrix(self, t: int) -> np.ndarray:
        """bool[width, width]: M[i, j] iff (t, i) depends on (t-1, j)."""
        return self._pat.matrix(t, self.width)

    def dependence_matrices(self) -> np.ndarray:
        """Stacked matrices for all timesteps: bool[height, width, width].

        Time-invariant patterns produce identical slices; backends may
        collapse them (the dataflow backend checks this to enable scan reuse).
        Cached on the (frozen) graph: comm planning, invariance checks and
        backend prepare all consume the same stack.
        """
        cached = self.__dict__.get("_mats_cache")
        if cached is None:
            cached = np.stack(
                [self.dependence_matrix(t) for t in range(self.height)])
            cached.setflags(write=False)
            object.__setattr__(self, "_mats_cache", cached)
        return cached

    def dependency_table(self, radix: Optional[int] = None):
        """Dense device-resident dependence form: padded index + mask.

        Returns ``(idx, mask)`` of shape ``(height, width, R)`` with
        ``R = max(1, max_radix())`` (or the requested ``radix >= R`` when
        stacking graphs of different patterns into one program): row
        ``(t, i)`` lists ``deps(t, i)`` in sorted column order, padded
        with column 0 under mask 0 — the ragged-padding idiom of
        ``dist.collectives``.  ``idx`` is int32, ``mask`` uint8; both
        read-only and cached on the (frozen) graph.  The megakernel
        backend indexes these in-kernel instead of consuming Python-side
        dependency lists or the dense (W, W) matrices.
        """
        cached = self.__dict__.get("_deptab_cache")
        if cached is None:
            r0 = max(1, self.max_radix())
            rows = [self._pat.index_table(t, self.width, r0)
                    for t in range(self.height)]
            idx = np.stack([r[0] for r in rows])
            mask = np.stack([r[1] for r in rows])
            idx.setflags(write=False)
            mask.setflags(write=False)
            cached = (idx, mask)
            object.__setattr__(self, "_deptab_cache", cached)
        idx, mask = cached
        r0 = idx.shape[2]
        if radix is None or radix == r0:
            return idx, mask
        if radix < r0:
            raise ValueError(f"requested radix {radix} < max radix {r0}")
        pad = ((0, 0), (0, 0), (0, radix - r0))
        return np.pad(idx, pad), np.pad(mask, pad)

    def is_time_invariant(self) -> bool:
        cached = self.__dict__.get("_invariant_cache")
        if cached is None:
            ms = self.dependence_matrices()[1:]
            cached = bool(ms.size == 0 or (ms == ms[0]).all())
            object.__setattr__(self, "_invariant_cache", cached)
        return cached

    # -- payloads ------------------------------------------------------------
    @property
    def payload_elems(self) -> int:
        return max(MIN_PAYLOAD_ELEMS, self.output_bytes // 4)

    def task_iterations(self, t: int, i: int) -> int:
        """Per-task duration after imbalance scaling.

        Rounding bound (pinned by the conservation property test): the
        returned count is within 0.5 of the analytic
        ``max(1, iterations * (1 - imbalance * u(t, i)))``, so the graph
        total is conserved within ``num_tasks / 2`` of the analytic sum,
        and every task stays in ``[1, iterations]``.
        """
        k = self.kernel
        if k.imbalance <= 0.0:
            return k.iterations
        u = _imbalance_u(t, i, k.seed)
        return max(1, int(round(k.iterations * (1.0 - k.imbalance * u))))

    def max_radix(self) -> int:
        return self._pat.max_radix(self.width, self.height)

    # -- reference task body (numpy oracle) ----------------------------------
    def checksum(self, t: int, i: int) -> int:
        """uint32 wrap-around hash of coordinates, reduced mod 2^20.

        Written so the identical arithmetic is exact in python ints, in the
        backends' int64 tensors (``& 0xFFFFF`` equals both reductions, since
        2^20 divides 2^32) and in float32 payload slots (< 2^20).
        """
        return ((t * 2654435761 + i * 40503) % (1 << 32)) % CHECKSUM_MOD

    def checksum_table(self) -> np.ndarray:
        """All base checksums at once: uint32 ``(height, width)``.

        The fused kernel reads these as an int32 table (the values are
        < 2^20, exact in its int32 math).  Cached read-only on the (frozen)
        graph.
        """
        cached = self.__dict__.get("_cktab_cache")
        if cached is None:
            t = np.arange(self.height, dtype=np.uint64)[:, None]
            i = np.arange(self.width, dtype=np.uint64)[None, :]
            cached = (((t * 2654435761 + i * 40503) % (1 << 32))
                      % CHECKSUM_MOD).astype(np.uint32)
            cached.setflags(write=False)
            object.__setattr__(self, "_cktab_cache", cached)
        return cached

    def execute_point(
        self, t: int, i: int, inputs: Sequence[np.ndarray]
    ) -> np.ndarray:
        """Reference (numpy) task body; validates inputs, runs kernel.

        ``inputs`` must be the payloads of ``deps(t, i)`` in sorted column
        order.  Raises AssertionError on validation failure (paper §II:
        'Inputs are verified by checking the expected dependencies against
        those received').
        """
        deps = self.deps(t, i)
        assert len(inputs) == len(deps), (
            f"task ({t},{i}) expected {len(deps)} inputs, got {len(inputs)}"
        )
        acc = 0
        for j, buf in zip(deps, inputs):
            assert int(buf[0]) == t - 1 and int(buf[1]) == j, (
                f"task ({t},{i}) received payload from "
                f"({int(buf[0])},{int(buf[1])}), expected ({t - 1},{j})"
            )
            expect = self.checksum(t - 1, j)
            assert int(buf[2]) == expect, (
                f"task ({t},{i}) dep ({t - 1},{j}) checksum {int(buf[2])}"
                f" != expected {expect}"
            )
            acc = (acc + int(buf[3])) % CHECKSUM_MOD
        result = self._run_kernel_ref(t, i)
        out = np.zeros(self.payload_elems, dtype=np.float32)
        out[0], out[1] = t, i
        out[2] = self.checksum(t, i)
        out[3] = (self.checksum(t, i) + acc) % CHECKSUM_MOD
        out[4] = result
        if self.payload_elems > 5:
            out[5:] = result
        return out

    def _run_kernel_ref(self, t: int, i: int) -> float:
        from . import kernel_ref

        return kernel_ref.run_kernel_ref(self.kernel, self.task_iterations(t, i))

    # -- convenience ----------------------------------------------------------
    def with_kernel(self, kernel: KernelSpec) -> "TaskGraph":
        return replace(self, kernel=kernel)

    def with_iterations(self, iterations: int) -> "TaskGraph":
        return replace(self, kernel=self.kernel.with_iterations(iterations))

    @property
    def num_tasks(self) -> int:
        return self.width * self.height

    def total_iterations(self) -> int:
        """Total kernel iterations across all tasks, imbalance-aware.

        The single definition of aggregate task duration, shared by the
        useful-work accounting below and ``bench.metg.sweep_point``.
        """
        k = self.kernel
        if k.imbalance <= 0:
            return k.iterations * self.num_tasks
        return sum(
            self.task_iterations(t, i)
            for t in range(self.height)
            for i in range(self.width)
        )

    def total_useful_work(self) -> float:
        """Total FLOPs (or bytes) across all tasks, imbalance-aware."""
        k = self.kernel
        per_iter = k.useful_work() / max(k.iterations, 1)
        return per_iter * self.total_iterations()


def make_graph(
    width: int = 16,
    height: int = 32,
    pattern: str = "stencil",
    kernel: str = "compute",
    iterations: int = 16,
    output_bytes: int = 16,
    imbalance: float = 0.0,
    span_bytes: int = 64 * 1024,
    scratch_bytes: int = 1 << 20,
    seed: int = 0,
    **pattern_params,
) -> TaskGraph:
    """Ergonomic constructor mirroring the paper's CLI parameters."""
    ks = KernelSpec(
        kind=kernel,
        iterations=iterations,
        imbalance=imbalance,
        span_bytes=span_bytes,
        scratch_bytes=scratch_bytes,
        seed=seed,
    )
    return TaskGraph(
        width=width,
        height=height,
        pattern=pattern,
        pattern_params=tuple(sorted(pattern_params.items())),
        kernel=ks,
        output_bytes=output_bytes,
    )


def replicate(graph: TaskGraph, n: int) -> List[TaskGraph]:
    """n identical concurrent graphs (paper Fig 9d: task parallelism)."""
    return [graph for _ in range(n)]
