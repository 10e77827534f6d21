"""Dependence relations for Task Bench task graphs (paper Table 2).

A dependence relation maps a point ``(t, i)`` in the 2-D iteration space
(``t`` = timestep, ``i`` = column) to the set of columns in timestep ``t-1``
that the task depends on.  Every pattern also provides a *matrix form*
``matrix(t, width) -> bool[width, width]`` with ``M[i, j] = True`` iff task
``(t, i)`` depends on ``(t-1, j)``; the vectorized backends consume this.

Patterns are registered by name so that graph configs are plain data.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

import numpy as np

_REGISTRY: Dict[str, "DependencePattern"] = {}


def register(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def pattern_names() -> List[str]:
    return sorted(_REGISTRY)


def get_pattern(name: str, **kwargs) -> "PatternInstance":
    if name not in _REGISTRY:
        raise KeyError(f"unknown dependence pattern {name!r}; known: {pattern_names()}")
    return PatternInstance(_REGISTRY[name], kwargs)


class DependencePattern:
    """Base class: stateless rules, parameterized at instantiation."""

    name = "base"

    @staticmethod
    def deps(t: int, i: int, width: int, **kw) -> List[int]:
        raise NotImplementedError

    @classmethod
    def matrix(cls, t: int, width: int, **kw) -> np.ndarray:
        m = np.zeros((width, width), dtype=bool)
        for i in range(width):
            for j in cls.deps(t, i, width, **kw):
                if 0 <= j < width:
                    m[i, j] = True
        return m


@dataclass(frozen=True)
class PatternInstance:
    """A pattern bound to its parameters (radix, fraction, seed...)."""

    rule: type
    params: dict

    @property
    def name(self) -> str:
        return self.rule.name

    def deps(self, t: int, i: int, width: int) -> List[int]:
        if t == 0:
            return []
        return sorted({j for j in self.rule.deps(t, i, width, **self.params) if 0 <= j < width})

    def reverse_deps(self, t: int, i: int, width: int, height: int) -> List[int]:
        """Successors of (t, i): columns k at t+1 with i in deps(t+1, k)."""
        if t + 1 >= height:
            return []
        return [k for k in range(width) if i in self.deps(t + 1, k, width)]

    def matrix(self, t: int, width: int) -> np.ndarray:
        if t == 0:
            return np.zeros((width, width), dtype=bool)
        return self.rule.matrix(t, width, **self.params)

    def max_radix(self, width: int, height: int) -> int:
        """Max #deps of any task — sizes CSP receive buffers."""
        r = 0
        for t in range(1, height):
            m = self.matrix(t, width)
            r = max(r, int(m.sum(axis=1).max(initial=0)))
        return r

    def index_table(self, t: int, width: int, radix: int):
        """Dense padded form of one timestep's dependence rows.

        Returns ``(idx, mask)`` of shape ``(width, radix)``: row ``i``
        holds ``deps(t, i)`` in sorted column order, padded with column 0
        under mask 0 (the ragged-padding idiom of ``dist.collectives``).
        ``idx`` is int32, ``mask`` uint8 — the device-resident form the
        megakernel indexes instead of Python-side dependency lists.
        """
        idx = np.zeros((width, radix), np.int32)
        mask = np.zeros((width, radix), np.uint8)
        for i in range(width):
            ds = self.deps(t, i, width)
            if len(ds) > radix:
                raise ValueError(
                    f"pattern {self.name!r} has {len(ds)} deps at "
                    f"({t},{i}) but the table radix is {radix}")
            idx[i, : len(ds)] = ds
            mask[i, : len(ds)] = 1
        return idx, mask


@register("trivial")
class Trivial(DependencePattern):
    """D(t,i) := {} — embarrassing parallelism."""

    @staticmethod
    def deps(t, i, width):
        return []


@register("no_comm")
class NoComm(DependencePattern):
    """D(t,i) := {i} — serial chains, no cross-column communication."""

    @staticmethod
    def deps(t, i, width):
        return [i]


@register("stencil")
class Stencil(DependencePattern):
    """D(t,i) := {i-1, i, i+1} — 1-D halo exchange."""

    @staticmethod
    def deps(t, i, width):
        return [i - 1, i, i + 1]


@register("sweep")
class Sweep(DependencePattern):
    """D(t,i) := {i-1, i} — wavefront, as in discrete-ordinates sweeps.

    This is also exactly the pipeline-parallel schedule dependence:
    stage i at clock t needs stage i-1's output of clock t-1 (the activation)
    and its own previous state.
    """

    @staticmethod
    def deps(t, i, width):
        return [i - 1, i]


@register("fft")
class FFT(DependencePattern):
    """D(t,i) := {i, i-2^t, i+2^t} — butterfly."""

    @staticmethod
    def deps(t, i, width):
        s = 2 ** (t - 1)  # timestep t consumes t-1; stride grows with level
        return [i, i - s, i + s]


@register("tree")
class Tree(DependencePattern):
    """Binary reduction tree followed by broadcast (paper Table 2).

    For t <= log2(width): column i receives from the pair it reduces.
    Afterwards: broadcast back down.
    """

    @staticmethod
    def deps(t, i, width):
        depth = max(1, int(np.log2(max(width, 2))))
        if t <= depth:
            stride = 2 ** (t - 1)
            group = 2 ** t
            if i % group == 0:
                return [i, i + stride]
            return []
        # broadcast phase: mirror of reduction
        bt = t - depth  # broadcast level
        group = 2 ** max(depth - bt, 0)
        src = (i // (group * 2)) * (group * 2) if group >= 1 else 0
        return [src, i] if i != src else [i]


@register("random")
class RandomPattern(DependencePattern):
    """D(t,i) := {j | random() < fraction} — deterministic per (t,i,j,seed)."""

    @staticmethod
    def _coin(t: int, i: int, j: int, seed: int) -> bool:
        h = hashlib.blake2b(
            f"{seed}:{t}:{i}:{j}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "little") % 1000 < 125  # fraction 1/8

    @staticmethod
    def deps(t, i, width, seed: int = 0):
        out = [j for j in range(width) if RandomPattern._coin(t, i, j, seed)]
        return out or [i]  # never fully disconnected


@register("nearest")
class Nearest(DependencePattern):
    """radix nearest neighbours centred on i (paper §V-C 'nearest').

    radix=0 -> no deps; radix=1 -> {i}; radix=3 -> {i-1,i,i+1}; radix=5 ->
    {i-2..i+2}; even radix skews left.
    """

    @staticmethod
    def deps(t, i, width, radix: int = 3):
        if radix <= 0:
            return []
        lo = i - radix // 2
        return [lo + k for k in range(radix)]


@register("spread")
class Spread(DependencePattern):
    """radix deps spread as widely as possible (paper §V-C 'spread')."""

    @staticmethod
    def deps(t, i, width, radix: int = 3):
        if radix <= 0:
            return []
        return [(i + k * width // radix + (t % max(1, width // max(radix, 1)))) % width
                for k in range(radix)]
