"""Declared costs of the hand-written kernels, for the dry-run counter.

Each kernel wrapper K1-K7 (and its plain version) carries ``cost``: a
function of the wrapper's own arguments (tensors, or anything with a
``shape`` and ``dtype``: meta tensors do) returning a ``Cost``:

``flops``
    matmul FLOPs, the roofline's convention (``launch.roofline``): K5's
    QK^T and PV products, K6's products, K7's y = h' . C, 0 for K1-K4;
``bytes``
    each input read once and each output written once;
``ops``
    elementwise operations (K1-K4's task bodies).

``costed(cost)`` wraps a wrapper so that, while a ``launch.roofline``
counter is active, a call charges its declared cost and runs with the
counter paused: a roofline reads the same work whichever of the kernel
and its plain version runs, and the plain version's elementwise loops do
not count as traffic.  With no counter active it is the bare call.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from ..launch import roofline


class Cost(NamedTuple):
    flops: float
    bytes: float
    ops: float


def nbytes(t) -> int:
    """Bytes of a tensor-like (shape and dtype), 0 for None."""
    if t is None:
        return 0
    n = 1
    for d in t.shape:
        n *= int(d)
    return n * t.dtype.itemsize


def costed(cost: Callable[..., Cost]):
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = roofline.active_counter()
            if counter is None:
                return fn(*args, **kwargs)
            counter.charge(cost(*args, **kwargs))
            with counter.paused():
                return fn(*args, **kwargs)

        call.cost = cost
        return call

    return wrap


def data_sum(t) -> int:
    """The sum of an integer tensor's values (a work count that depends on
    the data); 0 for one without data (meta or fake)."""
    from torch._subclasses.fake_tensor import is_fake

    if t.is_meta or is_fake(t):
        return 0
    return int(t.sum().item())
