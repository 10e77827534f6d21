"""Communication-hiding and load-imbalance studies (paper §V-F/G).

A copy of the reference's ``repro.bench.studies`` over the port's
backends: ``torch-host`` in place of ``host-dynamic``, and ``torch-csp``
(rank processes exchanging rows over gloo) in place of ``shardmap-csp``.

Task Bench's headline analyses beyond raw METG are each system's ability
to *hide communication* and to *mitigate load imbalance*.  This module
turns ``ScenarioSpec``'s payload and imbalance axes into those two
curves as first-class scenario families:

``metg_payload``
    Payload-bytes sweep at fixed task granularity, per backend with
    ``comm_overlap`` off ("blocking", strict MPI-style alternation), on
    ("overlap", double-buffered), and with one-sided put/signal
    communication ("onesided", no rendezvous at all) — the paper
    Fig. 11/12 analogue extended with the third point of the
    communication-hiding spectrum.

``metg_imbalance``
    Imbalance-factor sweep for ``torch-host`` with its static column
    schedule vs the work-stealing schedule — the paper Fig. 12/13
    analogue.

Every study cell is an ordinary single-point ``ScenarioSpec`` (fixed
iteration count, so the elapsed time *is* the study observable), runs
through ``run_scenario``/``BenchContext`` like any other scenario, and
emits the same schema-checked ``BENCH_<scenario>.json``.  Scenario names
put the family first (``metg_payload.<backend>.<variant>.bytes<N>``) so
``bench.compare``'s family scoping covers them.

Derived metrics
---------------

overlap efficiency
    ``ideal / observed`` elapsed, where the ideal is the same variant's
    elapsed at the smallest swept payload (the communication-light
    reference).  1.0 means the extra payload bytes are fully hidden.

mitigation factor
    ``observed rate / self-balanced rate`` — the fraction of its own
    balanced (imbalance=0) throughput a schedule retains under
    imbalance.  Higher is better; a perfect dynamic scheduler holds the
    wavefront mean, a static one pays the slowest block.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

from .scenario import ScenarioSpec, SweepControls
from .sweep import ScenarioResult
from .timers import SyntheticTimer, Timer

# the swept axes (chosen so the synthetic model's communication term
# crosses its compute term inside the payload sweep, and so imbalance=2.0
# saturates the duration floor for a visibly heterogeneous wavefront)
PAYLOAD_BYTES: Tuple[int, ...] = (16, 4096, 65536)
IMBALANCE_FACTORS: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0)

# study constants: one fixed granularity (survives the smoke ceiling of
# 64 iterations, so CI baselines measure the same point), a worker pool
# for the scheduling model, and fake-clock rates that put the interesting
# crossover inside the swept ranges
STUDY_ITERATIONS = 64
STUDY_WORKERS = 4
SECONDS_PER_BYTE = 4e-9
# rendezvous surcharge: what blocking/overlap pay per message for the
# two-sided match (the one-sided variant's entire advantage in the model)
SECONDS_PER_RENDEZVOUS = 2e-6
# imbalance study: per-iteration work must dominate the dispatch overhead
# or every wavefront is overhead-bound and no schedule can differentiate
IMBALANCE_SECONDS_PER_ITERATION = 2e-6

PAYLOAD_VARIANTS = ("blocking", "overlap", "onesided")
IMBALANCE_VARIANTS = ("static", "steal")

# what degenerate metric inputs (zero / negative / non-finite elapsed or
# rate, e.g. a smoke run too small to time) collapse to instead of
# raising or emitting inf — 0.0 reads as "no efficiency/mitigation
# observed" and keeps downstream artifact arithmetic finite
DEGENERATE_METRIC = 0.0


def payload_spec(backend: str = "torch-csp", comm_overlap: bool = False,
                 output_bytes: int = 16,
                 variant: str | None = None) -> ScenarioSpec:
    """One ``metg_payload`` cell: fixed granularity, one payload size.

    ``variant`` selects the comm mode ("blocking" / "overlap" /
    "onesided"); when omitted it is derived from ``comm_overlap`` for
    backward compatibility with two-variant callers.
    """
    if variant is None:
        variant = "overlap" if comm_overlap else "blocking"
    if variant not in PAYLOAD_VARIANTS:
        raise ValueError(f"unknown payload variant {variant!r}; "
                         f"expected one of {PAYLOAD_VARIANTS}")
    spec = (f"{backend}[comm=onesided]" if variant == "onesided"
            else f"{backend}[comm_overlap={variant == 'overlap'}]")
    return ScenarioSpec(
        name=f"metg_payload.{backend}.{variant}.bytes{output_bytes}",
        backend=spec,
        pattern="stencil",
        width=8,
        height=16,
        output_bytes=output_bytes,
        sweep=SweepControls(schedule=(STUDY_ITERATIONS,), repeats=3),
    )


def imbalance_spec(schedule: str = "static",
                   imbalance: float = 0.0) -> ScenarioSpec:
    """One ``metg_imbalance`` cell: fixed granularity, one imbalance."""
    return ScenarioSpec(
        name=f"metg_imbalance.torch-host.{schedule}.imb{imbalance}",
        backend=f"torch-host[schedule={schedule},workers={STUDY_WORKERS}]",
        pattern="stencil",
        width=8,
        height=16,
        imbalance=imbalance,
        sweep=SweepControls(schedule=(STUDY_ITERATIONS,), repeats=3),
    )


def payload_study_specs(backend: str = "torch-csp") -> List[ScenarioSpec]:
    """Every ``metg_payload`` cell for one backend, one block per variant
    (blocking, overlap, onesided)."""
    return [payload_spec(backend, output_bytes=ob, variant=v)
            for v in PAYLOAD_VARIANTS for ob in PAYLOAD_BYTES]


def imbalance_study_specs() -> List[ScenarioSpec]:
    """Every ``metg_imbalance`` cell: balanced baseline + the sweep,
    for the static and stealing schedules."""
    return [imbalance_spec(schedule=s, imbalance=f)
            for s in IMBALANCE_VARIANTS
            for f in (0.0,) + IMBALANCE_FACTORS]


def study_timer(timer: Timer | None, *, workers: int = 1,
                seconds_per_byte: float = 0.0,
                seconds_per_rendezvous: float = 0.0,
                seconds_per_iteration: float | None = None) -> Timer | None:
    """Specialize a ``SyntheticTimer`` with study knobs.

    Other timers (wall clock, dry run, user-defined) pass through
    unchanged — the studies are then real measurements and the synthetic
    knobs are irrelevant.
    """
    if not isinstance(timer, SyntheticTimer):
        return timer
    changes: Dict[str, object] = {
        "workers": workers,
        "seconds_per_byte": seconds_per_byte,
        "seconds_per_rendezvous": seconds_per_rendezvous,
    }
    if seconds_per_iteration is not None:
        changes["seconds_per_iteration"] = seconds_per_iteration
    return dataclasses.replace(timer, **changes)


def _single_point(result: ScenarioResult):
    """The study cell's one fixed-granularity sweep point."""
    if len(result.points) != 1:
        raise ValueError(
            f"study scenarios measure exactly one granularity, got "
            f"{len(result.points)} points for {result.spec.name!r}")
    return result.points[0]


def elapsed_s(result: ScenarioResult) -> float:
    """The study cell's elapsed seconds."""
    return _single_point(result).wall_time


def observed_rate(result: ScenarioResult) -> float:
    """The study cell's useful-work rate (work / elapsed)."""
    return _single_point(result).rate


def _guarded_ratio(num: float, den: float) -> float:
    """``num / den`` clamped to finite: degenerate inputs (zero, negative,
    NaN or inf — e.g. a smoke run too small to register any elapsed time)
    collapse to ``DEGENERATE_METRIC`` instead of raising or propagating
    inf into artifacts, where the schema check would reject them."""
    if (not math.isfinite(num) or not math.isfinite(den)
            or num <= 0 or den <= 0):
        return DEGENERATE_METRIC
    ratio = num / den
    return ratio if math.isfinite(ratio) else DEGENERATE_METRIC


def overlap_efficiency(ideal_s: float, observed_s: float) -> float:
    """``ideal / observed``: 1.0 when added communication is fully hidden.

    Degenerate inputs clamp to ``DEGENERATE_METRIC`` (see
    ``_guarded_ratio``) so study arithmetic never emits NaN/inf.
    """
    return _guarded_ratio(ideal_s, observed_s)


def mitigation_factor(balanced_rate: float, observed_rate: float) -> float:
    """``observed / self-balanced`` rate: imbalance throughput retained.

    Degenerate inputs clamp to ``DEGENERATE_METRIC`` (see
    ``_guarded_ratio``) so study arithmetic never emits NaN/inf.
    """
    return _guarded_ratio(observed_rate, balanced_rate)


@dataclass(frozen=True)
class StudyPoint:
    """One derived curve point: (x, variant) -> elapsed/rate + metric."""

    x: float          # payload bytes / imbalance factor
    variant: str      # "blocking"/"overlap" or "static"/"steal"
    elapsed_s: float
    rate: float
    metric: float     # overlap efficiency / mitigation factor


def payload_curve(
    results: Mapping[Tuple[int, str], ScenarioResult],
) -> List[StudyPoint]:
    """Overlap-efficiency curve from ``{(bytes, variant): result}``.

    Each variant normalizes against its own smallest-payload elapsed (the
    communication-light ideal), so the two curves are directly
    comparable: the overlap variant decaying slower *is* communication
    hiding.
    """
    points: List[StudyPoint] = []
    for variant in PAYLOAD_VARIANTS:
        sizes = sorted(b for b, v in results if v == variant)
        if not sizes:
            continue
        ideal = elapsed_s(results[(sizes[0], variant)])
        for b in sizes:
            res = results[(b, variant)]
            obs = elapsed_s(res)
            points.append(StudyPoint(
                x=float(b), variant=variant, elapsed_s=obs,
                rate=observed_rate(res),
                metric=overlap_efficiency(ideal, obs)))
    return points


def mitigation_curve(
    results: Mapping[Tuple[float, str], ScenarioResult],
) -> List[StudyPoint]:
    """Mitigation-factor curve from ``{(imbalance, variant): result}``.

    Each variant needs its own imbalance=0.0 cell (the self-balanced
    baseline the factor normalizes against).
    """
    points: List[StudyPoint] = []
    for variant in IMBALANCE_VARIANTS:
        factors = sorted(f for f, v in results if v == variant)
        if not factors:
            continue
        if factors[0] != 0.0:
            raise ValueError(
                f"mitigation needs the balanced (imbalance=0.0) baseline "
                f"for {variant!r}; have factors {factors}")
        balanced = observed_rate(results[(0.0, variant)])
        for f in factors:
            res = results[(f, variant)]
            rate = observed_rate(res)
            points.append(StudyPoint(
                x=f, variant=variant, elapsed_s=elapsed_s(res), rate=rate,
                metric=mitigation_factor(balanced, rate)))
    return points
