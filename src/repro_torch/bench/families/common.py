"""Shared infrastructure of the port's bench families — thin glue over
``repro_torch.bench``.

The counterpart of the reference's ``benchmarks/common.py`` (its serving
hook waits for the port's ``bench.serve``).  Every family module exposes
``run(ctx) -> List[Row]``; ``repro_torch.bench.run`` aggregates and prints
``name,us_per_call,derived`` CSV (one row per measurement the paper's
table or figure would plot), while the ``BenchContext`` writes a
schema-checked ``BENCH_<scenario>.json`` per scenario.

Smoke mode is carried by the context and becomes a *parameter* of each
scenario's ``SweepControls`` (no module-level global): the resolved spec —
recorded in the artifact — is exactly what was measured.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..artifact import artifact_path, write_bench_json
from ..metg import METGResult
from ..scenario import ScenarioSpec, SweepControls
from ..sweep import ScenarioResult, run_scenario
from ..timers import Timer


@dataclasses.dataclass
class Row:
    name: str
    us_per_call: float
    derived: str = ""

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.3f},{self.derived}"


@dataclasses.dataclass
class BenchContext:
    """Per-invocation knobs: smoke mode, artifact sink, timer override,
    the backend filter, the device the backends run on and the rank
    counts of the scaling family."""

    smoke: bool = False
    artifacts_dir: Optional[str] = None
    timer: Optional[Timer] = None  # None -> wall clock from sweep controls
    written: List[str] = dataclasses.field(default_factory=list)
    # None -> every backend a module defines; otherwise an explicit spec
    # filter (``--backends``) matched canonically via ``wants_backend``
    backends: Optional[List[str]] = None
    # None -> the backends' default (the card); "cpu" runs them on the CPU
    device: Optional[str] = None
    # None -> the scaling family's own rank sweep (scaling.RANKS)
    ranks: Optional[Tuple[int, ...]] = None

    def on_device(self, backend: str) -> str:
        """``backend`` with the context's ``device`` option, if it has one."""
        if self.device is None:
            return backend
        from ...backends.base import with_options

        return with_options(backend, device=self.device)

    def wants_backend(self, spec: str) -> bool:
        """Whether ``spec`` survives the ``--backends`` filter.

        Matching is canonical (option order inside the spec string is not
        identity), falling back to raw string equality for specs the
        parser rejects — a typo'd filter entry should match nothing, not
        crash the registry run.
        """
        if self.backends is None:
            return True
        from ...backends.base import canonical_backend_spec

        def canon(s: str) -> str:
            try:
                return canonical_backend_spec(s)
            except ValueError:
                return s

        want = {canon(b) for b in self.backends}
        return canon(spec) in want

    def _claim(self, spec) -> None:
        """Fail before measuring (and before an earlier artifact would be
        clobbered): distinct names must map to distinct slugs."""
        if self.artifacts_dir:
            path = artifact_path(spec.slug, self.artifacts_dir)
            if path in self.written:
                raise ValueError(
                    f"scenario {spec.name!r} would overwrite an earlier "
                    f"artifact at {path}; pick names with distinct slugs")

    def run(self, spec: ScenarioSpec, peak_rate: Optional[float] = None,
            timer: Optional[Timer] = None) -> ScenarioResult:
        """Measure one scenario (smoke applied) and record its artifact.

        ``timer`` overrides the context timer for this scenario — the
        study families specialize the synthetic clock (worker pools,
        bytes-per-second) without forking the context.
        """
        spec = dataclasses.replace(
            spec.with_smoke(self.smoke or spec.sweep.smoke),
            backend=self.on_device(spec.backend))
        self._claim(spec)
        result = run_scenario(spec, timer=timer if timer is not None
                              else self.timer, peak_rate=peak_rate)
        if self.artifacts_dir:
            self.written.append(write_bench_json(result, self.artifacts_dir))
        return result

    def run_scaling(self, spec):
        """Run one weak-scaling rank sweep (smoke applied), record its
        artifact; every rank count runs in this process
        (``bench.scaling``)."""
        from ..scaling import run_scaling, write_scaling_json

        spec = dataclasses.replace(spec,
                                   backend=self.on_device(spec.backend))
        self._claim(spec)
        result = run_scaling(spec, timer=self.timer, smoke=self.smoke)
        if self.artifacts_dir:
            self.written.append(
                write_scaling_json(result, self.artifacts_dir))
        return result


def metg_for(
    ctx: BenchContext,
    backend_name: str,
    pattern: str,
    name: Optional[str] = None,
    width: int = 8,
    height: int = 32,
    iterations_hi: int = 4096,
    n_points: int = 7,
    num_graphs: int = 1,
    kernel: str = "compute",
    output_bytes: int = 16,
    imbalance: float = 0.0,
    repeats: int = 3,
    threshold: float = 0.5,
    peak_rate: Optional[float] = None,
    **graph_kw,
) -> METGResult:
    """Run the paper's METG procedure for one (backend, pattern) cell."""
    spec = ScenarioSpec(
        name=name or f"metg.{backend_name}.{pattern}",
        backend=backend_name,
        pattern=pattern,
        kernel=kernel,
        width=width,
        height=height,
        output_bytes=output_bytes,
        imbalance=imbalance,
        ngraphs=num_graphs,
        graph_kw=tuple(sorted(graph_kw.items())),
        sweep=SweepControls(iterations_hi=iterations_hi, n_points=n_points,
                            repeats=repeats, threshold=threshold),
    )
    return ctx.run(spec, peak_rate=peak_rate).metg
