"""METG measurement on the port (paper §IV-V).

- ``metg``     — the pure metric math: sweep points, efficiency curves,
                 METG crossover (a copy of the reference's)
- ``scenario`` — declarative ``ScenarioSpec`` / ``SweepControls``
- ``timers``   — the ``Timer`` protocol: wall clock and the synthetic
                 fake clock
- ``sweep``    — ``run_scenario``: spec + timer -> ``ScenarioResult``
- ``artifact`` — schema-checked ``BENCH_<scenario>.json`` writer
- ``compare``  — artifact diffing: the bench-regression gate
- ``studies``  — the communication-hiding (``metg_payload``) and
                 load-imbalance (``metg_imbalance``) scenario families
                 and their derived metrics (overlap efficiency,
                 mitigation factor)
- ``tuner``    — the self-tuning planner behind ``torch-auto``: tuning
                 keys, the mode-space sweep and the committed table
- ``serve``    — the ``serve_load`` scenario family: open-loop serving
                 traces through the port's ``ServeEngine`` (wall clock) or
                 the deterministic simulator (synthetic clock)
- ``scaling``  — the ``metg_scaling`` weak-scaling family (paper §V-D/E),
                 every rank count in this process
- ``moe``      — the ``moe_dispatch`` scenario: analytic MoE all-to-all
                 bytes and their interconnect roofline
- ``suite``    — the declarative campaign: a TOML file of families run
                 as ``python -m repro_torch.bench.run`` subprocesses
                 (its CLI, ``python -m repro_torch.bench.suite``, so the
                 package does not import it)
- ``run``      — the runner of the bench families (``bench.families``)

Multi-graph scenarios (``ngraphs >= 2``) execute concurrently through
``Backend.run_many``.
"""
from .metg import (METGResult, SweepPoint, compute_metg, efficiency_curve,
                   geometric_iterations, observed_peak, run_sweep,
                   sweep_point, time_run)
from .scenario import ScenarioSpec, SweepControls
from .timers import DryRunTimer, SyntheticTimer, Timer, WallClockTimer
from .sweep import ScenarioResult, run_scenario
from .artifact import (SCHEMA_VERSION, bench_artifact, read_bench_json,
                       validate_artifact, write_bench_json)
from .compare import (ComparisonResult, PointDelta, bench_json_names,
                      compare_artifacts, compare_dirs, format_report,
                      scenario_family)
from .studies import (StudyPoint, elapsed_s, imbalance_spec,
                      imbalance_study_specs, mitigation_curve,
                      mitigation_factor, observed_rate, overlap_efficiency,
                      payload_curve, payload_spec, payload_study_specs,
                      study_timer)
from .tuner import (TuningKey, TuningTable, auto_resolve, build_tuning_table,
                    diff_tuning_tables, enumerate_mode_space,
                    granularity_bucket, graphs_cutout, load_tuning_table,
                    payload_bucket, read_tuning_json, spec_cutout,
                    validate_tuning_table, write_tuning_json)
from .serve import (ServeCostParams, ServeLoadResult, ServeLoadSpec,
                    TracedRequest, run_engine_load, run_serve_load,
                    serve_artifact, simulate_serve_load, synth_trace,
                    write_serve_json)
from .scaling import (RANKS, SCALING_BACKENDS, ScalingResult, ScalingSpec,
                      run_scaling, scaling_artifact, write_scaling_json)
from .moe import MoEDispatchSpec, analytic_a2a_bytes, moe_dispatch_report

__all__ = [
    "METGResult",
    "SweepPoint",
    "compute_metg",
    "efficiency_curve",
    "geometric_iterations",
    "observed_peak",
    "run_sweep",
    "sweep_point",
    "time_run",
    "ScenarioSpec",
    "SweepControls",
    "Timer",
    "WallClockTimer",
    "SyntheticTimer",
    "DryRunTimer",
    "ScenarioResult",
    "run_scenario",
    "SCHEMA_VERSION",
    "bench_artifact",
    "read_bench_json",
    "validate_artifact",
    "write_bench_json",
    "ComparisonResult",
    "PointDelta",
    "compare_artifacts",
    "compare_dirs",
    "format_report",
    "StudyPoint",
    "elapsed_s",
    "imbalance_spec",
    "imbalance_study_specs",
    "mitigation_curve",
    "mitigation_factor",
    "observed_rate",
    "overlap_efficiency",
    "payload_curve",
    "payload_spec",
    "payload_study_specs",
    "study_timer",
    "TuningKey",
    "TuningTable",
    "auto_resolve",
    "build_tuning_table",
    "diff_tuning_tables",
    "enumerate_mode_space",
    "granularity_bucket",
    "graphs_cutout",
    "load_tuning_table",
    "payload_bucket",
    "read_tuning_json",
    "spec_cutout",
    "validate_tuning_table",
    "write_tuning_json",
    "ServeCostParams",
    "ServeLoadResult",
    "ServeLoadSpec",
    "TracedRequest",
    "run_engine_load",
    "run_serve_load",
    "serve_artifact",
    "simulate_serve_load",
    "synth_trace",
    "write_serve_json",
    "RANKS",
    "SCALING_BACKENDS",
    "ScalingResult",
    "ScalingSpec",
    "run_scaling",
    "scaling_artifact",
    "write_scaling_json",
    "MoEDispatchSpec",
    "analytic_a2a_bytes",
    "moe_dispatch_report",
]
