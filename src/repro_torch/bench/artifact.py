"""Machine-readable benchmark artifacts: ``BENCH_<scenario>.json``.

One JSON file per scenario, schema-versioned, carrying the resolved spec,
the timer used, the full efficiency curve and the METG — everything a later
change (or an artifact collector) needs to track the perf trajectory
without re-parsing CSV stdout.

A copy of the reference's ``repro.bench.artifact``: the same schema and
kinds, so a port artifact validates under either package; backends are
recorded in the port's canonical spec form.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict

from .sweep import ScenarioResult

SCHEMA_VERSION = 1


def _canonical_backend(spec: str) -> str:
    """Artifacts record the canonical backend spec (options sorted by
    key) so artifact identity never depends on how a scenario author
    ordered the options; unparseable specs record raw."""
    from ..backends.base import canonical_backend_spec

    try:
        return canonical_backend_spec(spec)
    except ValueError:
        return spec

# field name -> required type(s); None-able fields listed separately
_POINT_FIELDS = {
    "iterations": int,
    "num_tasks": int,
    "wall_time_s": (int, float),
    "useful_work": (int, float),
    "granularity_s": (int, float),
    "rate": (int, float),
    "efficiency": (int, float),
}
_SCENARIO_FIELDS = {
    "name": str,
    "backend": str,
    "pattern": str,
    "kernel": str,
    "width": int,
    "height": int,
    "output_bytes": int,
    "imbalance": (int, float),
    "ngraphs": int,
    "cores": int,
    "graph_kw": dict,
    "sweep": dict,
}

# --- kind="serve_load" (bench.serve of the reference): serving traces ---
_SERVE_SCENARIO_FIELDS = {
    "name": str,
    "mode": str,
    "rate_rps": (int, float),
    "num_requests": int,
    "batch_slots": int,
    "chunk_size": int,
    "max_len": int,
    "prompt_len_lo": int,
    "prompt_len_hi": int,
    "out_tokens_lo": int,
    "out_tokens_hi": int,
    "seed": int,
    "model": str,
}
_SERVE_PCT_KEYS = ("p50", "p95", "p99", "mean")
_SERVE_PCT_METRICS = ("ttft_s", "tpot_s", "latency_s")

# --- kind="metg_scaling" (bench.scaling of the reference): rank sweep ---
_SCALING_SCENARIO_FIELDS = {
    "name": str,
    "backend": str,
    "pattern": str,
    "kernel": str,
    "width_per_rank": int,
    "height": int,
    "output_bytes": int,
    "ranks": list,
    "sweep": dict,
}
_SCALING_CELL_FIELDS = {
    "ranks": int,
    "width": int,
    "devices": int,
    "elapsed_s": (int, float),
    "granularity_s": (int, float),
    "weak_efficiency": (int, float),
}
_SCALING_POINT_FIELDS = {
    "iterations": int,
    "num_tasks": int,
    "wall_time_s": (int, float),
    "granularity_s": (int, float),
    "efficiency": (int, float),
    "weak_efficiency": (int, float),
}
_SERVE_SCALAR_METRICS = {
    "throughput_tok_s": (int, float),
    "goodput_rps": (int, float),
    "makespan_s": (int, float),
    "host_syncs_per_token": (int, float),
    "host_syncs": int,
    "decode_steps": int,
    "chunk_launches": int,
    "prefills": int,
    "tokens_generated": int,
    "completed": int,
}


def bench_artifact(result: ScenarioResult) -> Dict:
    """The JSON-serializable artifact for one scenario result."""
    spec = result.spec
    sweep = dataclasses.asdict(spec.sweep)
    sweep["schedule"] = (list(spec.sweep.schedule)
                        if spec.sweep.schedule is not None else None)
    return {
        "schema": SCHEMA_VERSION,
        "kind": "metg_sweep",
        "scenario": {
            "name": spec.name,
            "backend": _canonical_backend(spec.backend),
            "pattern": spec.pattern,
            "kernel": spec.kernel,
            "width": spec.width,
            "height": spec.height,
            "output_bytes": spec.output_bytes,
            "imbalance": spec.imbalance,
            "ngraphs": spec.ngraphs,
            "cores": spec.cores,
            "graph_kw": dict(spec.graph_kw),
            "sweep": sweep,
        },
        "timer": result.timer,
        # authoritative measurement parameters (a timer override supersedes
        # spec.sweep's warmup/repeats/percentile; this records what ran)
        "timer_config": dict(result.timer_config),
        "threshold": result.metg.threshold,
        "peak_rate": result.metg.peak_rate,
        "metg_s": result.metg.metg,
        "points": [
            {
                "iterations": p.iterations,
                "num_tasks": p.num_tasks,
                "wall_time_s": p.wall_time,
                "useful_work": p.useful_work,
                "granularity_s": p.granularity,
                "rate": p.rate,
                "efficiency": p.efficiency,
            }
            for p in sorted(result.points, key=lambda p: -p.iterations)
        ],
    }


def _typed(v, t) -> bool:
    """isinstance with bools rejected for numeric fields (bool <: int)
    and NaN/inf rejected for floats — a corrupt study artifact (e.g. a
    degenerate-metric division leaking through) fails the schema check
    here, not the CI gate arithmetic downstream."""
    if isinstance(v, bool):
        return False
    if isinstance(v, float) and not math.isfinite(v):
        return False
    return isinstance(v, t)


def validate_artifact(doc: Dict) -> Dict:
    """Schema check (raises ValueError); returns ``doc`` for chaining."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"invalid bench artifact: {msg}")

    need(isinstance(doc, dict), "not an object")
    need(doc.get("schema") == SCHEMA_VERSION,
         f"schema must be {SCHEMA_VERSION}, got {doc.get('schema')!r}")
    need(doc.get("kind") in ("metg_sweep", "serve_load", "metg_scaling"),
         f"unknown kind {doc.get('kind')!r}")
    # any non-empty name is valid: Timer is an open protocol (custom
    # timers must not be rejected at the artifact layer)
    need(isinstance(doc.get("timer"), str) and doc.get("timer"),
         f"timer must be a non-empty string, got {doc.get('timer')!r}")
    need(isinstance(doc.get("timer_config"), dict), "timer_config")
    if doc["kind"] == "serve_load":
        return _validate_serve_load(doc, need)
    if doc["kind"] == "metg_scaling":
        return _validate_metg_scaling(doc, need)
    need(_typed(doc.get("threshold"), (int, float)), "threshold")
    need(_typed(doc.get("peak_rate"), (int, float)), "peak_rate")
    need("metg_s" in doc, "metg_s missing (null means no crossing)")
    need(doc["metg_s"] is None or _typed(doc["metg_s"], (int, float)),
         "metg_s")
    sc = doc.get("scenario")
    need(isinstance(sc, dict), "scenario missing")
    for k, t in _SCENARIO_FIELDS.items():
        if t is str:  # identity fields must be non-empty (mirrors the spec)
            need(isinstance(sc.get(k), str) and sc.get(k),
                 f"scenario.{k} must be a non-empty string")
        elif t is dict:
            need(isinstance(sc.get(k), t), f"scenario.{k} must be {t}")
        else:
            need(_typed(sc.get(k), t), f"scenario.{k} must be {t}")
    pts = doc.get("points")
    need(isinstance(pts, list) and pts, "points must be a non-empty list")
    for n, p in enumerate(pts):
        need(isinstance(p, dict), f"points[{n}] not an object")
        for k, t in _POINT_FIELDS.items():
            need(_typed(p.get(k), t), f"points[{n}].{k} must be {t}")
    return doc


def _validate_serve_load(doc: Dict, need) -> Dict:
    """Schema for ``kind="serve_load"`` (see ``repro.bench.serve``)."""
    sc = doc.get("scenario")
    need(isinstance(sc, dict), "scenario missing")
    for k, t in _SERVE_SCENARIO_FIELDS.items():
        if t is str:
            need(isinstance(sc.get(k), str) and sc.get(k),
                 f"scenario.{k} must be a non-empty string")
        else:
            need(_typed(sc.get(k), t), f"scenario.{k} must be {t}")
    need(sc["mode"] in ("chunked", "host"),
         f"scenario.mode must be chunked|host, got {sc['mode']!r}")
    need(isinstance(sc.get("smoke"), bool), "scenario.smoke must be a bool")
    m = doc.get("metrics")
    need(isinstance(m, dict), "metrics missing")
    for k in _SERVE_PCT_METRICS:
        p = m.get(k)
        need(isinstance(p, dict), f"metrics.{k} must be an object")
        for q in _SERVE_PCT_KEYS:
            need(_typed(p.get(q), (int, float)),
                 f"metrics.{k}.{q} must be a number")
    for k, t in _SERVE_SCALAR_METRICS.items():
        need(_typed(m.get(k), t), f"metrics.{k} must be {t}")
    return doc


def _validate_metg_scaling(doc: Dict, need) -> Dict:
    """Schema for ``kind="metg_scaling"`` (see ``repro.bench.scaling``)."""
    sc = doc.get("scenario")
    need(isinstance(sc, dict), "scenario missing")
    for k, t in _SCALING_SCENARIO_FIELDS.items():
        if t is str:
            need(isinstance(sc.get(k), str) and sc.get(k),
                 f"scenario.{k} must be a non-empty string")
        elif t in (list, dict):
            need(isinstance(sc.get(k), t), f"scenario.{k} must be {t}")
        else:
            need(_typed(sc.get(k), t), f"scenario.{k} must be {t}")
    ranks = sc["ranks"]
    need(ranks and all(_typed(n, int) and n >= 1 for n in ranks),
         "scenario.ranks must be a non-empty list of rank counts >= 1")
    need(list(ranks) == sorted(set(ranks)),
         f"scenario.ranks must be strictly ascending, got {ranks}")
    need(ranks[0] == 1,
         "scenario.ranks must start at 1 (the weak-scaling reference)")
    cells = doc.get("cells")
    need(isinstance(cells, list) and cells, "cells must be a non-empty list")
    need([c.get("ranks") for c in cells if isinstance(c, dict)] == list(ranks),
         "cells must cover scenario.ranks exactly, in order")
    for n, c in enumerate(cells):
        need(isinstance(c, dict), f"cells[{n}] not an object")
        for k, t in _SCALING_CELL_FIELDS.items():
            need(_typed(c.get(k), t), f"cells[{n}].{k} must be {t}")
        need(c["width"] == sc["width_per_rank"] * c["ranks"],
             f"cells[{n}].width must be width_per_rank * ranks "
             f"(fixed work per rank), got {c['width']}")
        pts = c.get("points")
        need(isinstance(pts, list) and pts,
             f"cells[{n}].points must be a non-empty list")
        for m, p in enumerate(pts):
            need(isinstance(p, dict), f"cells[{n}].points[{m}] not an object")
            for k, t in _SCALING_POINT_FIELDS.items():
                need(_typed(p.get(k), t),
                     f"cells[{n}].points[{m}].{k} must be {t}")
    return doc


def artifact_path(slug: str, outdir: str) -> str:
    """Where ``write_bench_json`` will put a scenario's artifact."""
    return os.path.join(outdir, f"BENCH_{slug}.json")


def write_artifact_doc(doc: Dict, slug: str, outdir: str) -> str:
    """Write a validated artifact document atomically; returns the path."""
    os.makedirs(outdir, exist_ok=True)
    path = artifact_path(slug, outdir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def write_bench_json(result: ScenarioResult, outdir: str) -> str:
    """Write ``BENCH_<scenario>.json`` (validated); returns the path."""
    doc = validate_artifact(bench_artifact(result))
    return write_artifact_doc(doc, result.spec.slug, outdir)


def read_bench_json(path: str) -> Dict:
    """Read + schema-check one artifact.

    Truncated or garbage files raise ``ValueError`` naming the path (not a
    bare ``JSONDecodeError``), so corrupt artifacts fail the same way as
    schema violations — callers catch one exception type.
    """
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"invalid bench artifact: {path} is not valid JSON "
                f"(truncated or garbage: {e})") from e
    return validate_artifact(doc)
