"""Diff ``BENCH_<scenario>.json`` artifacts: the perf-regression gate.

``compare_artifacts`` diffs one scenario's current artifact against a
baseline with a *relative* threshold: the METG and each sweep point's
recorded wall time (each point's value is already the repeats-reduced
statistic — best-of-N or the configured percentile — so the per-point
comparison is a median-style comparison, not a single noisy sample).
Only slowdowns beyond the threshold regress; speedups are reported but
never fail.

``compare_dirs`` matches artifacts by filename across two directories —
every baseline scenario must still exist and hold its numbers; scenarios
that are *new* in the current run pass (they have no baseline yet) but
are named in the summary, so a typo'd rename shows up as vanished+new
instead of silently dropping its baseline coverage.

A copy of the reference's ``repro.bench.compare`` (numpy-free, json
only), with backend identities canonicalized by the port's
``backends.base.canonical_backend_spec``.  Under the deterministic
``SyntheticTimer`` the gate is noise-free: it trips on real changes to
graph structure, task counts, or the sweep itself, not on runner jitter.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .artifact import read_bench_json

DEFAULT_THRESHOLD = 0.25  # relative slowdown tolerated before failing


def _canonical_backend(spec: str) -> str:
    """Backend identity for the diff: canonical spec when parseable.

    Unparseable strings compare raw — a malformed baseline should fail
    as a visible identity mismatch, not crash the gate.
    """
    from ..backends.base import canonical_backend_spec

    try:
        return canonical_backend_spec(spec)
    except ValueError:
        return spec


class ZeroBaselineError(ValueError):
    """A baseline point of 0.0 against a nonzero current value.

    There is no finite relative delta to compare against the threshold —
    comparing ``inf`` (the old behavior) silently turned the point into
    an unconditional failure with a non-finite number in the report.  A
    measured point recorded as 0.0 means the artifacts disagree about
    what was measured (an identity mismatch), consistent with the
    finiteness guards in ``validate_artifact``; both-zero compares equal.
    """


def _rel_delta(baseline: float, current: float) -> float:
    if baseline == 0:
        if current == 0:
            return 0.0
        raise ZeroBaselineError(
            f"baseline is 0.0 but current is {current:.4g} — no finite "
            f"relative delta (zero-baseline points are an identity "
            f"mismatch, not a perf signal)")
    return (current - baseline) / baseline


@dataclass(frozen=True)
class PointDelta:
    """One matched sweep point (same iteration count) across the diff."""

    iterations: int
    baseline_s: float
    current_s: float
    rel_delta: float
    regressed: bool


@dataclass
class ComparisonResult:
    """One scenario's diff: METG movement + per-point wall-time deltas."""

    scenario: str
    metg_baseline: Optional[float] = None
    metg_current: Optional[float] = None
    metg_rel_delta: Optional[float] = None
    points: List[PointDelta] = field(default_factory=list)
    regressions: List[str] = field(default_factory=list)
    note: str = ""  # headline movement for non-METG kinds (serve_load)

    @property
    def ok(self) -> bool:
        return not self.regressions

    def summary(self) -> str:
        if self.ok:
            if self.note:
                return f"{self.scenario}: ok ({self.note})"
            d = self.metg_rel_delta
            moved = f"metg{d:+.1%}" if d is not None else "no-metg"
            return f"{self.scenario}: ok ({moved})"
        return f"{self.scenario}: REGRESSION " + "; ".join(self.regressions)


# metrics where LOWER is better: any increase beyond threshold regresses
_SERVE_LATENCY_METRICS = ("ttft_s", "tpot_s", "latency_s")
# metrics where HIGHER is better: any drop beyond threshold regresses
_SERVE_RATE_METRICS = ("throughput_tok_s", "goodput_rps")
_SERVE_IDENTITY = ("name", "mode", "rate_rps", "num_requests", "batch_slots",
                   "chunk_size", "seed", "model")


def _compare_serve(baseline: Dict, current: Dict, rel_threshold: float,
                   res: ComparisonResult) -> ComparisonResult:
    """serve_load diff: latency percentiles up or rates down = regression."""
    bm, cm = baseline["metrics"], current["metrics"]
    for k in _SERVE_RATE_METRICS:
        try:
            rel = _rel_delta(bm[k], cm[k])  # negative = slower
        except ZeroBaselineError as e:
            res.regressions.append(f"{k}: {e}")
            continue
        if -rel > rel_threshold:
            res.regressions.append(
                f"{k} {bm[k]:.4g} -> {cm[k]:.4g} "
                f"({rel:+.1%} < -{rel_threshold:.0%})")
    for k in _SERVE_LATENCY_METRICS:
        for q in ("p50", "p95", "p99"):
            try:
                rel = _rel_delta(bm[k][q], cm[k][q])
            except ZeroBaselineError as e:
                res.regressions.append(f"{k}.{q}: {e}")
                continue
            if rel > rel_threshold:
                res.regressions.append(
                    f"{k}.{q} {bm[k][q]:.3e}s -> {cm[k][q]:.3e}s "
                    f"(+{rel:.1%} > {rel_threshold:.0%})")
    try:
        thr = _rel_delta(bm["throughput_tok_s"], cm["throughput_tok_s"])
        res.note = f"thr{thr:+.1%}"
    except ZeroBaselineError:
        res.note = ""  # already a regression via the rate loop above
    return res


# metg_scaling identity: the rank sweep's shape axes (a changed rank
# list or per-rank width is a different experiment, not a perf delta)
_SCALING_IDENTITY = ("name", "backend", "pattern", "kernel",
                     "width_per_rank", "height", "output_bytes", "ranks")


def _compare_scaling(baseline: Dict, current: Dict, rel_threshold: float,
                     res: ComparisonResult) -> ComparisonResult:
    """metg_scaling diff: per-rank elapsed up or weak-scaling efficiency
    down beyond threshold = regression; a vanished rank cell regresses."""
    cur_cells = {c["ranks"]: c for c in current["cells"]}
    for bc in baseline["cells"]:
        n = bc["ranks"]
        cc = cur_cells.get(n)
        if cc is None:
            res.regressions.append(f"rank cell ranks={n} missing")
            continue
        try:
            rel = _rel_delta(bc["elapsed_s"], cc["elapsed_s"])
        except ZeroBaselineError as e:
            res.regressions.append(f"ranks={n} elapsed: {e}")
            continue
        if rel > rel_threshold:
            res.regressions.append(
                f"ranks={n} elapsed {bc['elapsed_s']:.3e}s -> "
                f"{cc['elapsed_s']:.3e}s (+{rel:.1%} > {rel_threshold:.0%})")
        try:
            eff = _rel_delta(bc["weak_efficiency"], cc["weak_efficiency"])
        except ZeroBaselineError as e:
            res.regressions.append(f"ranks={n} weak_efficiency: {e}")
            continue
        if -eff > rel_threshold:
            res.regressions.append(
                f"ranks={n} weak_efficiency {bc['weak_efficiency']:.3f} -> "
                f"{cc['weak_efficiency']:.3f} "
                f"({eff:+.1%} < -{rel_threshold:.0%})")
        for bp in bc["points"]:
            it = bp["iterations"]
            cp = next((p for p in cc["points"]
                       if p["iterations"] == it), None)
            if cp is None:
                res.regressions.append(
                    f"ranks={n} sweep point iterations={it} missing")
                continue
            try:
                prel = _rel_delta(bp["wall_time_s"], cp["wall_time_s"])
            except ZeroBaselineError as e:
                res.regressions.append(f"ranks={n} iterations={it}: {e}")
                continue
            if prel > rel_threshold:
                res.regressions.append(
                    f"ranks={n} iterations={it}: {bp['wall_time_s']:.3e}s "
                    f"-> {cp['wall_time_s']:.3e}s "
                    f"(+{prel:.1%} > {rel_threshold:.0%})")
    top = max(c["ranks"] for c in baseline["cells"])
    cc = cur_cells.get(top)
    if cc is not None and res.ok:
        res.note = f"eff@r{top}={cc['weak_efficiency']:.3f}"
    return res


def compare_artifacts(baseline: Dict, current: Dict,
                      rel_threshold: float = DEFAULT_THRESHOLD,
                      ) -> ComparisonResult:
    """Diff two validated artifact documents for the same scenario."""
    if rel_threshold <= 0:
        raise ValueError(f"rel_threshold must be > 0, got {rel_threshold}")
    name = baseline["scenario"]["name"]
    res = ComparisonResult(scenario=name)
    bk = baseline.get("kind", "metg_sweep")
    ck = current.get("kind", "metg_sweep")
    if bk != ck:
        res.regressions.append(
            f"kind changed: baseline {bk!r} vs current {ck!r} "
            f"(artifacts are not comparable)")
        return res
    if bk == "metg_scaling":
        for key in _SCALING_IDENTITY:
            b, c = baseline["scenario"][key], current["scenario"][key]
            if key == "backend":
                b, c = _canonical_backend(b), _canonical_backend(c)
            if b != c:
                res.regressions.append(
                    f"scenario.{key} changed: baseline {b!r} vs current {c!r}")
        bt, ct = baseline["timer"], current["timer"]
        if bt != ct:
            res.regressions.append(
                f"timer changed: baseline {bt!r} vs current {ct!r} "
                f"(times are not comparable)")
        if res.regressions:
            return res
        return _compare_scaling(baseline, current, rel_threshold, res)
    if bk == "serve_load":
        for key in _SERVE_IDENTITY:
            b, c = baseline["scenario"][key], current["scenario"][key]
            if b != c:
                res.regressions.append(
                    f"scenario.{key} changed: baseline {b!r} vs current {c!r}")
        bt, ct = baseline["timer"], current["timer"]
        if bt != ct:
            res.regressions.append(
                f"timer changed: baseline {bt!r} vs current {ct!r} "
                f"(times are not comparable)")
        if res.regressions:
            return res
        return _compare_serve(baseline, current, rel_threshold, res)
    for key in ("name", "backend", "pattern", "kernel"):
        b, c = baseline["scenario"][key], current["scenario"][key]
        if key == "backend":
            # compare canonically: option order inside the spec string is
            # not identity ("x[a=1,b=2]" == "x[b=2,a=1]"), so an old
            # baseline written with reordered keys never reads as a
            # changed (or vanished) scenario
            b, c = _canonical_backend(b), _canonical_backend(c)
        if b != c:
            res.regressions.append(
                f"scenario.{key} changed: baseline {b!r} vs current {c!r}")
    # wall-clock seconds vs a fake-clock baseline (or vice versa) is a
    # meaningless diff, not a perf signal — refuse, don't gate
    bt, ct = baseline["timer"], current["timer"]
    if bt != ct:
        res.regressions.append(
            f"timer changed: baseline {bt!r} vs current {ct!r} "
            f"(times are not comparable)")
    if res.regressions:
        return res  # identity mismatch: the numbers are not comparable

    mb, mc = baseline["metg_s"], current["metg_s"]
    res.metg_baseline, res.metg_current = mb, mc
    if mb is not None and mc is not None:
        try:
            res.metg_rel_delta = _rel_delta(mb, mc)
        except ZeroBaselineError as e:
            res.regressions.append(f"METG: {e}")
        else:
            if res.metg_rel_delta > rel_threshold:
                res.regressions.append(
                    f"METG {mb:.3e}s -> {mc:.3e}s "
                    f"(+{res.metg_rel_delta:.1%} > {rel_threshold:.0%})")
    elif mb is not None and mc is None:
        res.regressions.append(
            f"METG no longer crosses the efficiency threshold "
            f"(baseline {mb:.3e}s)")
    # baseline None: the scenario never crossed before — any crossing now
    # is an improvement, nothing to gate on

    cur_points = {p["iterations"]: p for p in current["points"]}
    for bp in baseline["points"]:
        it = bp["iterations"]
        cp = cur_points.get(it)
        if cp is None:
            res.regressions.append(f"sweep point iterations={it} missing")
            continue
        try:
            rel = _rel_delta(bp["wall_time_s"], cp["wall_time_s"])
        except ZeroBaselineError as e:
            res.regressions.append(f"point iterations={it}: {e}")
            continue
        regressed = rel > rel_threshold
        res.points.append(PointDelta(
            iterations=it, baseline_s=bp["wall_time_s"],
            current_s=cp["wall_time_s"], rel_delta=rel, regressed=regressed))
        if regressed:
            res.regressions.append(
                f"point iterations={it}: {bp['wall_time_s']:.3e}s -> "
                f"{cp['wall_time_s']:.3e}s (+{rel:.1%} > {rel_threshold:.0%})")
    return res


def bench_json_names(dirpath: str) -> List[str]:
    """Sorted BENCH_*.json filenames under ``dirpath``."""
    return sorted(f for f in os.listdir(dirpath)
                  if f.startswith("BENCH_") and f.endswith(".json"))


def scenario_family(fname: str) -> str:
    """The scenario family of a ``BENCH_<scenario>.json`` filename — the
    slug segment before the first dot (``BENCH_metg.xla-scan.nearest.json``
    -> ``"metg"``).  Scenarios of one family come from one bench module,
    so a partial run (``--only``) covers whole families."""
    base = os.path.basename(fname)
    if base.startswith("BENCH_"):
        base = base[len("BENCH_"):]
    return base.split(".")[0]


def compare_dirs(baseline_dir: str, current_dir: str,
                 rel_threshold: float = DEFAULT_THRESHOLD,
                 families: Optional[set] = None,
                 ) -> List[ComparisonResult]:
    """Diff every baseline artifact against its current counterpart.

    A baseline artifact with no current counterpart is a regression (a
    measured scenario silently disappeared); current artifacts without a
    baseline are new scenarios — they pass, but are *reported* in the
    summary (``"new in current run"``), because a new-looking artifact is
    also what a typo'd scenario rename produces: the old name trips the
    vanished-scenario regression and the note names its replacement, so
    the rename is visible end to end.  With ``families``, baseline
    artifacts of other scenario families are skipped entirely — the
    partial-run (``--only``) case, where the rest of the baseline was
    never remeasured and "missing" means "not run", not "vanished".
    Vanished-scenario detection is preserved *within* the families that
    did run.
    """
    if not os.path.isdir(baseline_dir):
        raise ValueError(f"baseline directory {baseline_dir!r} not found")
    results: List[ComparisonResult] = []
    base_names = set(bench_json_names(baseline_dir))
    for fname in sorted(base_names):
        if families is not None and scenario_family(fname) not in families:
            continue
        base = read_bench_json(os.path.join(baseline_dir, fname))
        cur_path = os.path.join(current_dir, fname)
        if not os.path.exists(cur_path):
            res = ComparisonResult(scenario=base["scenario"]["name"])
            res.regressions.append(
                f"artifact {fname} missing from current run")
            results.append(res)
            continue
        results.append(compare_artifacts(base, read_bench_json(cur_path),
                                         rel_threshold=rel_threshold))
    if os.path.isdir(current_dir):
        for fname in bench_json_names(current_dir):
            if fname in base_names:
                continue
            if (families is not None
                    and scenario_family(fname) not in families):
                continue
            results.append(ComparisonResult(
                scenario=fname,
                note="new in current run; no baseline yet (commit a "
                     "snapshot to gate it)"))
    return results


def format_report(results: List[ComparisonResult]) -> str:
    lines = [r.summary() for r in results]
    bad = sum(0 if r.ok else 1 for r in results)
    lines.append(f"compared {len(results)} scenario(s): "
                 + ("all within threshold" if not bad
                    else f"{bad} regression(s)"))
    return "\n".join(lines)
