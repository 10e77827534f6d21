"""Declarative benchmark campaigns: a TOML suite of bench families.

The port's copy of the reference's ``repro.bench.suite``, with its CLI
(the reference's ``benchmarks/suite.py``) beside it as ``main``.  A
paper-style campaign is the cross product — families x backends x
repeats — plus bookkeeping (artifact collection, the baseline gate).
This module makes the campaign a *document* instead of a shell history
(TaPS-style):

.. code-block:: toml

    name = "paper"
    parallel = 4          # concurrent cells (subprocesses)
    timer = "synthetic"   # suite default; cells may override

    [[tasks]]
    family = "bench_metg_patterns"
    backends = ["torch-scan", "torch-csp"]    # optional --backends filter
    rollouts = 2                              # repeat runs; byte-compared

Execution model: every cell is one ``python -m repro_torch.bench.run
--only <family>`` subprocess — exactly the serial CLI, so a suite run writes
the *same* ``BENCH_*.json`` artifacts a serial run would (bit-identical
on the synthetic timer; asserted for rollouts).  ``parallel = N`` runs
up to N cells concurrently; artifact filenames are disjoint because one
family's scenarios share its name prefix and duplicate families are
rejected at validation time.  A failed cell fails the suite, but every
other cell still runs to completion (the failure names the cell).

``rollouts = k`` re-runs a cell ``k - 1`` extra times into
``<out>/rollouts/<family>.rN/`` and byte-compares each rollout's
artifacts against the primary run's — on the deterministic synthetic
timer any difference is a real nondeterminism bug (unseeded RNG, dict
ordering, clock leakage), so a mismatch fails the suite.  Wall-clock
rollouts are kept for inspection but not compared (timing noise is not
a bug).

The CLI: ``python -m repro_torch.bench.suite <toml> [--smoke]
[--artifacts DIR] [--parallel N] [--baseline DIR]`` — TOML in, artifacts
and the baseline gate out.  Exit codes: 2 = the suite file is invalid
(TOML syntax, unknown family or backend — nothing was run); 1 = a cell
failed, a rollout mismatched, or the ``--baseline`` gate found a
regression; 0 = a clean campaign.  The campaign of the paper is
``bench/suites/paper.toml``.
"""
from __future__ import annotations

import argparse
import filecmp
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

try:  # py >= 3.11
    import tomllib
except ImportError:  # 3.10: same API, vendored package
    import tomli as tomllib

TIMERS = ("synthetic", "wallclock")


@dataclass(frozen=True)
class SuiteCell:
    """One campaign cell: a bench family plus its run knobs."""

    family: str
    backends: Optional[Tuple[str, ...]] = None  # None -> module defaults
    rollouts: int = 1
    timer: Optional[str] = None  # None -> suite default

    def __post_init__(self):
        if not self.family:
            raise ValueError("suite cell needs a family (bench module name)")
        if self.rollouts < 1:
            raise ValueError(
                f"cell {self.family!r}: rollouts must be >= 1, "
                f"got {self.rollouts}")
        if self.timer is not None and self.timer not in TIMERS:
            raise ValueError(
                f"cell {self.family!r}: unknown timer {self.timer!r}; "
                f"known: {TIMERS}")
        if self.backends is not None and not self.backends:
            raise ValueError(
                f"cell {self.family!r}: backends = [] would filter every "
                f"backend out; omit the key to run the module's defaults")


@dataclass(frozen=True)
class Suite:
    """A parsed campaign: named, bounded concurrency, ordered cells."""

    name: str
    cells: Tuple[SuiteCell, ...]
    parallel: int = 1
    timer: str = "synthetic"

    def __post_init__(self):
        if not self.name:
            raise ValueError("suite needs a name")
        if self.parallel < 1:
            raise ValueError(f"parallel must be >= 1, got {self.parallel}")
        if self.timer not in TIMERS:
            raise ValueError(
                f"unknown suite timer {self.timer!r}; known: {TIMERS}")
        if not self.cells:
            raise ValueError("suite has no [[tasks]] cells")

    def cell_timer(self, cell: SuiteCell) -> str:
        return cell.timer or self.timer


def parse_suite(text: str, source: str = "<suite>") -> Suite:
    """Parse TOML into a ``Suite``; structural errors name ``source``."""
    try:
        doc = tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise ValueError(f"{source}: not valid TOML: {e}")
    known_top = {"name", "parallel", "timer", "tasks"}
    unknown = sorted(set(doc) - known_top)
    if unknown:
        raise ValueError(
            f"{source}: unknown top-level key(s) {unknown}; "
            f"known: {sorted(known_top)}")
    tasks = doc.get("tasks")
    if not isinstance(tasks, list) or not tasks:
        raise ValueError(f"{source}: needs at least one [[tasks]] cell")
    known_cell = {"family", "backends", "rollouts", "timer"}
    cells = []
    for i, t in enumerate(tasks):
        if not isinstance(t, dict):
            raise ValueError(f"{source}: [[tasks]] entry #{i + 1} is not "
                             f"a table")
        unknown = sorted(set(t) - known_cell)
        if unknown:
            raise ValueError(
                f"{source}: [[tasks]] entry #{i + 1} "
                f"({t.get('family', '?')!r}): unknown key(s) {unknown}; "
                f"known: {sorted(known_cell)}")
        backends = t.get("backends")
        if backends is not None:
            if (not isinstance(backends, list)
                    or any(not isinstance(b, str) for b in backends)):
                raise ValueError(
                    f"{source}: [[tasks]] entry #{i + 1} "
                    f"({t.get('family', '?')!r}): backends must be a list "
                    f"of spec strings")
            backends = tuple(backends)
        try:
            cells.append(SuiteCell(
                family=str(t.get("family", "")),
                backends=backends,
                rollouts=int(t.get("rollouts", 1)),
                timer=t.get("timer")))
        except ValueError as e:
            raise ValueError(f"{source}: [[tasks]] entry #{i + 1}: {e}")
    try:
        return Suite(name=str(doc.get("name", "")),
                     cells=tuple(cells),
                     parallel=int(doc.get("parallel", 1)),
                     timer=doc.get("timer", "synthetic"))
    except ValueError as e:
        raise ValueError(f"{source}: {e}")


def load_suite(path: str) -> Suite:
    with open(path, "rb") as f:
        text = f.read().decode("utf-8")
    return parse_suite(text, source=path)


def validate_suite(suite: Suite, known_families: Sequence[str],
                   known_backends: Optional[Sequence[str]] = None) -> None:
    """Reject cells naming unknown families/backends (and duplicates).

    Runs before any subprocess is spawned: a typo'd family must exit
    nonzero *naming the entry*, never launch a partial campaign.
    Backend specs are checked by parsing (option brackets are legal spec
    syntax, not registry keys); duplicate
    families are rejected because two cells of one family would race on
    the same ``BENCH_*.json`` filenames.
    """
    problems = []
    seen: Dict[str, int] = {}
    for i, cell in enumerate(suite.cells, 1):
        if cell.family not in known_families:
            problems.append(
                f"[[tasks]] entry #{i}: unknown family {cell.family!r}; "
                f"known: {', '.join(known_families)}")
            continue
        if cell.family in seen:
            problems.append(
                f"[[tasks]] entry #{i}: duplicate family {cell.family!r} "
                f"(already cell #{seen[cell.family]}; two cells of one "
                f"family would overwrite each other's artifacts)")
        seen.setdefault(cell.family, i)
        for b in cell.backends or ():
            try:
                from ..backends.base import parse_backend_spec

                base, _ = parse_backend_spec(b)
            except ValueError as e:
                problems.append(
                    f"[[tasks]] entry #{i} ({cell.family!r}): malformed "
                    f"backend spec {b!r}: {e}")
                continue
            if known_backends is not None and base not in known_backends:
                problems.append(
                    f"[[tasks]] entry #{i} ({cell.family!r}): unknown "
                    f"backend {b!r}; known: {', '.join(known_backends)}")
    if problems:
        raise ValueError(
            f"suite {suite.name!r} failed validation:\n  "
            + "\n  ".join(problems))


@dataclass
class CellRun:
    """One executed cell (or rollout): its command and outcome."""

    cell: SuiteCell
    out_dir: str
    rollout: int  # 0 = primary run
    returncode: int
    stdout: str
    stderr: str

    @property
    def ok(self) -> bool:
        return self.returncode == 0

    @property
    def label(self) -> str:
        base = self.cell.family
        return base if self.rollout == 0 else f"{base}.r{self.rollout}"


@dataclass
class SuiteResult:
    """A completed campaign: every cell run + derived failure lists."""

    suite: Suite
    out_dir: str
    runs: List[CellRun] = field(default_factory=list)
    # (label, detail) pairs: cells that exited nonzero / rollouts whose
    # artifacts differed from the primary run's
    failures: List[Tuple[str, str]] = field(default_factory=list)
    mismatches: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures and not self.mismatches

    def summary(self) -> str:
        lines = []
        for r in self.runs:
            lines.append(f"{r.label}: {'ok' if r.ok else f'EXIT {r.returncode}'}")
        for label, detail in self.mismatches:
            lines.append(f"{label}: ROLLOUT MISMATCH {detail}")
        lines.append(
            f"suite {self.suite.name!r}: {len(self.runs)} cell run(s), "
            + ("all ok" if self.ok
               else f"{len(self.failures)} failure(s), "
                    f"{len(self.mismatches)} rollout mismatch(es)"))
        return "\n".join(lines)


def _src_root() -> str:
    # src/repro_torch/bench/suite.py -> the directory holding repro_torch
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def cell_command(suite: Suite, cell: SuiteCell, out_dir: str,
                 smoke: bool, python: str = sys.executable,
                 device: Optional[str] = None) -> List[str]:
    """The exact serial CLI a cell runs — one family of
    ``repro_torch.bench.run`` (``device``: where its wall clock runs)."""
    cmd = [python, "-m", "repro_torch.bench.run",
           "--only", cell.family,
           "--artifacts", out_dir,
           "--timer", suite.cell_timer(cell)]
    if smoke:
        cmd.append("--smoke")
    if cell.backends:
        cmd += ["--backends", ",".join(cell.backends)]
    if device is not None:
        cmd += ["--device", device]
    return cmd


def _run_cell(suite: Suite, cell: SuiteCell, out_dir: str, rollout: int,
              smoke: bool, python: str, cwd: str,
              env: Dict[str, str], device: Optional[str]) -> CellRun:
    os.makedirs(out_dir, exist_ok=True)
    proc = subprocess.run(
        cell_command(suite, cell, out_dir, smoke, python, device),
        capture_output=True, text=True, cwd=cwd, env=env)
    return CellRun(cell=cell, out_dir=out_dir, rollout=rollout,
                   returncode=proc.returncode,
                   stdout=proc.stdout, stderr=proc.stderr)


def rollout_dir(out_dir: str, cell: SuiteCell, rollout: int) -> str:
    return os.path.join(out_dir, "rollouts", f"{cell.family}.r{rollout}")


def _compare_rollout(primary_dir: str, rollout_run: CellRun,
                     ) -> List[Tuple[str, str]]:
    """Byte-compare a rollout's artifacts against the primary run's."""
    from .compare import bench_json_names

    mismatches = []
    names = bench_json_names(rollout_run.out_dir)
    if not names:
        mismatches.append((rollout_run.label,
                           "rollout wrote no BENCH_*.json artifacts"))
    for fname in names:
        primary = os.path.join(primary_dir, fname)
        current = os.path.join(rollout_run.out_dir, fname)
        if not os.path.exists(primary):
            mismatches.append(
                (rollout_run.label,
                 f"{fname} exists only in the rollout"))
        elif not filecmp.cmp(primary, current, shallow=False):
            mismatches.append(
                (rollout_run.label,
                 f"{fname} differs byte-wise from the primary run "
                 f"(nondeterminism on the deterministic timer)"))
    return mismatches


def run_suite(suite: Suite, out_dir: str, smoke: bool = False,
              python: str = sys.executable,
              cwd: Optional[str] = None,
              parallel: Optional[int] = None,
              device: Optional[str] = None) -> SuiteResult:
    """Execute every cell (and its rollouts) and collect the outcome.

    Cells run as ``repro_torch.bench.run`` subprocesses, at most
    ``parallel`` (default: the suite's ``parallel``) at a time; a
    nonzero cell never cancels the others.  Rollout byte-comparison
    applies only to synthetic-timer cells.
    """
    cwd = cwd or os.getcwd()
    env = dict(os.environ)
    src = _src_root()
    parts = [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p and p != src]
    env["PYTHONPATH"] = os.pathsep.join(parts)
    out_dir = os.path.abspath(out_dir)

    jobs = []  # (cell, rollout, dir)
    for cell in suite.cells:
        jobs.append((cell, 0, out_dir))
        for r in range(1, cell.rollouts):
            jobs.append((cell, r, rollout_dir(out_dir, cell, r)))

    nworkers = parallel if parallel is not None else suite.parallel
    result = SuiteResult(suite=suite, out_dir=out_dir)
    with ThreadPoolExecutor(max_workers=max(1, nworkers)) as pool:
        futures = [pool.submit(_run_cell, suite, cell, d, r, smoke,
                               python, cwd, env, device)
                   for cell, r, d in jobs]
        runs = [f.result() for f in futures]

    order = {(c.family, r): i for i, (c, r, _) in enumerate(jobs)}
    runs.sort(key=lambda cr: order[(cr.cell.family, cr.rollout)])
    result.runs = runs
    for cr in runs:
        if not cr.ok:
            tail = "\n".join((cr.stderr.strip() or cr.stdout.strip())
                             .splitlines()[-5:])
            result.failures.append((cr.label, tail))
    ok_primary = {cr.cell.family for cr in runs
                  if cr.rollout == 0 and cr.ok}
    for cr in runs:
        if (cr.rollout > 0 and cr.ok
                and cr.cell.family in ok_primary
                and suite.cell_timer(cr.cell) == "synthetic"):
            result.mismatches.extend(_compare_rollout(out_dir, cr))
    return result


def main(argv=None) -> None:
    from ..backends import backend_names
    from .compare import (bench_json_names, compare_dirs, format_report,
                          scenario_family)
    from .run import MODULES

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.suite",
                                 description="Run a TOML campaign of the "
                                             "port's bench families.")
    ap.add_argument("suite", help="TOML suite file (bench/suites/)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweeps (forwarded to every cell)")
    ap.add_argument("--artifacts", default="results/suite",
                    help="directory for the campaign's BENCH_*.json")
    ap.add_argument("--parallel", type=int, default=None,
                    help="override the suite's parallel cell count")
    ap.add_argument("--device", default=None,
                    help="where the cells' wall clocks run (default: the "
                         "card; 'cpu' for the CPU)")
    ap.add_argument("--baseline", default=None,
                    help="directory of BENCH_*.json to diff the campaign "
                         "against; exit nonzero on regression")
    ap.add_argument("--baseline-threshold", type=float, default=0.25,
                    help="relative slowdown tolerated by --baseline")
    ap.add_argument("--tables", action="store_true",
                    help="aggregate the campaign's artifacts into the "
                         "paper-style tables (bench.tables)")
    ap.add_argument("--tables-file", default="EXPERIMENTS_torch.md",
                    help="markdown file --tables appends to")
    args = ap.parse_args(argv)

    try:
        suite = load_suite(args.suite)
        validate_suite(suite, known_families=MODULES,
                       known_backends=backend_names())
    except (OSError, ValueError) as e:
        print(f"suite: {e}", file=sys.stderr)
        sys.exit(2)

    result = run_suite(suite, args.artifacts, smoke=args.smoke,
                       parallel=args.parallel, device=args.device)
    # the cells' CSV output is part of the campaign record — replay it
    # serially (one block per cell) so `suite ... | tee` is as greppable
    # as a serial run
    print("name,us_per_call,derived")
    for run in result.runs:
        for line in run.stdout.splitlines():
            if line and line != "name,us_per_call,derived":
                print(line)
    for label, detail in result.failures:
        last = detail.splitlines()[-1] if detail else ""
        print(f"suite,0,FAILED {label}: {last}", flush=True)
        if detail:
            print(f"suite: cell {label} failed:\n{detail}", file=sys.stderr)
    for line in result.summary().splitlines():
        print(f"suite,0,{line}", flush=True)

    if args.tables and not result.ok:
        print(f"suite: skipping --tables splice into {args.tables_file}: "
              f"the campaign is red and the artifact set is partial",
              file=sys.stderr)
    elif args.tables:
        from .tables import append_metg_tables

        tpath, skipped = append_metg_tables(result.out_dir, args.tables_file)
        note = f" ({skipped} invalid artifact(s) skipped)" if skipped else ""
        print(f"tables,0,{tpath}{note}", flush=True)

    regressed = False
    if args.baseline:
        # gate the scenario families this campaign actually produced;
        # baseline families outside the suite were not run
        fams = {scenario_family(f)
                for f in bench_json_names(result.out_dir)}
        skipped_fams = sorted({scenario_family(f)
                               for f in bench_json_names(args.baseline)
                               if scenario_family(f) not in fams})
        if skipped_fams:
            print(f"compare,0,skipping baseline families outside this "
                  f"campaign: {skipped_fams}", flush=True)
        results = compare_dirs(args.baseline, result.out_dir,
                               rel_threshold=args.baseline_threshold,
                               families=fams)
        for line in format_report(results).splitlines():
            print(f"compare,0,{line}", flush=True)
        regressed = any(not r.ok for r in results)

    if not result.ok or regressed:
        sys.exit(1)


if __name__ == "__main__":
    main()
