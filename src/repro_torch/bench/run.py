"""The port's benchmark runner: one family per paper table or figure.

The counterpart of the reference's ``benchmarks/run.py`` over the port's
backends.  Prints ``name,us_per_call,derived`` CSV and writes one
schema-checked ``BENCH_<scenario>.json`` per scenario into
``--artifacts``.  The families (``bench.families``):

  bench_peak             Figures 2/6 (peak FLOP/s), Figure 8 (peak B/s)
  bench_metg_patterns    Figure 9 (METG x backend x pattern)
  bench_metg_deps        Figure 10 (METG vs deps/task)
  bench_overlap          Figure 11 (communication overlap)
  bench_imbalance        Figure 12 (load imbalance)
  bench_metg_scaling     Figures 4/5 (§V-D/E): weak-scaling efficiency,
                         rank sweep {1,2,4,8} in this process, the rank
                         count a backend option (``--ranks`` narrows it)
  bench_metg_validation  Figure 14 / Table 6 (METG predicts the limit)
  bench_model_step       §V-C applied to the port's own training runtime:
                         a train step's time a layer against the dispatch
                         floor (always on the wall clock)
  bench_moe_dispatch     MoE dispatch comm volume (SP-aware EP vs token
                         replication): analytic a2a bytes at the link rate
  bench_metg_payload     §V-F study: communication hiding — payload sweep,
                         comm_overlap on/off (overlap-efficiency curve)
  bench_metg_imbalance   §V-G study: imbalance mitigation — work stealing
                         vs static schedule (mitigation-factor curve)
  bench_serve_load       serving: open-loop TTFT / TPOT / latency
                         percentiles, host vs chunked decode, 3 rates

Run all: ``PYTHONPATH=src python -m repro_torch.bench.run``
One:     ``... --only bench_metg_deps`` (``--only`` entries are validated
against the list above: a typo'd family exits nonzero instead of running
zero benchmarks).
Smoke:   ``... --smoke`` — tiny sweeps, one repeat, shallow graphs.
Timer:   ``--timer synthetic`` runs on the deterministic fake clock (no
backend or engine is built, so no card is needed); ``--timer wallclock``
(the default) runs the backends and the serving engine, on the card
unless ``--device cpu``.

Tuning: ``--tune`` regenerates the planner table consumed by
``get_backend("torch-auto")`` (``bench.tuner``) instead of running
families — commit it with ``python -m repro_torch.bench.run --tune --timer
synthetic --artifacts src/repro_torch/bench/tuning``; ``--tune-baseline
src/repro_torch/bench/tuning`` diffs a regenerated table against the
committed one (``--smoke`` tunes the reduced grid, a strict key-subset of
the full table).

Regression gate: ``--baseline <dir>`` diffs every written artifact against
a snapshot of port artifacts (``bench.compare``) and exits nonzero when a
scenario regressed beyond ``--baseline-threshold``.

Tables: ``--tables`` splices the METG, serve-load and weak-scaling
summaries of the written artifacts, and the committed planner winners,
into ``--tables-file`` (``EXPERIMENTS_torch.md``; ``bench.tables``), only
when every family ran.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

MODULES = [
    "bench_peak",
    "bench_metg_patterns",
    "bench_metg_deps",
    "bench_overlap",
    "bench_imbalance",
    "bench_metg_scaling",
    "bench_metg_validation",
    "bench_model_step",
    "bench_moe_dispatch",
    "bench_metg_payload",
    "bench_metg_imbalance",
    "bench_serve_load",
]


def _run_tune(args) -> None:
    """``--tune``: regenerate the planner's tuning table.

    Races every legal backend/mode spec on the selected timer over the
    tuning corpus (reduced grid under ``--smoke``), writes the validated
    ``TUNE_torch.json`` into ``--artifacts``, and — with
    ``--tune-baseline`` — diffs it against the committed table: a changed
    winner at a shared key exits nonzero, keys the reduced grid did not
    retune are non-fatal notes.
    """
    from .timers import SyntheticTimer, WallClockTimer
    from .tuner import (TuningKey, build_tuning_table, diff_tuning_tables,
                        key_slug, read_tuning_json, tuning_table_path,
                        write_tuning_json)

    timer = (SyntheticTimer() if args.timer == "synthetic"
             else WallClockTimer())
    doc = build_tuning_table(timer=timer, smoke=args.smoke)
    print("name,us_per_call,derived")
    for e in doc["entries"]:
        print(f"tune.{key_slug(TuningKey(**e['key']))},"
              f"{e['elapsed_s'] * 1e6:.3f},"
              f"winner={e['winner']} margin=+{e['margin']:.1%} "
              f"candidates={len(e['candidates'])}", flush=True)
    path = write_tuning_json(doc, args.artifacts)
    print(f"artifact,0,{path}", flush=True)

    fatal = []
    if args.tune_baseline:
        bpath = args.tune_baseline
        if os.path.isdir(bpath):
            bpath = tuning_table_path(bpath)
        fatal, notes = diff_tuning_tables(read_tuning_json(bpath), doc,
                                          subset_ok=args.smoke)
        for n in notes:
            print(f"tune-diff,0,{n}", flush=True)
        for f in fatal:
            print(f"tune-diff,0,FATAL {f}", flush=True)
        print("tune-diff,0,"
              + (f"{len(fatal)} fatal difference(s)" if fatal
                 else "winners match the committed table"), flush=True)
    if fatal:
        sys.exit(1)


def _ranks(text: str):
    ranks = tuple(int(n) for n in text.split(",") if n.strip())
    if not ranks:
        raise argparse.ArgumentTypeError("empty rank list")
    return ranks


def main(argv=None) -> None:
    from .families.common import BenchContext

    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run")
    ap.add_argument("--only", default=None,
                    help="comma-separated family names")
    ap.add_argument("--backends", default=None,
                    help="comma-separated backend spec filter for the "
                         "families that honor it (matched canonically; a "
                         "family whose filtered backend set is empty "
                         "raises, so a typo'd spec cannot green-light a "
                         "zero-cell run)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweeps: few points, one repeat")
    ap.add_argument("--artifacts", default="results/bench",
                    help="directory for BENCH_<scenario>.json artifacts "
                         "('' disables)")
    ap.add_argument("--timer", choices=("wallclock", "synthetic"),
                    default="wallclock",
                    help="wallclock: real runs; synthetic: deterministic "
                         "fake clock (machine-independent artifacts)")
    ap.add_argument("--device", default=None,
                    help="where the wall clock's backends run (default: "
                         "the card; 'cpu' for the CPU)")
    ap.add_argument("--ranks", type=_ranks, default=None,
                    help="comma-separated rank counts of "
                         "bench_metg_scaling, ascending from 1 (default "
                         "1,2,4,8)")
    ap.add_argument("--baseline", default=None,
                    help="directory of BENCH_*.json to diff against; exit "
                         "nonzero on regression")
    ap.add_argument("--baseline-threshold", type=float, default=0.25,
                    help="relative slowdown tolerated by --baseline")
    ap.add_argument("--tables", action="store_true",
                    help="aggregate this run's BENCH_*.json artifacts into "
                         "the paper-style METG summary table and append it "
                         "to --tables-file (bench.tables)")
    ap.add_argument("--tables-file", default="EXPERIMENTS_torch.md",
                    help="markdown file --tables appends to")
    ap.add_argument("--tune", action="store_true",
                    help="regenerate the planner's tuning table "
                         "(bench.tuner) instead of running families: races "
                         "the legal backend/mode space on the selected "
                         "timer and writes TUNE_torch.json into "
                         "--artifacts; --smoke tunes the reduced grid")
    ap.add_argument("--tune-baseline", default=None,
                    help="committed tuning table (TUNE_*.json file or its "
                         "directory) to diff the regenerated table "
                         "against; a changed winner exits nonzero")
    args = ap.parse_args(argv)
    if args.baseline and not args.artifacts:
        ap.error("--baseline requires --artifacts (the current run's "
                 "artifacts are what gets compared)")
    if args.tables and not args.artifacts:
        ap.error("--tables requires --artifacts (the tables aggregate "
                 "the written artifacts)")
    if args.tune_baseline and not args.tune:
        ap.error("--tune-baseline requires --tune (there is no current "
                 "table to diff otherwise)")
    if args.tune:
        if args.only:
            ap.error("--tune runs the planner sweep, not families; drop "
                     "--only")
        if not args.artifacts:
            ap.error("--tune requires --artifacts (where TUNE_*.json "
                     "is written)")
        _run_tune(args)
        return
    mods = MODULES
    if args.only:
        mods = [m.strip() for m in args.only.split(",") if m.strip()]
        unknown = sorted(set(mods) - set(MODULES))
        if unknown or not mods:
            # a misspelled family silently running ZERO benchmarks (and
            # exiting 0) is the failure mode here — name the bad entry
            # and the registry
            ap.error(f"--only: unknown bench family(s) "
                     f"{', '.join(unknown) or '(empty)'}; known families: "
                     f"{', '.join(MODULES)}")
    timer = None
    if args.timer == "synthetic":
        from .timers import SyntheticTimer

        timer = SyntheticTimer()
    backends = None
    if args.backends:
        backends = [b.strip() for b in args.backends.split(",") if b.strip()]
        if not backends:
            ap.error("--backends: empty filter")
    ctx = BenchContext(smoke=args.smoke,
                       artifacts_dir=args.artifacts or None,
                       timer=timer, backends=backends, device=args.device,
                       ranks=args.ranks)

    print("name,us_per_call,derived")
    failures = []
    for name in mods:
        mod = importlib.import_module(f"{__package__}.families.{name}")
        t0 = time.time()
        try:
            rows = mod.run(ctx)
        except Exception as e:  # keep the remaining families running
            failures.append((name, e))
            print(f"{name}.ERROR,0,{type(e).__name__}: {e}", flush=True)
            continue
        for row in rows:
            print(row.csv(), flush=True)
        print(f"{name}.elapsed,{(time.time() - t0) * 1e6:.0f},", flush=True)
    for path in ctx.written:
        print(f"artifact,0,{path}", flush=True)

    if args.tables and failures:
        # a red run wrote only part of the artifact set; regenerating the
        # tables from it would silently drop the failed families' rows
        print(f"run: skipping --tables splice into {args.tables_file}: "
              f"{len(failures)} bench family(s) failed and the artifact "
              f"set is partial", file=sys.stderr)
    elif args.tables:
        from .tables import append_metg_tables

        tpath, skipped = append_metg_tables(args.artifacts, args.tables_file)
        note = f" ({skipped} invalid artifact(s) skipped)" if skipped else ""
        print(f"tables,0,{tpath}{note}", flush=True)

    regressed = False
    if args.baseline:
        from .compare import (bench_json_names, compare_dirs, format_report,
                              scenario_family)

        # a partial run (--only) only remeasures some scenario families;
        # gate just those — baselines outside them were not run
        fams = None
        if args.only:
            fams = {scenario_family(p) for p in ctx.written}
            skipped = [f for f in bench_json_names(args.baseline)
                       if scenario_family(f) not in fams]
            if skipped:
                print(f"compare,0,skipping {len(skipped)} baseline "
                      f"artifact(s) outside this partial run (families "
                      f"{sorted({scenario_family(f) for f in skipped})})",
                      flush=True)
        results = compare_dirs(args.baseline, args.artifacts,
                               rel_threshold=args.baseline_threshold,
                               families=fams)
        for line in format_report(results).splitlines():
            print(f"compare,0,{line}", flush=True)
        regressed = any(not r.ok for r in results)

    if failures or regressed:
        sys.exit(1)


if __name__ == "__main__":
    main()
