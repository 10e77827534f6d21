"""Append generated result tables to EXPERIMENTS_torch.md (a copy of the
reference's ``append_tables.py`` on the port's modules: it writes its own
file, so the reference's ``EXPERIMENTS.md`` tables stay as they are).

Two generators share the ``## §Tables (generated)`` marker (everything
after it is machine-written; text above survives):

* ``append_metg_tables`` — the paper-style METG(50%) summary (backend x
  case, one table per scenario family) aggregated from the port's
  ``BENCH_*.json`` artifacts a sweep wrote, plus the committed planner
  winners (``bench/tuning/TUNE_torch.json``).  Wired to
  ``python -m repro_torch.bench.run --tables`` and
  ``python -m repro_torch.bench.suite --tables``.
* ``append_dryrun_tables`` — the roofline tables from
  ``results/dryrun_torch.json`` (``launch.dryrun``).
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

MARKER = "## §Tables (generated)"


def load_metg_artifacts(artifacts_dir: str) -> Tuple[List[Dict], int]:
    """``(docs, skipped)``: schema-valid ``BENCH_*.json`` docs under
    ``artifacts_dir`` plus the count of files that failed validation.

    A corrupt or foreign artifact is not a table row, but silently
    dropping it makes a backend row vanish from EXPERIMENTS.md with no
    signal — each skip warns on stderr naming the path and reason, and
    the count is returned so callers (``run.py --tables``) can surface
    it next to the spliced-tables line.
    """
    from .artifact import read_bench_json

    docs: List[Dict] = []
    skipped = 0
    for path in sorted(glob.glob(os.path.join(artifacts_dir,
                                              "BENCH_*.json"))):
        try:
            docs.append(read_bench_json(path))
        except ValueError as e:
            skipped += 1
            print(f"append_tables: skipping {path}: {e}", file=sys.stderr)
    return docs, skipped


def _case_name(scenario: Dict) -> str:
    """The column label: the scenario name minus family and backend
    segments (``metg.xla-scan.stencil`` -> ``stencil``)."""
    parts = scenario["name"].split(".")
    rest = [p for p in parts[1:] if p != scenario["backend"]]
    return ".".join(rest) or scenario["pattern"]


def render_metg_summary(docs: List[Dict]) -> str:
    """Markdown METG(50%) tables, one per scenario family (µs cells;
    ``>sweep`` marks a curve that never reached 50% in its range —
    the floor sits above the whole sweep)."""
    families: Dict[str, Dict] = defaultdict(dict)
    for doc in docs:
        if doc.get("kind") != "metg_sweep":
            continue  # serve_load docs render via render_serve_summary
        sc = doc["scenario"]
        families[sc["name"].split(".")[0]][(sc["backend"],
                                           _case_name(sc))] = doc
    out = []
    for fam in sorted(families):
        cells = families[fam]
        backends = sorted({b for b, _ in cells})
        cases = sorted({c for _, c in cells})
        out.append(f"\n### METG(50%) — {fam} (µs; '>sweep' = no 50% "
                   f"crossing in the sweep range)\n")
        out.append("| backend | " + " | ".join(cases) + " |")
        out.append("|---" * (len(cases) + 1) + "|")
        for b in backends:
            row = [b]
            for c in cases:
                doc = cells.get((b, c))
                if doc is None:
                    row.append("—")
                elif doc["metg_s"] is None:
                    row.append(">sweep")
                else:
                    row.append(f"{doc['metg_s'] * 1e6:.2f}")
            out.append("| " + " | ".join(row) + " |")
        out.append("")
    return "\n".join(out)


def render_serve_summary(docs: List[Dict]) -> str:
    """Markdown serve_load table: decode mode x arrival rate, percentile
    latencies + decode throughput + host syncs per token (empty string
    when no serve_load artifacts are present)."""
    cells = {}
    for doc in docs:
        if doc.get("kind") != "serve_load":
            continue
        sc = doc["scenario"]
        cells[(sc["mode"], float(sc["rate_rps"]))] = doc
    if not cells:
        return ""
    out = [
        "\n### serve_load — open-loop serving latency "
        "(host per-token loop vs on-device chunked decode)\n",
        "| mode | rate (req/s) | TTFT p50/p95 (ms) | TPOT p50/p95 (µs) "
        "| thr (tok/s) | goodput (req/s) | syncs/token |",
        "|---|---|---|---|---|---|---|",
    ]
    for (mode, rate) in sorted(cells, key=lambda k: (k[0], k[1])):
        m = cells[(mode, rate)]["metrics"]
        out.append(
            f"| {mode} | {rate:g} "
            f"| {m['ttft_s']['p50'] * 1e3:.3f}/{m['ttft_s']['p95'] * 1e3:.3f} "
            f"| {m['tpot_s']['p50'] * 1e6:.1f}/{m['tpot_s']['p95'] * 1e6:.1f} "
            f"| {m['throughput_tok_s']:.0f} "
            f"| {m['goodput_rps']:.0f} "
            f"| {m['host_syncs_per_token']:.3f} |")
    out.append("")
    return "\n".join(out)


def render_scaling_summary(docs: List[Dict]) -> str:
    """Markdown weak-scaling table: one row per ``metg_scaling`` series,
    weak-scaling efficiency ``T(1)/T(n)`` per rank count at the coarsest
    granularity, plus the finest-granularity efficiency at the top rank
    count (the contour's floor corner).  Empty string when no
    ``metg_scaling`` artifacts are present."""
    series = [d for d in docs if d.get("kind") == "metg_scaling"]
    if not series:
        return ""
    ranks = sorted({c["ranks"] for d in series for c in d["cells"]})
    out = [
        "\n### Weak scaling — metg_scaling (fixed work per rank; "
        "weak-scaling efficiency T(1)/T(n), ideal 1.0)\n",
        "| backend | " + " | ".join(f"r={n}" for n in ranks)
        + " | eff@finest (top ranks) |",
        "|---" * (len(ranks) + 2) + "|",
    ]
    for d in sorted(series, key=lambda d: d["scenario"]["name"]):
        cells = {c["ranks"]: c for c in d["cells"]}
        row = [d["scenario"]["backend"]]
        for n in ranks:
            c = cells.get(n)
            row.append("—" if c is None else f"{c['weak_efficiency']:.3f}")
        top = cells[max(cells)]
        fine = min(top["points"], key=lambda p: p["iterations"])
        row.append(f"{fine['weak_efficiency']:.3f} "
                   f"@ {fine['granularity_s'] * 1e6:.2f} µs")
        out.append("| " + " | ".join(row) + " |")
    out.append("")
    return "\n".join(out)


TUNING_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tuning")


def render_tuning_summary(tuning_dir: str = TUNING_DIR) -> str:
    """Markdown table of the committed planner winners: one row per
    tuning key, grouped by family (what ``get_backend("torch-auto")``
    dispatches where, and by how much the winner beat the runner-up).
    Empty string when no committed table exists."""
    from .tuner import (TuningKey, key_order, key_slug, read_tuning_json,
                        tuning_table_path)

    path = tuning_table_path(tuning_dir)
    if not os.path.exists(path):
        return ""
    doc = read_tuning_json(path)
    by_family: Dict[str, List[Dict]] = defaultdict(list)
    for e in doc["entries"]:
        by_family[e["family"]].append(e)
    out = [
        f"\n### Auto-backend tuning winners — timer {doc['timer']} "
        f"(`get_backend(\"torch-auto\")` dispatch table; margin = cost of the "
        f"next-best distinct candidate)\n",
    ]
    for fam in sorted(by_family):
        out.append(f"\n#### {fam}\n")
        out.append("| tuning key | winner | elapsed (µs) | margin |")
        out.append("|---|---|---|---|")
        entries = sorted(by_family[fam],
                         key=lambda e: key_order(TuningKey(**e["key"])))
        for e in entries:
            out.append(
                f"| {key_slug(TuningKey(**e['key']))} | `{e['winner']}` "
                f"| {e['elapsed_s'] * 1e6:.2f} | +{e['margin']:.1%} |")
        out.append("")
    return "\n".join(out)


def _splice(md_path: str, body: str) -> str:
    """Replace everything after the marker with ``body`` (creating the
    file, or the marker section, when missing)."""
    if os.path.exists(md_path):
        text = open(md_path).read()
    else:
        text = "# Experiments\n\n" + MARKER + "\n"
    if MARKER not in text:
        text = text.rstrip() + "\n\n" + MARKER + "\n"
    text = text[: text.index(MARKER) + len(MARKER)] + "\n" + body
    with open(md_path, "w") as f:
        f.write(text)
    return md_path


def append_metg_tables(artifacts_dir: str,
                       md_path: str = "EXPERIMENTS_torch.md",
                       tuning_dir: str = None) -> Tuple[str, int]:
    """Aggregate ``BENCH_*.json`` under ``artifacts_dir`` into the METG,
    serve-load and weak-scaling summaries (plus the committed
    auto-backend tuning winners) and splice them into ``md_path``;
    returns ``(path_written, artifacts_skipped)``."""
    docs, skipped = load_metg_artifacts(artifacts_dir)
    if not docs:
        raise ValueError(
            f"no valid BENCH_*.json artifacts in {artifacts_dir!r}"
            + (f" ({skipped} skipped as invalid)" if skipped else ""))
    if tuning_dir is None:
        tuning_dir = TUNING_DIR
    path = _splice(md_path,
                   render_metg_summary(docs) + render_serve_summary(docs)
                   + render_scaling_summary(docs)
                   + render_tuning_summary(tuning_dir) + "\n")
    return path, skipped


def append_dryrun_tables(dryrun_json: str = "results/dryrun_torch.json",
                         md_path: str = "EXPERIMENTS_torch.md") -> str:
    """Roofline tables from the dry-run results."""
    import json

    from ..launch.report import (hbm_total_gb, render_dryrun_table,
                                 render_roofline_table, row_terms)

    results = json.load(open(dryrun_json))
    out = []
    out.append("\n### Roofline — single pod 16x16 (256 ranks), "
               "strategy tp+fsdp+sp\n")
    out.append("(memory term excludes the attention-quadratic traffic K5 "
               "keeps on chip; decode rows score bandwidth fraction)\n")
    out.append(render_roofline_table(results, "pod16x16", "tp+fsdp+sp"))
    out.append("\n\n### Strategy comparison — qwen1.5-0.5b train_4k "
               "(§Perf B)\n")
    out.append("| strategy | compute_s | memory_s | collective_s | "
               "bound_s | frac | HBM GB |")
    out.append("|---|---|---|---|---|---|---|")
    for strat in ("tp+fsdp+sp", "dp_heavy", "dp_mod"):
        key = f"qwen1.5-0.5b|train_4k|pod16x16|{strat}"
        v = results.get(key)
        if not v or v["status"] != "ok":
            continue
        t = row_terms(v)
        out.append(
            f"| {strat} | {t['compute_s']:.3f} | {t['memory_s']:.3f} "
            f"| {t['collective_s']:.3f} | {t['bound_step_s']:.3f} "
            f"| {t['roofline_fraction'] * 100:.2f}% | {hbm_total_gb(v):.1f} |")
    out.append("\n\n### Dry-run detail — both meshes, strategy tp+fsdp+sp\n")
    out.append(render_dryrun_table(results, "tp+fsdp+sp"))
    out.append("")
    return _splice(md_path, "\n".join(out))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--artifacts", default=None,
                    help="BENCH_*.json directory -> METG summary tables")
    ap.add_argument("--dryrun-json", default=None,
                    help="results/dryrun_torch.json -> roofline tables")
    ap.add_argument("--out", default="EXPERIMENTS_torch.md")
    args = ap.parse_args(argv)
    if not args.artifacts and not args.dryrun_json:
        ap.error("nothing to do: pass --artifacts and/or --dryrun-json")
    if args.artifacts:
        path, skipped = append_metg_tables(args.artifacts, args.out)
        note = f" ({skipped} invalid artifact(s) skipped)" if skipped else ""
        print(f"tables appended: {path}{note}")
    if args.dryrun_json:
        print(f"tables appended: "
              f"{append_dryrun_tables(args.dryrun_json, args.out)}")


if __name__ == "__main__":
    main()
