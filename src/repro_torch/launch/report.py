"""Render the roofline and dry-run tables from ``results/dryrun_torch.json``
(the port of ``repro.launch.report``, with the H100's rates and its 80 GB
of device memory).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

from ..configs import SHAPES, get_config
from .roofline import roofline_terms

CHIPS = {"pod16x16": 256, "pod2x16x16": 512}
DEVICE_GB = 80.0  # an H100's device memory


def fmt_si(x: float, unit: str = "") -> str:
    for div, suf in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(x) >= div:
            return f"{x / div:.2f}{suf}{unit}"
    return f"{x:.2f}{unit}"


def row_terms(v: Dict) -> Dict:
    cfg = get_config(v["arch"])
    shape = SHAPES[v["shape"]]
    analysis = {
        "flops": v.get("flops_per_device", 0.0),
        "hbm_bytes": v.get("hbm_bytes_per_device", 0.0),
        "collectives": v.get("collectives", {"total": 0.0}),
    }
    return roofline_terms(analysis, cfg, shape, CHIPS[v["mesh"]])


def hbm_total_gb(v: Dict) -> float:
    m = v["memory"]
    return m["argument_gb"] + m["temp_gb"] + m["output_gb"] - m["alias_gb"]


def render_roofline_table(results: Dict, mesh: str = "pod16x16",
                          strategy: str = "tp+fsdp+sp") -> str:
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant |"
        " 6ND/HLO | roofline_frac | HBM GB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        v = results[key]
        if v["mesh"] != mesh or v.get("strategy") != strategy:
            continue
        if v["status"] == "skip":
            lines.append(
                f"| {v['arch']} | {v['shape']} | — | — | — | skip |"
                f" — | — | — | ({v['reason']}) |")
            continue
        if v["status"] != "ok":
            lines.append(f"| {v['arch']} | {v['shape']} | ERROR |||||||{v.get('error','')[:40]}|")
            continue
        t = row_terms(v)
        gb = hbm_total_gb(v)
        fits = "yes" if gb <= DEVICE_GB else "**NO**"
        lines.append(
            f"| {v['arch']} | {v['shape']} "
            f"| {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['collective_s']:.4f} | {t['dominant'].replace('_s','')} "
            f"| {t['useful_ratio']:.3f} | {t['roofline_fraction']*100:.2f}% "
            f"| {gb:.1f} | {fits} |")
    return "\n".join(lines)


def render_dryrun_table(results: Dict, strategy: str = "tp+fsdp+sp") -> str:
    lines = [
        "| arch | shape | mesh | compile_s | args GB | temp GB | alias GB |"
        " flops/dev | HLO bytes/dev | coll bytes/dev | a2a | ag | ar | rs | cp |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        v = results[key]
        if v.get("strategy") != strategy or v["status"] != "ok":
            continue
        m, c = v["memory"], v["collectives"]
        lines.append(
            f"| {v['arch']} | {v['shape']} | {v['mesh']} | {v['compile_s']} "
            f"| {m['argument_gb']:.2f} | {m['temp_gb']:.2f} "
            f"| {m['alias_gb']:.2f} | {fmt_si(v['flops_per_device'])} "
            f"| {fmt_si(v['hbm_bytes_per_device'])} | {fmt_si(c['total'])} "
            f"| {fmt_si(c.get('all-to-all', 0))} "
            f"| {fmt_si(c.get('all-gather', 0))} "
            f"| {fmt_si(c.get('all-reduce', 0))} "
            f"| {fmt_si(c.get('reduce-scatter', 0))} "
            f"| {fmt_si(c.get('collective-permute', 0))} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch.json")
    ap.add_argument("--mode", default="roofline",
                    choices=["roofline", "dryrun", "pick"])
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--strategy", default="tp+fsdp+sp")
    args = ap.parse_args()
    with open(args.results) as f:
        results = json.load(f)
    if args.mode == "roofline":
        print(render_roofline_table(results, args.mesh, args.strategy))
    elif args.mode == "dryrun":
        print(render_dryrun_table(results, args.strategy))
    else:  # pick hillclimb candidates
        rows = []
        for key, v in results.items():
            if v["status"] != "ok" or v["mesh"] != args.mesh \
                    or v.get("strategy") != args.strategy:
                continue
            t = row_terms(v)
            rows.append((t["roofline_fraction"], key, t["dominant"],
                         t["collective_s"], hbm_total_gb(v)))
        rows.sort()
        print("worst roofline fractions:")
        for frac, key, dom, coll, gb in rows[:8]:
            print(f"  {frac*100:6.2f}%  {key}  dom={dom} coll={coll:.3f}s "
                  f"hbm={gb:.1f}GB")
        rows.sort(key=lambda r: -r[3])
        print("most collective-bound (seconds):")
        for frac, key, dom, coll, gb in rows[:8]:
            print(f"  {coll:8.3f}s {key}  frac={frac*100:.2f}%")


if __name__ == "__main__":
    main()
