"""Time the fused Task Bench kernels K3 and K4 of two trees on one card.

    python3 tools/ab_sync.py --ab OTHER   # runs OTHER, this tree, this tree, OTHER
    python3 tools/ab_sync.py [--tree DIR] # one tree (default: this one)

OTHER is an unpacked copy of another commit's ``src/repro_torch``, for
example ``git archive <commit> src/repro_torch | tar -x -C build/parent``
(``build/`` is listed in ``.gitignore``, so the copy is never committed).
Each run is a process of its own that imports ``repro_torch`` from
``DIR/src`` and builds that tree's kernels under ``DIR/build``; the runs
alternate, so a drift of the card shows as a difference between the two
runs of one tree.  At the main path's shape (stencil, W=132, H=1000, 16
compute iterations, 16-byte payloads) a run prints one JSON line:

- ``k3``, ``k4``: K3 and K4 at 132 ranks on that graph; ``k3_empty``,
  ``k4_empty``: the same graph with the empty body (the synchronization
  floor); ``k4_4ranks``: K4 at 4 ranks (33 tasks a CTA a timestep).  Each
  with ``device_ms`` (the mean duration of the launches ``torch.profiler``
  records, the median of three windows, every window in ``windows``),
  ``us_a_step`` (device ms over H) and ``stream_ms`` (CUDA events around
  the same calls: memsets and gaps between launches included);
- ``metg_us``: METG(50 %) of ``cuda-fused`` and
  ``cuda-fused[comm=onesided,ranks=132]`` from ``run_scenario`` on the wall
  clock over iterations 4096 -> 1 (7 points, best of 3), as phase 6 of
  ``chip_smoke.py`` measures it;
- ``card``: the card's name and power limit (nvidia-smi).

With ``--ab`` the last line is one JSON object holding the four runs.
Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDTH, HEIGHT, ITERS = 132, 1000, 16
WINDOWS = 3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timed(fn, reps: int, key: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(2 * WINDOWS):  # the profiler can miss whole launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and key in e.name]
        if us:
            windows.append(sum(us) / len(us) / 1e3)
        if len(windows) == WINDOWS:
            break
    if not windows:
        raise RuntimeError(f"the profiler recorded no {key} launch")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    device = statistics.median(windows)
    return {"device_ms": device, "us_a_step": device / HEIGHT * 1e3,
            "windows": windows, "stream_ms": start.elapsed_time(end) / reps}


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.backends.megakernel import (
        MegakernelBackend, onesided_tables_from_numpy, tables_from_numpy,
        taskbench_fused, taskbench_onesided)
    from repro_torch.bench import ScenarioSpec, SweepControls, run_scenario
    from repro_torch.core import KernelSpec, make_graph
    from repro_torch.dist import plan_comm

    if not torch.cuda.is_available():
        raise SystemExit("ab_sync: no CUDA device available")
    dev = torch.device("cuda")
    stencil = make_graph(width=WIDTH, height=HEIGHT, pattern="stencil",
                         kernel="compute", iterations=ITERS, output_bytes=16)
    empty = stencil.with_kernel(KernelSpec(kind="empty"))

    def fused(graph):
        tabs = tables_from_numpy(MegakernelBackend._tables(
            [graph], max(1, graph.max_radix())), dev)
        kw = dict(kernel=graph.kernel, ngraphs=1, height=HEIGHT,
                  payload_elems=graph.payload_elems)
        return lambda: taskbench_fused(*tabs, **kw)

    def onesided(graph, ranks):
        plan = plan_comm(graph, ranks, "cols", comm="onesided")
        tabs = onesided_tables_from_numpy(
            *MegakernelBackend._onesided_tables(graph, plan), dev)
        kw = dict(kernel=graph.kernel, height=HEIGHT,
                  payload_elems=graph.payload_elems)
        return lambda: taskbench_onesided(*tabs, **kw)

    out = {"tree": str(tree), "card": card()}
    out["k3"] = timed(fused(stencil), 10, "fused_kernel")
    out["k3_empty"] = timed(fused(empty), 10, "fused_kernel")
    out["k4"] = timed(onesided(stencil, WIDTH), 10, "onesided_kernel")
    out["k4_empty"] = timed(onesided(empty, WIDTH), 10, "onesided_kernel")
    out["k4_4ranks"] = timed(onesided(stencil, 4), 5, "onesided_kernel")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["metg_us"] = {}
    for be in ("cuda-fused", f"cuda-fused[comm=onesided,ranks={WIDTH}]"):
        res = run_scenario(ScenarioSpec(
            name=f"ab.{be}", backend=be, pattern="stencil", kernel="compute",
            width=WIDTH, height=HEIGHT, cores=sms,
            sweep=SweepControls(iterations_hi=4096, n_points=7, repeats=3,
                                warmup=1)))
        out["metg_us"][be] = None if res.metg_s is None else res.metg_s * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="tree whose src/repro_torch is timed")
    ap.add_argument("--ab", type=Path, default=None,
                    help="the other tree: time it and this one in turns")
    args = ap.parse_args()
    if args.ab is None:
        print(json.dumps(measure(args.tree.resolve())), flush=True)
        return 0
    runs = []
    for label, tree in (("other", args.ab), ("this", ROOT), ("this", ROOT),
                        ("other", args.ab)):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--tree",
             str(tree.resolve())], capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"ab_sync: the {label} run failed (exit {proc.returncode})")
            return proc.returncode
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = label
        print(json.dumps(run), flush=True)
        runs.append(run)
    for key in ("k3", "k3_empty", "k4", "k4_empty", "k4_4ranks"):
        print(f"{key:10s} " + "  ".join(
            f"{r['label']} {r[key]['device_ms']:.6f} ms "
            f"({r[key]['us_a_step']:.4f} us a step)" for r in runs))
    for be in runs[0]["metg_us"]:
        print(f"METG {be}: " + "  ".join(
            f"{r['label']} {r['metg_us'][be]}" for r in runs))
    print(json.dumps({"ab": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
