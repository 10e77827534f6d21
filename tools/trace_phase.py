"""The port's recorder (``repro_torch.trace``) on the card: K3's two
instances, what recording costs, and the split of the device's idle time.

    python3 tools/trace_phase.py [--parent DIR] [--seconds S] [--seed N]

``--parent`` is an unpacked copy of another commit's ``src/repro_torch``,
for example ``git archive <commit> src/repro_torch | tar -x -C
build/parent`` (``build/`` is listed in ``.gitignore``).  Each part prints
JSON lines:

``sass``
    both trees' ``kernels/csrc/fused.cu`` compiled to a cubin for
    ``sm_90a``: whether this tree's untraced ``fused_kernel`` has the
    parent's SASS instruction for instruction, and each K3 instance's
    registers and spills (``ptxas -v``);
``cost``
    for ``stencil-compute.fused-i64`` and ``stencil-memory.fused``, in one
    process each: the benchmark's loop (``portbench/loops``), warmed, then
    windows of S seconds with recording off and on, in the order off on on
    off off on: each window's tasks/s and, for the windows with it on, the
    mean of each span, K3's wait share (all CTAs, and the least and most
    of one CTA) and late tasks, and the least share of a run that
    ``launch``, ``wait`` and ``copy`` cover;
``after``
    for the two compute cells, in one process each: the spans of 0.25 s of
    the run loop with recording on, before and after 0.25 s under the
    profiler;
``idle``
    for the two compute cells: 0.5 s of the run loop under the profiler
    (the device alone) with recording on, the device's idle time split by
    what the host was in (``portbench/recorded.py::idle_by_host``).

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

COST_CELLS = ("stencil-compute.fused-i64", "stencil-memory.fused")
IDLE_CELLS = ("stencil-compute.fused-i64", "stencil-compute.graph-i64")
ORDER = (False, True, True, False, False, True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cubin(csrc: Path, out: Path) -> str:
    from repro_torch.kernels import _build

    proc = subprocess.run(
        [_build.find_nvcc(), _build.ARCH, "-std=c++17", "-O3", "-Xptxas",
         "-v", "-cubin", "-I", str(csrc), str(csrc / "fused.cu"), "-o",
         str(out)], capture_output=True, text=True, check=True)
    return proc.stdout + proc.stderr


def kernel_sass(path: Path, traced: bool) -> list:
    """The SASS of ``fused_kernel`` (or ``fused_kernel_traced``), found by
    its mangled, length-prefixed name."""
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    text = subprocess.run([str(nvcc / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    name = "fused_kernel_traced" if traced else "fused_kernel"
    for block in text.split("Function : ")[1:]:
        head, _, body = block.partition("\n")
        if f"{len(name)}{name}E" in head:
            return [line.split("*/", 1)[-1].strip()
                    for line in body.splitlines() if "/*" in line]
    raise RuntimeError(f"no {name} in {path}")


def sass(parent: Path) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        mine, theirs = Path(tmp) / "mine.cubin", Path(tmp) / "parent.cubin"
        log = cubin(ROOT / "src/repro_torch/kernels/csrc", mine)
        cubin(parent / "src/repro_torch/kernels/csrc", theirs)
        a, b = kernel_sass(mine, False), kernel_sass(theirs, False)
        traced = kernel_sass(mine, True)
    usage = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    return {"part": "sass", "untraced_equal_to_parent": a == b,
            "untraced_instructions": len(a), "parent_instructions": len(b),
            "traced_instructions": len(traced), "ptxas": usage}


def loop_for(workload: str, seed: int):
    import torch
    from portbench import harness

    cell = harness.resolve(workload, ROOT)
    mod = harness.load_module(
        ROOT / "portbench" / "loops" / f"{cell.traffic['loop']}.py", "loop")
    loop = mod.Loop(cell.config, cell.traffic, seed, torch.device("cuda", 0))
    for _ in range(int(cell.traffic.get("warm_runs", 2))):
        loop.run()
    gc.collect()
    gc.freeze()  # as the harness does before its window
    return loop


def window(loop, seconds: float) -> tuple:
    clock, runs = time.perf_counter, 0
    w0 = clock()
    while True:
        loop.run()
        runs += 1
        t1 = clock()
        if t1 - w0 >= seconds:
            return runs, t1 - w0


class GcLog:
    """The garbage collector's passes while in the block: (generation,
    start_ns, end_ns)."""

    def __init__(self):
        self.passes, self._t0 = [], 0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.time_ns()
        else:
            self.passes.append((info["generation"], self._t0, time.time_ns()))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def short_runs(spans, passes, below: float = 0.95) -> dict:
    """The runs that ``launch``, ``wait`` and ``copy`` cover less than
    ``below`` of, and how many of those a collection overlapped."""
    from portbench import recorded

    low = [any(g0 < spans[k][2] and g1 > spans[k][1] for _, g0, g1 in passes)
           for (k, _), c in zip(recorded.runs(spans),
                                recorded.coverage(spans)) if c < below]
    return {"runs_below": len(low), "of_them_in_a_collection": sum(low),
            "collections": len(passes),
            "gen2": sum(g == 2 for g, _, _ in passes)}


def span_means(spans) -> dict:
    """The mean duration of each span name, in us."""
    took: dict = {}
    for sp in spans:
        took.setdefault(sp.name, []).append((sp.end_ns - sp.start_ns) / 1e3)
    return {k: statistics.fmean(v) for k, v in took.items()}


def cost(workload: str, seconds: float, seed: int) -> dict:
    from portbench import recorded
    from repro_torch import trace

    loop = loop_for(workload, seed)
    windows = []
    for on in ORDER:
        if not on:
            runs, took = window(loop, seconds)
            windows.append({"on": False,
                            "tasks_per_s": loop.tasks_per_run * runs / took})
            continue
        with GcLog() as log, trace.recording() as rec:
            runs, took = window(loop, seconds)
        spans, counters = rec.spans, rec.counters
        late = sum(sum(c.values) for c in counters
                   if c.name == "k3.late_tasks")
        shares = [100.0 * w / t for w, t in zip(
            *(sum((c.values for c in counters if c.name == n), ())
              for n in ("k3.wait_cycles", "k3.task_cycles"))) if t]
        windows.append({
            "on": True, "tasks_per_s": loop.tasks_per_run * runs / took,
            "launch_us": recorded.launch_us(spans),
            "span_us": span_means(spans),
            "k3_wait_share": recorded.wait_share(counters),
            "k3_cta_wait_share_min_max": [min(shares), max(shares)]
            if shares else None,
            "late_task_share": late / (loop.tasks_per_run * runs),
            "least_coverage": min(recorded.coverage(spans)),
            **short_runs(spans, log.passes)})
    off = [w["tasks_per_s"] for w in windows if not w["on"]]
    on = [w["tasks_per_s"] for w in windows if w["on"]]
    return {"part": "cost", "cell": workload, "seed": seed,
            "seconds": seconds, "windows": windows,
            "median_off": statistics.median(off),
            "median_on": statistics.median(on),
            "on_over_off": statistics.median(on) / statistics.median(off)}


def after(workload: str, seed: int) -> dict:
    """0.25 s of the run loop with recording on, then 0.25 s under the
    profiler (the device alone, recording off), then 0.25 s recording on
    again: the spans before and after a profile in one process."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import recorded
    from repro_torch import trace

    loop = loop_for(workload, seed)
    out = {"part": "after", "cell": workload}
    for label in ("before", "profiled", "after"):
        if label == "profiled":
            with profile(activities=[ProfilerActivity.CUDA]):
                window(loop, 0.25)
                torch.cuda.synchronize()
            continue
        with GcLog() as log, trace.recording() as rec:
            runs, took = window(loop, 0.25)
        out[label] = {"runs": runs, "launch_us": recorded.launch_us(rec.spans),
                      "span_us": span_means(rec.spans),
                      "least_coverage": min(recorded.coverage(rec.spans)),
                      **short_runs(rec.spans, log.passes)}
    return out


def idle(workload: str, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import recorded
    from portbench import trace as bench_trace
    from repro_torch import trace

    loop = loop_for(workload, seed)
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0, n = time.perf_counter(), 0
            while n < 2 or time.perf_counter() - t0 < 0.5:
                loop.run()
                n += 1
            torch.cuda.synchronize()
    split = recorded.idle_by_host(rec.spans, bench_trace.kineto_events(prof))
    return {"part": "idle", "cell": workload, "runs": n,
            "window_s": split.window_s, "idle_s": split.idle_s,
            "by_activity_s": split.by_activity,
            "split_over_idle": sum(split.by_activity.values())
            / split.idle_s if split.idle_s else None,
            "idle_host_share": recorded.host_share(split),
            "span_us": span_means(rec.spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=2**31 + 4099)
    ap.add_argument("--parts", default="sass,cost,after,idle")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_phase: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(json.dumps({"card": card(), "torch": torch.__version__}),
          flush=True)
    parts = args.parts.split(",")
    if "sass" in parts and args.parent is not None:
        print(json.dumps(sass(args.parent)), flush=True)
    if "cost" in parts:
        for cell in COST_CELLS:
            print(json.dumps(cost(cell, args.seconds, args.seed)),
                  flush=True)
    if "after" in parts:
        for cell in IDLE_CELLS:
            print(json.dumps(after(cell, args.seed)), flush=True)
    if "idle" in parts:
        for cell in IDLE_CELLS:
            print(json.dumps(idle(cell, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
