"""The benchmark's run of one cell: set-up, the measured window, the traced
measurements, the check against the reference, the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* the configuration's file (its ``file`` entry), a JSON object naming the
  plain reference that judges it (``portbench/reference/<reference>.py``);
* the traffic mix, ``portbench/traffic/<traffic>.json``, naming the loop
  that runs it (``portbench/loops/<loop>.py``);
* each metric's reader, ``portbench/metrics/<metric>.py``; a metric named
  ``<name>.<qualifier>`` (one quantity split by the end-to-end metric it
  moves, as ``device_idle_share.memory``) without a file of its own is read
  by ``portbench/metrics/<name>.py``.

So a cell or a metric is added with files and entries alone, and so is a
configuration of another kind than a Task Bench graph (a decode loop, a
train step): its own loop, its own plain reference, its own traffic.

What ``run_cell`` reads of a loop (``LOOP_CONTRACT``), built as
``Loop(config, traffic, seed, device)``:

* ``graph``: the plain data that describes the work (sizes, seed), which
  the reference and the metric readers read;
* ``ngraphs``: the independent instances a run serves (graphs in flight,
  sequences in a batch);
* ``tasks_per_run``: the loop's unit of work, counted for one run: a task
  for Task Bench, one generated token of one sequence for a decode loop;
* ``run()``: one run of the timed path, returning what the reference
  judges;
* ``run_split(before, after)``: the same run with the two CUDA events
  recorded on the stream around the program's device work;
* ``launches()``: the hand-written kernels' launch counters by name;
* ``kernel_calls()``: a call for each kernel timed alone (may be empty);
* ``witness_run()``: one more run, returning ``(outputs, state)``, the
  state the program leaves that the outputs do not show (or None).

The reference, ``portbench/reference/<reference>.py``, gives
``check(graph, outputs, ngraphs, state, device=...)``: each number
compared beside its limit.  It runs after the loop is freed and the
allocator's cache emptied, on the cell's device if it chooses, with TF32
off, so a float32 reference computes in float32.

``run_cell`` takes the device as an argument, so the tests run the whole
path on the CPU; ``run.py`` is the command and refuses to run without a
card.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
PKG = "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SLICE_S = 0.25
TRACE_SLICE_RUNS = 2
LOOP_CONTRACT = ("graph", "ngraphs", "tasks_per_run", "run", "run_split",
                 "launches", "kernel_calls", "witness_run")


def process_seconds() -> Optional[float]:
    """Seconds since this process started, from /proc (10 ms steps)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(SimpleNamespace):
    """A workload entry resolved to its files and metrics."""


def resolve(workload: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(wl)}")
    entry = wl[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    traffic = load_json(root / PKG / "traffic" / f"{entry['traffic']}.json")

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(name=workload, root=root, entry=entry, config=config,
                traffic=traffic, chips=int(entry["chips"]),
                end_to_end=[m for m in spec["end_to_end"] if listed(m)],
                per_layer=[m for m in spec["per_layer"] if listed(m)])


def reader(cell: Cell, metric: Dict) -> ModuleType:
    name = metric["name"]
    path = cell.root / PKG / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = path.with_name(name.split(".", 1)[0] + ".py")
    return load_module(path, "metric_" + name)


def forbidden_modules(modules=None) -> List[str]:
    """JAX or the JAX package among the loaded modules (``sys.modules``
    unless given), compared by whole top-level name."""
    tops = {m.split(".", 1)[0] for m in list(modules or sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths.  The port builds its kernels into ``build/repro_torch`` itself."""
    base = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float, loop_hook=None) -> Dict:
    """Run one cell once; return the result line as a dict.

    ``started`` is the ``time.perf_counter()`` reading that stands for the
    process's start.  ``loop_hook`` lets tests break the timed path: it
    gets the loop after set-up and may patch it.

    With ``trace`` on a card, each run of the window records CUDA events
    before and after the runner's device program (``Loop.run_split``), and
    after the window come the kernels timed alone (``trace.kernel_seconds``)
    and a profiled slice of the run loop (``trace.profile_runs``).  Last, a
    witness run leaves the state of the last timestep's bodies for the
    check (``Loop.witness_run``).
    """
    import torch

    t_harness = time.perf_counter()
    loop_mod = load_module(
        cell.root / PKG / "loops" / f"{cell.traffic['loop']}.py",
        "loop_" + cell.traffic["loop"])
    loop = loop_mod.Loop(cell.config, cell.traffic, seed, device)
    missing = [n for n in LOOP_CONTRACT if not hasattr(loop, n)]
    if missing:
        raise TypeError(f"loop {cell.traffic['loop']!r} lacks {missing}")
    if loop_hook is not None:
        loop_hook(loop)
    t_built = time.perf_counter()
    for _ in range(int(cell.traffic.get("warm_runs", 2))):
        loop.run()
    gc.collect()
    gc.freeze()
    t_setup = time.perf_counter()
    setup_s = t_setup - started
    setup_parts = {"start_to_harness_s": t_harness - started,
                   "loop_s": t_built - t_harness,
                   "warm_runs_s": t_setup - t_built}

    cuda = device.type == "cuda"
    split = trace and cuda
    outputs, walls, events = [], [], []
    launches0 = loop.launches()
    clock = time.perf_counter
    w0 = clock()
    while True:
        t0 = clock()
        if split:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            outputs.append(loop.run_split(*ev))
            events.append(ev)
        else:
            outputs.append(loop.run())
        t1 = clock()
        walls.append(t1 - t0)
        if t1 - w0 >= seconds:
            break
    launches1 = loop.launches()
    window = SimpleNamespace(
        start=w0, end=t1, seconds=t1 - w0, walls=walls, runs=len(walls),
        tasks=loop.tasks_per_run * len(walls),
        device_s=[a.elapsed_time(b) / 1e3 for a, b in events] or None,
        launches={k: launches1[k] - launches0[k] for k in launches0})
    del events
    if cuda:
        torch.cuda.synchronize(device)
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if cuda else 0)}

    slice_ = kernels = None
    if split:
        from portbench import trace as tr

        kernels = {k: tr.kernel_seconds(call)
                   for k, call in loop.kernel_calls().items()}
        slice_ = tr.profile_runs(loop.run, TRACE_SLICE_S, TRACE_SLICE_RUNS,
                                 outputs)
        dev_info["busy_s"] = slice_.busy_s
        dev_info["window_s"] = slice_.window_s

    ctx = SimpleNamespace(cell=cell, graph=loop.graph, loop=loop,
                          traffic=cell.traffic, setup_s=setup_s,
                          window=window, slice=slice_, kernels=kernels,
                          device=device)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell, m).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    witnessed, state = loop.witness_run()
    outputs.append(witnessed)
    attempted, graph, ngraphs = len(outputs), loop.graph, loop.ngraphs
    if cuda:
        torch.cuda.synchronize(device)
    del loop, ctx
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_mod = load_module(
        cell.root / PKG / "reference" / f"{cell.config['reference']}.py",
        "reference_" + cell.config["reference"])
    checks = checked_without_tf32(ref_mod.check, graph, outputs, ngraphs,
                                  state, device=device)

    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": dev_info}
    if slice_ is not None:
        result["breakdown"] = {"device_ops": slice_.device_ops,
                               "idle_gaps": slice_.idle_gaps}
    result["setup_parts"] = setup_parts
    if cuda:
        result["power_limit"] = power_limit()
    result["checks"] = checks
    return result


def checked_without_tf32(check, *args, **kwargs):
    """``check(*args, **kwargs)`` with TF32 off for matrix products and
    convolutions, so a float32 reference on the card computes in float32;
    the flags are as they were afterwards."""
    import torch

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        return check(*args, **kwargs)
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unread"
