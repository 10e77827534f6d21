"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds the three hand-written CUDA kernels from ``src/repro_torch/kernels/
csrc`` (nvcc, sm_90a), then, in phases that each raise on failure:

1. the card: name and power limit (nvidia-smi), SMs, max SM clock, versions;
2. the build, timed;
3. every kernel against its plain PyTorch version on the card, at the
   shapes of ``tests/test_kernels.py`` and at the main path's full-size
   shapes: K1, K2 and K3 bitwise for the empty, compute and memory kinds,
   K3 compute_mxu within check_outputs' rtol 1e-5 / atol 1e-6;
4. the structural pin: ``torch.profiler`` records exactly one CUDA kernel
   per ``cuda-fused`` run, for 1 graph and for 3 stacked graphs;
5. the main path at full size (launch counts zeroed just before, read just
   after): stencil / compute, width 132 (one task column per SM), height
   1000, on ``cuda-fused`` and ``torch-scan``, one graph and ``run_many`` of
   4 concurrent nearest[radix=5] graphs, plus the memory kind with 1 MiB of
   scratch per column; every output checked against the numpy oracle and
   the two backends bitwise equal;
6. METG on the card: ``run_scenario`` with the wall clock over iterations
   4096 -> 1 for both backends.

The line before the last lists the kernels with their launches on the main
path, errors, times and bounds; the last line is the device record.  Exits
non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    MegakernelBackend, tables_from_numpy, taskbench_fused,
    taskbench_fused_plain)
from repro_torch.bench import (ScenarioSpec, SweepControls,  # noqa: E402
                               compute_metg, run_scenario)
from repro_torch.core import (check_outputs, execute_reference,  # noqa: E402
                              make_graph, pattern_names, replicate)
from repro_torch.kernels import (_build, bodies,  # noqa: E402
                                 taskbench_compute, taskbench_compute_plain,
                                 taskbench_memory, taskbench_memory_plain)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_LANES_PER_SM = 128
WIDTH, HEIGHT = 132, 1000
MAIN_ITERS, MEM_ITERS = 16, 4
MEM_SCRATCH = 1 << 20
MXU_RTOL, MXU_ATOL = 1e-5, 1e-6


def phase(title: str):
    print(f"\n== {title}", flush=True)
    return time.perf_counter()


def done(t0: float) -> None:
    print(f"   phase time {time.perf_counter() - t0:.3f} s", flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_kernels(prof) -> list:
    """The CUDA kernels a ``torch.profiler`` run recorded (no copies)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def timed(fn, reps: int):
    """(device ms, stream ms) per call of ``fn``, after one warm call.

    Device ms sums the durations of the CUDA kernels the profiler records:
    the card's own time.  Stream ms is the CUDA-event time between the
    first and the last call over ``reps`` back-to-back calls, which also
    counts the gaps where the host has not issued the next launch yet."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = sum(e.time_range.elapsed_us() for e in device_kernels(prof))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device / 1e3 / reps, start.elapsed_time(end) / reps


def bitwise(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs diff {err})")
    return err


# the main path's three full-size graphs
GRAPHS = {
    "stencil": dict(pattern="stencil", kernel="compute",
                    iterations=MAIN_ITERS),
    "nearest": dict(pattern="nearest", kernel="compute",
                    iterations=MAIN_ITERS, radix=5),
    "memory": dict(pattern="stencil", kernel="memory", iterations=MEM_ITERS,
                   scratch_bytes=MEM_SCRATCH),
}


def full_size(name: str):
    return make_graph(width=WIDTH, height=HEIGHT, output_bytes=16,
                      **GRAPHS[name])


def oracle(name: str) -> np.ndarray:
    return execute_reference(full_size(name))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    # the numpy oracle of the three graphs takes ~30 s of CPU: it runs in
    # worker processes while the card works
    with ProcessPoolExecutor(len(GRAPHS),
                             mp_context=get_context("spawn")) as pool:
        oracles = {name: pool.submit(oracle, name) for name in GRAPHS}
        kernels = run_phases(full_size("stencil"), full_size("nearest"),
                             full_size("memory"), oracles)
    print(f"\ntotal time {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(stencil, nearest, memory, oracles: dict) -> list:
    dev = torch.device("cuda")

    # -- 1. the card ---------------------------------------------------
    t0 = phase("1. card")
    card = smi("name,power.limit")
    print(card)
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    peak_flops = sms * FP32_LANES_PER_SM * 2 * max_mhz * 1e6
    print(f"   SMs {sms}, max SM clock {max_mhz:.0f} MHz, fp32 peak "
          f"{peak_flops / 1e12:.3f} TFLOP/s (SMs x 128 lanes x 2 x clock), "
          f"HBM {HBM_BYTES_PER_S / 1e12} TB/s (data sheet)")
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    done(t0)

    # -- 2. the build --------------------------------------------------
    t0 = phase("2. build")
    lib = _build.library()
    print(f"   {_build.library_path().name} built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in _build.log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("   " + line.strip())
    print(f"   K3 grid for {WIDTH} tasks: "
          f"{lib.taskbench_fused_blocks(WIDTH, 0)} blocks")
    done(t0)

    def bound(flops: float, nbytes: float):
        t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_PER_S
        return ((t_ops, "operations") if t_ops >= t_bytes
                else (t_bytes, "bytes"))

    # -- 3. kernels against their plain versions -----------------------
    t0 = phase("3. kernels vs plain versions on the card")
    rng = np.random.RandomState(0)
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for w, mi in [(8, 12), (16, 40), (32, 7), (WIDTH, MAIN_ITERS),
                  (4 * WIDTH, MAIN_ITERS)]:
        tiles = torch.from_numpy(
            rng.uniform(-1.0, 0.5, (w, 8, 128)).astype(np.float32)).to(dev)
        its = torch.from_numpy(
            rng.randint(0, mi + 1, w).astype(np.int32)).to(dev)
        e = bitwise(f"K1 W={w}", taskbench_compute(tiles, its, mi),
                    taskbench_compute_plain(tiles, its, mi))
        errs["K1"] = max(errs["K1"], e)
        print(f"   K1 W={w} max_iters={mi}: max abs diff {e}")
    span, size, _ = bodies.memory_geometry(memory.kernel)
    for sz, sp, its in [(1024, 128, 7), (2048, 256, 0), (512, 512, 9)]:
        x = (torch.arange(sz, dtype=torch.float32) / sz).to(dev)
        e = bitwise(f"K2 {sz}/{sp}/{its}", taskbench_memory(x, its, sp),
                    taskbench_memory_plain(x, its, sp))
        errs["K2"] = max(errs["K2"], e)
        print(f"   K2 size={sz} span={sp} iterations={its}: max abs diff {e}")
    xm = torch.from_numpy(
        rng.uniform(0, 1, (WIDTH, size)).astype(np.float32)).to(dev)
    itm = torch.from_numpy(rng.randint(0, 40, WIDTH).astype(np.int32)).to(dev)
    e = bitwise("K2 rows", taskbench_memory(xm, itm, span),
                taskbench_memory_plain(xm, itm, span))
    errs["K2"] = max(errs["K2"], e)
    print(f"   K2 ({WIDTH}, {size}) span={span}, per-row iterations 0..39: "
          f"max abs diff {e}")

    def fused_pair(graphs):
        radix = max(1, max(gr.max_radix() for gr in graphs))
        tabs = tables_from_numpy(MegakernelBackend._tables(graphs, radix),
                                 dev)
        kw = dict(kernel=graphs[0].kernel, ngraphs=len(graphs),
                  height=graphs[0].height,
                  payload_elems=graphs[0].payload_elems)
        return tabs, kw, taskbench_fused(*tabs, **kw), \
            taskbench_fused_plain(*tabs, **kw)

    pkw = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
    for kind in ("empty", "compute", "memory", "compute_mxu"):
        worst = 0.0
        for pat in pattern_names():
            extra = ({"scratch_bytes": 2048, "span_bytes": 512}
                     if kind == "memory" else {})
            gr = make_graph(width=6, height=8, pattern=pat, kernel=kind,
                            iterations=9, imbalance=0.5,
                            **pkw.get(pat, {}), **extra)
            for graphs in ([gr], replicate(gr, 3)):
                _, _, got, want = fused_pair(graphs)
                if kind == "compute_mxu":
                    torch.testing.assert_close(got, want, rtol=MXU_RTOL,
                                               atol=MXU_ATOL)
                    worst = max(worst, (got - want).abs().max().item())
                else:
                    worst = max(worst, bitwise(f"K3 {kind} {pat}", got, want))
        print(f"   K3 {kind}, every pattern, 1 and 3 graphs (W=6, H=8): "
              f"max abs diff {worst}")
    for name, graphs in (("stencil", [stencil]),
                         ("4 x nearest[radix=5]", replicate(nearest, 4)),
                         ("memory", [memory])):
        _, _, got, want = fused_pair(graphs)
        e = bitwise(f"K3 full size {name}", got, want)
        errs["K3"] = max(errs["K3"], e)
        print(f"   K3 full size {name} (W={WIDTH}, H={HEIGHT}): "
              f"max abs diff {e}")
    print(f"   launches so far: K1 {taskbench_compute.launches}, "
          f"K2 {taskbench_memory.launches}, K3 {taskbench_fused.launches}")
    done(t0)

    # -- 4. the structural pin -----------------------------------------
    t0 = phase("4. one CUDA kernel per cuda-fused run (torch.profiler)")
    fused = get_backend("cuda-fused")
    for graphs in ([stencil], replicate(stencil, 3)):
        runner = fused.prepare_many(graphs)
        runner()
        before = taskbench_fused.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner()
        names = [e.name for e in device_kernels(prof)]
        counted = taskbench_fused.launches - before
        print(f"   {len(graphs)} graph(s): profiler CUDA kernels {len(names)} "
              f"{sorted(set(names))}, launch counter +{counted}")
        if not names:
            print("   the profiler saw no CUDA kernel: pinned by the launch "
                  "counter instead")
        elif len(names) != 1:
            raise AssertionError(f"expected one CUDA kernel, saw {names}")
        if counted != 1:
            raise AssertionError(f"expected one K3 launch, counted {counted}")
    done(t0)

    # -- 5. the main path at full size ---------------------------------
    t0 = phase("5. main path: W=132, H=1000, both backends")
    scan = get_backend("torch-scan")
    for fn in (taskbench_compute, taskbench_memory, taskbench_fused):
        fn.launches = 0
    outs = {}
    for label, graphs in (("stencil", [stencil]),
                          ("4 x nearest[radix=5]", replicate(nearest, 4)),
                          ("memory 1 MiB", [memory])):
        for be_name, be in (("cuda-fused", fused), ("torch-scan", scan)):
            t1 = time.perf_counter()
            outs[label, be_name] = be.run_many(graphs)
            print(f"   {label} on {be_name}: "
                  f"{(time.perf_counter() - t1) * 1e3:.3f} ms (first run)")
    launches = {"K1": taskbench_compute.launches,
                "K2": taskbench_memory.launches,
                "K3": taskbench_fused.launches}
    print(f"   launches on the main path: {launches}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    for label, key, graphs in (
            ("stencil", "stencil", [stencil]),
            ("4 x nearest[radix=5]", "nearest", replicate(nearest, 4)),
            ("memory 1 MiB", "memory", [memory])):
        ref = oracles[key].result()
        for k in range(len(graphs)):
            a, b = outs[label, "cuda-fused"][k], outs[label, "torch-scan"][k]
            check_outputs(graphs[k], a, expected=ref)
            check_outputs(graphs[k], b, expected=ref)
            if not np.array_equal(a, b):
                raise AssertionError(f"{label}: backends differ")
        print(f"   {label}: both backends pass check_outputs against the "
              f"oracle and agree bitwise")
    done(t0)

    # -- kernel times at the main path's shapes -------------------------
    t0 = phase("kernel times at the main path's shapes")
    rows = []
    tiles = (0.5 + torch.zeros(WIDTH, 8, 128, device=dev))
    its = torch.full((WIDTH,), MAIN_ITERS, dtype=torch.int32, device=dev)
    rows.append(("K1", timed(lambda: taskbench_compute(tiles, its,
                                                       MAIN_ITERS), 200),
                 timed(lambda: taskbench_compute_plain(tiles, its,
                                                       MAIN_ITERS), 20),
                 bound(WIDTH * 1024 * 2 * MAIN_ITERS,
                       WIDTH * (1024 * 8 + 4))))
    xs = (1.0 + torch.zeros(WIDTH, size, device=dev))
    itm = torch.full((WIDTH,), MEM_ITERS, dtype=torch.int32, device=dev)
    nwin = size // span
    reps = sum(MEM_ITERS // nwin + (w < MEM_ITERS % nwin)
               for w in range(nwin))
    rows.append(("K2", timed(lambda: taskbench_memory(xs, itm, span), 50),
                 timed(lambda: taskbench_memory_plain(xs, itm, span), 5),
                 bound(WIDTH * reps * span * 2, WIDTH * (size * 8 + 4))))
    tabs, kw, _, _ = fused_pair([stencil])
    table_bytes = sum(t.numel() * 4 for t in tabs[:4])
    rows.append(("K3", timed(lambda: taskbench_fused(*tabs, **kw), 10),
                 timed(lambda: taskbench_fused_plain(*tabs, **kw), 2),
                 bound(stencil.num_tasks * 1024 * 2 * MAIN_ITERS,
                       table_bytes + WIDTH * stencil.payload_elems * 4)))
    for name, (ms, ms_s), (pms, pms_s), (bs, by) in rows:
        print(f"   {name}: device {ms:.6f} ms (stream {ms_s:.6f} ms), plain "
              f"device {pms:.6f} ms (stream {pms_s:.6f} ms), bound "
              f"{bs * 1e3:.6f} ms ({by})")
    print(f"   ({card})")
    for fn in (taskbench_compute, taskbench_memory, taskbench_fused):
        fn.launches = 0  # timing launches are not main-path launches
    done(t0)

    # -- 6. METG on the card --------------------------------------------
    t0 = phase("6. METG: stencil/compute W=132 H=1000, iterations 4096 -> 1")
    results = {}
    for be_name in ("cuda-fused", "torch-scan"):
        spec = ScenarioSpec(
            name=f"metg.{be_name}.stencil", backend=be_name,
            pattern="stencil", kernel="compute", width=WIDTH, height=HEIGHT,
            cores=sms, sweep=SweepControls(iterations_hi=4096, n_points=7,
                                           repeats=3, warmup=1))
        res = run_scenario(spec)
        results[be_name] = res
        metg = res.metg_s
        print(f"   {be_name}: METG {metg * 1e6 if metg else None} us "
              f"(granularity = wall x {sms} SMs / tasks), peak "
              f"{res.peak_rate:.6e} FLOP/s")
        for p in sorted(res.points, key=lambda p: -p.iterations):
            print(f"     iterations {p.iterations:5d}: wall {p.wall_time:.6e} s"
                  f", granularity {p.granularity * 1e6:.6f} us, "
                  f"efficiency {p.efficiency:.4f}")
    common = max(r.peak_rate for r in results.values())
    for be_name, res in results.items():
        m = compute_metg(res.points, peak_rate=common).metg
        print(f"   {be_name} against the best rate of both "
              f"({common:.6e} FLOP/s): METG {m * 1e6 if m else None} us")
    print(f"   ({card})")
    done(t0)

    meta = {
        "K1": ("taskbench_compute", "src/repro_torch/kernels/csrc/compute.cu",
               "src/repro/kernels/compute.py:23"),
        "K2": ("taskbench_memory", "src/repro_torch/kernels/csrc/memory.cu",
               "src/repro/kernels/memory.py:26"),
        "K3": ("taskbench_fused", "src/repro_torch/kernels/csrc/fused.cu",
               "src/repro/backends/megakernel.py:79"),
    }
    return [{"name": meta[k][0], "route": "cuda", "source": meta[k][1],
             "replaces": meta[k][2], "launches": launches[k],
             "max_abs_err": errs[k], "ms": ms, "plain_ms": pms,
             "bound_ms": bs * 1e3, "bound_by": by, "library_ms": None}
            for k, (ms, _), (pms, _), (bs, by) in rows]


if __name__ == "__main__":
    sys.exit(main())
