"""The harness's whole run on the CPU, at small sizes.

``run_cell`` takes its device as an argument, so everything but the look
for a card runs here: set-up through the port's own entry, the window, the
metric readers and the check against the reference.  A cell and a metric
added as files and entries alone run; a timed path broken underneath comes
out not correct; nothing the harness loads is JAX or the JAX package.
"""
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.tests.conftest import REPO, copy_tree, workloads
from repro_torch.core.graph import TaskGraph

CPU = torch.device("cpu")
SEED = 2**31 + 977


def run(root, workload, seconds=0.15, hook=None, seed=SEED):
    cell = harness.resolve(workload, root)
    return harness.run_cell(cell, seed, seconds, False, CPU,
                            time.perf_counter(), loop_hook=hook)


@pytest.mark.parametrize("workload", workloads())
def test_every_cell_runs_correct_on_the_cpu(small_tree, workload):
    r = run(small_tree, workload)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    cell = harness.resolve(workload, small_tree)
    for m in cell.end_to_end:
        if not m["name"].startswith("run_ms_p95"):
            assert r["metrics"][m["name"]]["value"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in r["checks"].values())


def test_a_cell_and_a_metric_added_as_data_alone_run(small_tree):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    new file and a new entry: the harness runs them unchanged."""
    pb = small_tree / "portbench"
    cfg = json.loads((pb / "configs" / "stencil-compute.json").read_text())
    cfg.update(name="nearest5-compute", pattern="nearest",
               pattern_params={"radix": 5}, width=11, height=6)
    (pb / "configs" / "nearest5-compute.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "scan-i9x2.json").write_text(json.dumps(
        {"loop": "graph_runs", "backend": "torch-scan", "iterations": 9,
         "graphs": 2, "warm_runs": 1}))
    (pb / "metrics" / "runs_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.window.runs)\n")
    spec = json.loads((small_tree / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "nearest5-compute", "source": "x",
                            "file": "portbench/configs/nearest5-compute.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "nearest5.scan", "chips": 1,
                              "config": "nearest5-compute",
                              "traffic": "scan-i9x2", "why": "x"})
    tasks = next(m for m in spec["end_to_end"] if m["name"] == "tasks_per_s")
    tasks["workloads"].append("nearest5.scan")
    spec["per_layer"].append({"name": "runs_in_window", "unit": "runs",
                              "better": "higher", "source": "host_clock",
                              "layer": "runner", "moves": "tasks_per_s",
                              "workloads": ["nearest5.scan"]})
    (small_tree / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run(small_tree, "nearest5.scan")
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["tasks_per_s"]["value"] > 0
    cell = harness.resolve("nearest5.scan", small_tree)
    assert [m["name"] for m in cell.per_layer] == ["runs_in_window"]
    ctx = type("Ctx", (), {"window": type("W", (), {"runs": 3})})
    assert harness.reader(cell, cell.per_layer[0]).read(ctx) == 3.0


def deps_only(keep):
    """Patch a graph's dependency tables so that column i keeps only the
    dependencies ``keep(i, j, width)`` allows."""
    table, mats = TaskGraph.dependency_table, TaskGraph.dependence_matrices

    def dependency_table(self, radix=None):
        idx, mask = table(self, radix)
        mask = mask.copy()
        H, W, R = idx.shape
        for i in range(W):
            for r in range(R):
                if not keep(i, int(idx[0, i, r]), W):
                    mask[:, i, r] = 0
        return idx, mask

    def dependence_matrices(self):
        m = mats(self).copy()
        W = m.shape[1]
        for i in range(W):
            for j in range(W):
                if not keep(i, j, W):
                    m[:, i, j] = False
        return m

    return dependency_table, dependence_matrices


def part_of_the_body(what):
    """Patch the plain task bodies (what the CPU path runs) to do part of
    their work: ``half`` the iterations, or only the ``first`` part of
    their state (the tile's first value, the scratch's first window)."""
    from repro_torch.kernels import compute, memory

    tile, walk = compute.taskbench_compute_plain, memory.taskbench_memory_plain

    def compute_part(tiles, iters, max_iters):
        if what == "half":
            return tile(tiles, iters // 2, max_iters // 2)
        out = tiles.clone()
        out[:, 0, 0] = tile(tiles, iters, max_iters)[:, 0, 0]
        return out

    def memory_part(x, iterations, span):
        if what == "half":
            return walk(x, iterations // 2, span)
        return walk(x, iterations.clamp(max=1), span)

    return {(compute, "taskbench_compute_plain"): compute_part,
            (memory, "taskbench_memory_plain"): memory_part}


FAULTS = {
    # a step that returns its state unchanged: the body never advances
    "state_unchanged": "body",
    # every body runs half its iterations
    "half_iterations": "half",
    # half the columns' dependencies left out of the combine
    "half_left_out": lambda i, j, W: i < W // 2,
    # the exchange between columns left out: each keeps only its own
    "no_exchange": lambda i, j, W: i == j,
    # one answer altered where it is produced
    "answer_altered": "flip",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", workloads())
def test_a_broken_timed_path_is_not_correct(small_tree, monkeypatch,
                                            workload, fault):
    what = FAULTS[fault]
    hook = None
    if what == "body":
        from repro_torch.kernels import compute, memory
        monkeypatch.setattr(compute, "compute_step", lambda a: a + 0.0)
        monkeypatch.setattr(memory, "memory_step", lambda a: a + 0.0)
    elif what == "half":
        for (mod, name), fn in part_of_the_body("half").items():
            monkeypatch.setattr(mod, name, fn)
    elif what == "flip":
        def hook(loop):
            run_once, calls = loop.run, [0]

            def run_flipped():
                out = run_once()
                calls[0] += 1
                if calls[0] == 4:  # set-up makes 2 runs: a window's run
                    bits = out[0].view(np.uint32)
                    bits[SEED % out[0].shape[0], SEED % 5] ^= np.uint32(1)
                return out

            loop.run = run_flipped
    else:
        table, mats = deps_only(what)
        monkeypatch.setattr(TaskGraph, "dependency_table", table)
        monkeypatch.setattr(TaskGraph, "dependence_matrices", mats)
    r = run(small_tree, workload, hook=hook)
    assert r["correct"] is False, (fault, r["checks"])


@pytest.mark.parametrize("what", ["half", "first"])
@pytest.mark.parametrize("workload", [w for w in workloads()
                                      if "memory" in w])
def test_a_memory_body_doing_part_of_its_walk_fails_on_its_state(
        small_tree, monkeypatch, workload, what):
    """Half the iterations, or the first window alone, leave the payload's
    result (the scratch's first value) as it should be: only the state the
    bodies leave shows them."""
    for (mod, name), fn in part_of_the_body(what).items():
        monkeypatch.setattr(mod, name, fn)
    r = run(small_tree, workload)
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert c["payload_kernel_mismatches"] == 0, c
    assert c["body_state_mismatches"] > 0 and r["correct"] is False, c


@pytest.mark.parametrize("workload", [w for w in workloads()
                                      if "compute" in w])
def test_a_compute_body_doing_part_of_its_tile_fails_on_its_state(
        small_tree, monkeypatch, workload):
    for (mod, name), fn in part_of_the_body("first").items():
        monkeypatch.setattr(mod, name, fn)
    r = run(small_tree, workload)
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert c["payload_kernel_mismatches"] == 0, c
    assert c["body_state_mismatches"] > 0 and r["correct"] is False, c


def test_the_state_is_witnessed_and_the_program_left_as_it_was(small_tree):
    """The witness run finds the state; the body functions are the
    program's own again once set-up and the witness run are over."""
    from portbench.loops import graph_runs
    from repro_torch.kernels import compute, memory

    before = [getattr(compute, "taskbench_compute"),
              getattr(memory, "taskbench_memory_plain")]
    cell = harness.resolve("stencil-memory.graph", small_tree)
    loop = graph_runs.Loop(cell.config, cell.traffic, SEED, CPU)
    outputs, state = loop.witness_run()
    g = loop.graph
    assert state.shape == (g["width"], g["scratch_bytes"] // 4)
    assert [compute.taskbench_compute,
            memory.taskbench_memory_plain] == before
    assert loop.held.latest is None


def test_a_split_metric_is_read_by_its_quantitys_reader(small_tree):
    cell = harness.resolve("stencil-memory.graph", small_tree)
    for name in ("device_idle_share.memory", "tasks_per_s.memory",
                 "run_ms_p95.graph"):
        base = name.split(".")[0]
        assert harness.reader(cell, {"name": name}).__file__.endswith(
            f"metrics/{base}.py")
    assert harness.reader(cell, {"name": "k3_memory_roofline"}).read


def test_nothing_loaded_is_jax_or_the_jax_package(small_tree):
    code = (
        "import sys, time, torch\n"
        "from pathlib import Path\n"
        "from portbench import harness\n"
        "cell = harness.resolve('stencil-memory.graph', "
        f"Path({str(small_tree)!r}))\n"
        "r = harness.run_cell(cell, 5, 0.1, False, torch.device('cpu'),"
        " time.perf_counter())\n"
        "assert r['correct']\n"
        "print(harness.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": f"{REPO / 'src'}:{REPO}",
                              "PATH": "/usr/bin:/bin"})
    found, tops = (eval(line) for line in out.stdout.splitlines()[-2:])
    assert found == []
    assert "repro_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch.core", "jaxtyping", "reprox", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro.core.graph", "jax._src", "jaxlib", "flax.linen",
         "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]


def run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "stencil-compute.fused-i64", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = run_py(REPO)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_run_with_only_the_benchmarks_files_exits_nonzero(tmp_path):
    root = copy_tree(tmp_path)
    out = run_py(root)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert sorted(p.name for p in root.iterdir()) == ["BENCHMARK.json",
                                                      "portbench"]


def test_slice_reduction_labels_gaps_by_host_activity():
    us = 1000
    k3 = "void (anonymous namespace)::fused_kernel(FusedArgs)"
    d2h = "Memcpy DtoH (Device -> Pageable)"
    runs = [(0, 10000 * us), (16000 * us, 26000 * us)]
    ev = [trace.Ev(k3, 1000 * us, 8000 * us, True),
          trace.Ev(d2h, 8500 * us, 8800 * us, True),
          trace.Ev(k3, 17000 * us, 23000 * us, True),
          trace.Ev(d2h, 24500 * us, 24800 * us, True),
          trace.Ev("aten::to", 9000 * us, 9900 * us, False)]
    s = trace.reduce_slice(ev, runs)
    assert s.window_s == pytest.approx(0.026)
    assert s.busy_s == pytest.approx(0.0136)
    assert s.device_ops == [("fused_kernel", pytest.approx(0.013)),
                            ("Memcpy DtoH (Device -> Pageable)",
                             pytest.approx(0.0006))]
    # 0-1 ms program; 8-8.5 program; 8.8-17: copy_out 1.2, between 6,
    # program 1; 23-24.5 program; 24.8-26 copy_out
    assert s.idle_gaps == [("between_runs", pytest.approx(0.0082)),
                           ("program", pytest.approx(0.0015)),
                           ("copy_out", pytest.approx(0.0012)),
                           ("program", pytest.approx(0.001)),
                           ("program", pytest.approx(0.0005))]
