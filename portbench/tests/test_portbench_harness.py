"""The harness's whole run on the CPU, at small sizes.

``run_cell`` takes its device as an argument, so everything but the look
for a card runs here: set-up through the port's own entry, the window, the
metric readers and the check against the reference.  A cell and a metric
added as files and entries alone run, and so does a configuration of
another kind (``another_kind/``); a timed path broken underneath, by each
fault of the cell's test kind, comes out not correct; nothing the harness
loads is JAX or the JAX package.
"""
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, trace
from portbench.tests.conftest import (ANOTHER, REPO, add_another_kind,
                                      another_entries, cells, copy_tree,
                                      faults, kind, workloads)
from portbench.tests.kinds.taskbench import part_of_the_body

CPU = torch.device("cpu")
SEED = 2**31 + 977


def run(root, workload, seconds=0.15, hook=None, seed=SEED):
    cell = harness.resolve(workload, root)
    return harness.run_cell(cell, seed, seconds, False, CPU,
                            time.perf_counter(), loop_hook=hook)


@pytest.mark.parametrize("workload", cells())
def test_every_cell_runs_correct_on_the_cpu(small_tree, workload):
    r = run(small_tree, workload)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    cell = harness.resolve(workload, small_tree)
    for m in cell.end_to_end:
        if not m["name"].startswith("run_ms_p95"):
            assert r["metrics"][m["name"]]["value"] > 0
    assert list(r)[-1] == "checks"
    assert kind(small_tree, workload).sound(r["checks"]), r["checks"]


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


def test_a_configuration_of_another_kind_is_added_as_files_and_entries_alone(
        tmp_path):
    """The configuration of another kind (``another_kind/``: a config with a
    stated cut, a traffic mix naming its own loop, the loop, its plain
    reference and its test kind) is new files and new entries: every file
    and entry of the benchmark stays as it was, and the harness runs the
    new cell at its own size, correct."""
    root = add_another_kind(copy_tree(tmp_path))
    pb, new = REPO / "portbench", []
    for f in sorted((root / "portbench").rglob("*")):
        rel = f.relative_to(root / "portbench")
        if not f.is_file() or "__pycache__" in rel.parts:
            continue
        if (pb / rel).is_file():
            assert f.read_bytes() == (pb / rel).read_bytes(), rel
        else:
            new.append(str(rel))
    assert sorted(new) == sorted(
        str(f.relative_to(ANOTHER)) for f in ANOTHER.rglob("*")
        if f.is_file() and f.name != "entries.json"
        and "__pycache__" not in f.parts)
    assert {"configs/t5-ffn-swiglu.json", "traffic/ffn-rows64.json",
            "loops/ffn_rows.py", "reference/ffn_swiglu.py",
            "tests/kinds/ffn_swiglu.py"} <= set(new)
    before = json.loads((REPO / "BENCHMARK.json").read_text())
    after = json.loads((root / "BENCHMARK.json").read_text())
    added = another_entries()
    assert set(after) == set(before)
    for key in before:
        assert after[key] == (before[key] + added[key] if key in added
                              else before[key]), key
    workload = added["workloads"][0]["name"]
    cell = harness.resolve(workload, root)
    assert cell.config["reference"] not in {
        harness.resolve(w, root).config["reference"] for w in workloads()}
    assert cell.config["reduced"] == ["num_layers"]
    r = run(root, workload)
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["tasks_per_s.ffn"]["value"] > 0
    assert r["checks"]["max_err_over_scale"]["value"] == 0


def test_every_loop_in_use_has_the_names_run_cell_reads(small_tree):
    assert harness.LOOP_CONTRACT == (
        "graph", "ngraphs", "tasks_per_run", "run", "run_split",
        "launches", "kernel_calls", "witness_run")
    missing = {}
    for w in cells():
        cell = harness.resolve(w, small_tree)
        name = cell.traffic["loop"]
        if name in missing:
            continue
        loop = harness.load_module(
            small_tree / "portbench" / "loops" / f"{name}.py",
            "loop_" + name).Loop(cell.config, cell.traffic, SEED, CPU)
        missing[name] = [n for n in harness.LOOP_CONTRACT
                         if not hasattr(loop, n)]
        assert loop.tasks_per_run > 0 and loop.ngraphs >= 1
        assert isinstance(loop.launches(), dict)
        assert isinstance(loop.kernel_calls(), dict)
    assert set(missing) == {"graph_runs", "ffn_rows"}
    assert not any(missing.values()), missing


def test_a_loop_without_a_name_run_cell_reads_is_refused(small_tree):
    pb = small_tree / "portbench"
    (pb / "loops" / "partial.py").write_text(
        "class Loop:\n"
        "    def __init__(self, config, traffic, seed, device):\n"
        "        self.graph, self.ngraphs, self.tasks_per_run = {}, 1, 1\n"
        "    def run(self):\n"
        "        return []\n")
    (pb / "traffic" / "partial.json").write_text('{"loop": "partial"}')
    spec = json.loads((small_tree / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "partial", "chips": 1, "why": "x",
                              "config": "stencil-compute",
                              "traffic": "partial"})
    (small_tree / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(TypeError, match="run_split.*witness_run"):
        run(small_tree, "partial")


def test_the_reference_gets_the_device_with_tf32_off(small_tree,
                                                      monkeypatch):
    """``run_cell`` hands the reference its device and turns TF32 off for
    the check alone; the Task Bench reference's numbers are the four."""
    seen, load = {}, harness.load_module

    def spying(path, name):
        mod = load(path, name)
        if name.startswith("reference_"):
            check = mod.check

            def spy(*args, **kwargs):
                seen["device"] = kwargs.get("device")
                seen["tf32"] = (torch.backends.cuda.matmul.allow_tf32,
                                torch.backends.cudnn.allow_tf32)
                return check(*args, **kwargs)

            mod.check = spy
        return mod

    monkeypatch.setattr(harness, "load_module", spying)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    r = run(small_tree, "stencil-memory.graph")
    assert seen == {"device": CPU, "tf32": (False, False)}
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    assert r["correct"] is True
    assert {k: c["limit"] for k, c in r["checks"].items()} == {
        "payload_exact_mismatches": 0, "payload_kernel_mismatches": 0,
        "runs_malformed": 0, "body_state_mismatches": 0}


@pytest.mark.parametrize("workload,fault", faults())
def test_a_broken_timed_path_is_not_correct(small_tree, monkeypatch,
                                            workload, fault):
    hook = kind(small_tree, workload).FAULTS[fault](monkeypatch)
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
