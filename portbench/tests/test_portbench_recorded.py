"""The readers of the program's own spans and counters
(``portbench/recorded.py``): the reductions over plain tuples, the judge of
a pass's outputs, and None wherever nothing was recorded."""
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, recorded, trace
from portbench.tests.conftest import cells

CPU = torch.device("cpu")
SEED = 2**31 + 977
NEW = ("host_launch_us", "host_launch_us.graph", "k3_wait_share",
       "k3_wait_share.memory", "idle_host_share", "idle_host_share.graph")
US = 1000


def two_runs():
    """Spans of two runs, in us: run 0-100 (launch 1-20, wait 20-80, copy
    80-99), run 130-230 (launch 130-150, wait 150-210, copy 210-230), and a
    launch's own child span, which the idle split does not read."""
    def sp(name, s, e, parent, run):
        return (name, s * US, e * US, parent, run)

    return [sp("run", 0, 100, -1, 0), sp("launch", 1, 20, 0, 0),
            sp("fused.launch", 5, 19, 1, 0), sp("wait", 20, 80, 0, 0),
            sp("copy", 80, 99, 0, 0), sp("run", 130, 230, -1, 5),
            sp("launch", 130, 150, 5, 5), sp("wait", 150, 210, 5, 5),
            sp("copy", 210, 230, 5, 5)]


def test_idle_is_split_by_what_the_host_was_in():
    dev = [trace.Ev("k3", 10 * US, 70 * US, True),
           trace.Ev("d2h", 85 * US, 90 * US, True),
           trace.Ev("k3", 145 * US, 200 * US, True),
           trace.Ev("aten::empty", 0, 230 * US, False)]
    s = recorded.idle_by_host(two_runs(), dev)
    assert s.window_s == pytest.approx(230e-6)
    # idle: 0-10, 70-85, 90-145, 200-230
    assert s.idle_s == pytest.approx(110e-6)
    want = {"run": 2e-6, "launch": 24e-6, "wait": 20e-6, "copy": 34e-6,
            "between_runs": 30e-6}
    assert s.by_activity == pytest.approx(want)
    assert sum(s.by_activity.values()) == pytest.approx(s.idle_s)
    assert recorded.host_share(s) == pytest.approx(100 * 90 / 230)


def test_activities_tile_the_runs_window():
    acts = recorded.activities(two_runs())
    assert [a[0] for a in acts] == ["run", "launch", "wait", "copy", "run",
                                    "between_runs", "launch", "wait",
                                    "copy"]
    assert acts[0][1] == 0 and acts[-1][2] == 230 * US
    assert all(a[2] == b[1] for a, b in zip(acts, acts[1:]))


def test_no_device_work_is_all_idle_and_no_run_is_none():
    s = recorded.idle_by_host(two_runs(), [])
    assert s.idle_s == pytest.approx(s.window_s)
    assert sum(s.by_activity.values()) == pytest.approx(s.window_s)
    assert recorded.idle_by_host([], []) is None
    assert recorded.host_share(None) is None


def test_launch_wait_share_and_coverage():
    spans = two_runs()
    assert recorded.launch_us(spans) == pytest.approx((19 + 20) / 2)
    assert recorded.coverage(spans) == pytest.approx([0.98, 1.0])
    assert recorded.launch_us([]) is None
    counters = [("k3.wait_cycles", 2, 0, (10, 30)),
                ("k3.task_cycles", 2, 0, (100, 100)),
                ("k3.late_tasks", 2, 0, (1, 2)),
                ("k3.wait_cycles", 7, 5, (20,)),
                ("k3.task_cycles", 7, 5, (200,))]
    assert recorded.wait_share(counters) == pytest.approx(15.0)
    assert recorded.wait_share(counters[2:3]) is None


def test_a_pass_is_none_without_a_card_or_a_recorder(monkeypatch):
    assert recorded.pass_a(SimpleNamespace(device=CPU)) is None
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace", raising=False)
    ctx = SimpleNamespace(device=torch.device("cuda"))
    assert recorded.pass_a(ctx) is None and recorded.pass_b(ctx) is None


@pytest.mark.parametrize("workload", cells())
def test_the_cpu_cell_path_reports_none_of_the_new_entries(small_tree,
                                                           workload):
    cell = harness.resolve(workload, small_tree)
    r = harness.run_cell(cell, SEED, 0.1, True, CPU, time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert not set(NEW) & set(r["metrics"])
    ctx = SimpleNamespace(device=CPU)
    for m in cell.per_layer:
        if m["name"] in NEW:
            assert harness.reader(cell, m).read(ctx) is None


def test_a_pass_whose_outputs_differ_from_the_reference_raises(small_tree):
    cell = harness.resolve("stencil-compute.fused-i64", small_tree)
    loops = harness.load_module(
        small_tree / "portbench" / "loops" / "graph_runs.py", "loop_test")
    graph = loops.graph_of(cell.config, cell.traffic, SEED)
    ref = harness.load_module(
        small_tree / "portbench" / "reference" / "taskbench.py", "ref_test")
    wave = ref.final_wave(graph).numpy()
    ctx = SimpleNamespace(cell=cell, graph=graph,
                          loop=SimpleNamespace(ngraphs=1))
    recorded._judge(ctx, [[wave.copy()], [wave.copy()]])
    bad = wave.copy()
    bad.view(np.uint32)[1, 3] ^= np.uint32(1)
    with pytest.raises(RuntimeError, match="differs from the reference"):
        recorded._judge(ctx, [[wave.copy()], [bad]])
