"""``portbench/model_costs.py`` and the decode cell's readers, on the
CPU: the step's bytes and operations at Granite's published widths (the
figures its configuration file implies), and each reader on a context
built by hand."""
import json
from types import SimpleNamespace

import pytest

from portbench import harness, model_costs as mc
from portbench.tests.conftest import REPO

CELL = "granite-4.0-h-small.decode-b128"


@pytest.fixture(scope="module")
def graph():
    cell = harness.resolve(CELL, REPO)
    ref = harness.load_module(REPO / "portbench" / "reference"
                              / "granite_hybrid.py", "reference_gh_costs")
    return ref.graph_of(cell.config, cell.traffic, 5)


def test_the_step_at_the_published_widths(graph):
    # 36 Mamba-2 mixers, 4 attention, 40 x (9 experts + shared + router)
    # and the tied table, in bfloat16 (the router float32)
    assert mc.weight_bytes(graph) == pytest.approx(16.875e9, rel=1e-3)
    # 36 layers x 128 slots x 4 MiB of float32 state, and the conv tails
    assert mc.state_bytes(graph, 128) == pytest.approx(
        36 * 128 * (4 * 128 * 64 * 128 + 2 * 3 * (8192 + 256)))
    w = mc.step_work(graph, [1400] * 128, 128 * 40 * 10 * 9 / 72)
    assert w.bytes == pytest.approx(58.96e9, rel=1e-3)
    assert 17.5e-3 < w.bound_s < 17.7e-3
    assert w.bound_s == w.bytes / mc.HBM_PEAK_BYTES_S
    deeper = mc.step_work(graph, [2400] * 128, 128 * 40 * 10 * 9 / 72)
    kv = 4 * 2 * 8 * 128 * 2 * 1000 * 128  # 1000 more rows a slot read
    assert deeper.bytes - w.bytes == pytest.approx(kv)


def test_the_parts_timed_alone(graph):
    e = mc.expert_work(graph, 16.0, 128)
    weights = 2 * (9 * 3 * 4096 * 768 + 3 * 4096 * 1536) + 4 * 4096 * 72
    assert e.bytes == weights + 2 * 2 * 128 * 4096
    assert e.ops == 2 * (3 * 4096 * 768 * 16 + 128 * (3 * 4096 * 1536
                                                      + 4096 * 72))
    s = mc.ssm_step_work(graph, 128)
    assert s.bytes > 2 * 4 * 128 * 128 * 64 * 128
    assert s.bound_s == pytest.approx(322e-6, rel=1e-2)


def test_the_readers_on_a_traced_window(graph):
    counter = SimpleNamespace(name="moe.held_pairs", values=(4 * 40 * 160,))
    runs = [{"depths": [1000] * 128, "held_pairs": 4 * 40 * 160,
             "recording": SimpleNamespace(counters=[counter])}] * 3
    ctx = SimpleNamespace(
        device=SimpleNamespace(type="cuda"), graph=graph,
        loop=SimpleNamespace(split_runs=runs),
        window=SimpleNamespace(seconds=1.5),
        kernels={"expert": 2e-4, "ssm_step": 1.6e-3})
    cell = harness.resolve(CELL, REPO)
    read = {m["name"]: harness.reader(cell, m).read(ctx)
            for m in cell.per_layer if m["name"] != "device_idle_share.decode"}
    steps = sum(mc.step_work(graph, [1000 + t + 1] * 128, 40 * 160)
                .bytes for t in range(4)) * 3
    assert read["decode_mbu"] == pytest.approx(
        100 * steps / (1.5 * mc.HBM_PEAK_BYTES_S))
    assert 0 < read["decode_mfu"] < read["decode_mbu"]
    assert read["expert_roofline"] == pytest.approx(
        100 * mc.expert_work(graph, 160, 128).bound_s / 2e-4)
    assert read["ssm_step_roofline"] == pytest.approx(
        100 * mc.ssm_step_work(graph, 128).bound_s / 1.6e-3)
    ctx.kernels, ctx.loop = None, SimpleNamespace()
    assert all(harness.reader(cell, m).read(ctx) is None
               for m in cell.per_layer
               if m["name"] != "device_idle_share.decode")


def test_the_config_file_holds_the_catalogs_numbers():
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "granite-4.0-h-small.json").read_text())
    assert cfg["reduced"] == ["num_local_experts"]
    assert (cfg["num_local_experts"], cfg["published"]) == (
        9, {"num_local_experts": 72})
    assert cfg["experts_held"] == [0, 9]
    assert len(cfg["layer_types"]) == cfg["num_hidden_layers"] == 40
    assert cfg["vocab_size"] == 100352 and cfg["hidden_size"] == 4096
