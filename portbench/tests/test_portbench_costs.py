"""The benchmark's cost arithmetic against the program's declared costs.

``portbench/costs.py`` is the benchmark's own copy of the work each kernel
needs.  Where the program declares the same quantity (``kernels/_cost.py``
and the wrappers' ``cost``), the two agree, except where the benchmark's
rule differs on purpose: K2's declared bytes count its whole scratch, the
benchmark's only the windows that get an application.
"""
import json

import pytest
import torch

from portbench import costs
from portbench.loops.graph_runs import graph_of
from portbench.tests.conftest import REPO
from repro_torch.backends.megakernel import MegakernelBackend, fused_cost
from repro_torch.core.graph import make_graph
from repro_torch.kernels.compute import compute_cost
from repro_torch.kernels.memory import memory_cost


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def memory_graph(width=132, iterations=32, scratch=2 << 20, span=64 << 10):
    return {"kind": "memory", "width": width, "height": 1000,
            "iterations": iterations, "scratch_bytes": scratch,
            "span_bytes": span, "output_bytes": 16, "radix": 3}


def k2_declared(g):
    span, size, _ = costs.memory_geometry(g)
    its = torch.full((g["width"],), g["iterations"], dtype=torch.int32)
    return memory_cost(meta(g["width"], size), its, span)


def test_k2_bytes_equal_the_declared_cost_when_every_window_is_touched():
    g = memory_graph()
    _, _, nwin = costs.memory_geometry(g)
    assert g["iterations"] == nwin == 32
    declared = k2_declared(g)
    ours = costs.k2(g)
    assert ours.bytes == declared.bytes
    assert ours.ops == declared.ops


@pytest.mark.parametrize("iterations", [1, 4, 16, 31])
def test_k2_bytes_are_smaller_when_windows_get_no_application(iterations):
    g = memory_graph(iterations=iterations)
    declared = k2_declared(g)
    ours = costs.k2(g)
    assert ours.bytes < declared.bytes
    assert ours.ops == declared.ops
    _, _, nwin = costs.memory_geometry(g)
    untouched = g["width"] * (nwin - iterations) * 64 * 1024 * 2
    assert declared.bytes - ours.bytes == untouched


def test_k1_equals_the_declared_cost():
    g = {"kind": "compute", "width": 132, "iterations": 64}
    declared = compute_cost(meta(132, 8, 128),
                            meta(132, dtype=torch.int32), 64)
    assert costs.k1(g) == (declared.ops, declared.bytes)


@pytest.mark.parametrize("name,traffic", [("stencil-compute", "fused-i64"),
                                          ("stencil-memory", "fused-i32")])
def test_k3_equals_the_declared_cost_plus_the_memory_bodys_windows(
        name, traffic):
    config = json.loads((REPO / f"portbench/configs/{name}.json").read_text())
    tr = json.loads((REPO / f"portbench/traffic/{traffic}.json").read_text())
    g = graph_of(dict(config, height=50), tr, 0)
    graph = make_graph(width=g["width"], height=g["height"],
                       pattern=g["pattern"], kernel=g["kind"],
                       iterations=g["iterations"],
                       output_bytes=g["output_bytes"],
                       span_bytes=g["span_bytes"],
                       scratch_bytes=g["scratch_bytes"])
    tabs = [torch.from_numpy(t) for t in
            MegakernelBackend._tables([graph], g["radix"])] + [None]
    declared = fused_cost(*tabs, kernel=graph.kernel, ngraphs=1,
                          height=g["height"],
                          payload_elems=graph.payload_elems)
    ours = costs.k3(g)
    assert ours.ops == declared.ops
    body = g["height"] * g["width"] * costs.body_bytes(g, g["iterations"])
    assert ours.bytes == declared.bytes + body
    assert (body > 0) == (g["kind"] == "memory")


@pytest.mark.parametrize("kind", ["compute", "memory"])
def test_useful_work_equals_the_graphs_own(kind):
    g = memory_graph(width=13, iterations=20) if kind == "memory" else {
        "kind": "compute", "width": 13, "height": 1000, "iterations": 64}
    graph = make_graph(width=13, height=1000, kernel=kind,
                       iterations=g["iterations"], span_bytes=64 << 10,
                       scratch_bytes=2 << 20)
    useful = costs.useful_flops(g) if kind == "compute" \
        else costs.useful_bytes(g)
    assert useful == graph.total_useful_work()


def test_bound_is_the_larger_of_the_two_rooflines():
    w = costs.Work(ops=67e12, bytes=3.35e12 / 2)
    assert w.bound_s == 1.0
    assert costs.Work(ops=0.0, bytes=6.7e12).bound_s == 2.0
