"""``cuda-graph`` (counterpart of ``xla-static``) on the CPU.

On the card the backend captures ``torch-scan``'s program once as a CUDA
graph and replays it (``tests/test_torch_gpu.py``); asked for the CPU it
runs the same program eagerly.  Here it is held bitwise to
``torch-scan[device=cpu]`` and to the numpy oracle on every pattern x
kernel kind, ``run_many`` to ``run``, and its program to the rule a capture
needs: nothing staged from host memory while it runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.backends as tb  # noqa: E402
from repro_torch.backends import body  # noqa: E402
from repro_torch.core import (execute_reference, make_graph,  # noqa: E402
                              pattern_names, replicate)
from repro_torch.core.kernel_ref import mxu_weight  # noqa: E402

GRAPH = "cuda-graph[device=cpu]"
SCAN = "torch-scan[device=cpu]"
KINDS = ["empty", "compute", "compute_mxu", "memory"]
PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}


def small(pattern="stencil", kind="compute", **kw):
    args = dict(width=6, height=8, pattern=pattern, kernel=kind,
                iterations=2 if kind == "compute_mxu" else 5, imbalance=0.5,
                span_bytes=512, scratch_bytes=2048,
                **PATTERN_KW.get(pattern, {}))
    args.update(kw)
    return make_graph(**args)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pattern", pattern_names())
def test_cuda_graph_is_bitwise_with_torch_scan_and_oracle(pattern, kind):
    g = small(pattern, kind)
    got = tb.get_backend(GRAPH).run([g])[0]
    np.testing.assert_array_equal(got, tb.get_backend(SCAN).run([g])[0])
    np.testing.assert_array_equal(got, execute_reference(g))


@pytest.mark.parametrize("kind", KINDS)
def test_run_many_is_bitwise_with_run(kind):
    be = tb.get_backend(GRAPH)
    graphs = [small(p, kind) for p in ("stencil", "fft", "random")]
    assert body.stackable(graphs)
    for got, g in zip(be.run_many(graphs), graphs):
        np.testing.assert_array_equal(got, be.run([g])[0])
    for got in be.run_many(replicate(graphs[0], 3)):
        np.testing.assert_array_equal(got, be.run([graphs[0]])[0])


def test_no_construction_without_a_device_on_a_cpu_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("cuda-graph", "cuda-graph[device=cuda]"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.get_backend(spec)
    assert tb.get_backend(GRAPH).device == torch.device("cpu")


def _forbid(*_, **__):
    raise AssertionError("host data staged inside the program")


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_program_stages_nothing_from_host_memory(monkeypatch, kind, stacked):
    """A capture records device work only: a host-to-device copy made while
    the program runs (as compute_mxu's weight upload once was) cannot be
    captured.  The built program runs with every host-staging entry point
    patched to raise, and gives the same output."""
    be = tb.get_backend(GRAPH)
    graphs = [small("stencil", kind), small("fft", kind)]
    program = (be._build_stacked(graphs) if stacked
               else be._build(graphs))
    want = program()
    with monkeypatch.context() as m:
        for name in ("as_tensor", "tensor", "from_numpy"):
            m.setattr(torch, name, _forbid)
        got = program()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_staged_mxu_weight_is_bitwise_with_the_per_call_upload():
    """``torch-scan`` stages the compute_mxu weight once per backend; the
    task body gives the same bits as with the weight made per call."""
    g = small("stencil", "compute_mxu")
    hist = execute_reference(g, return_all=True)
    mats, iters = body.graph_static_inputs(g)
    args = (g, 3, torch.from_numpy(hist[2]), torch.from_numpy(mats[3]),
            torch.from_numpy(iters[3]))
    w = torch.as_tensor(mxu_weight())
    assert torch.equal(body.timestep(*args, mxu_w=w), body.timestep(*args))
    be = tb.get_backend(SCAN)
    assert be._mxu_w is be._mxu_w and torch.equal(be._mxu_w, w)
