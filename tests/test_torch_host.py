"""``torch-host`` (counterpart of ``host-dynamic``) on the CPU.

On the card a task is ~20 PyTorch launches, K1 or K2 among them
(``tests/test_torch_gpu.py``); asked for the CPU (``[device=cpu]``) the
same operations run there, the kernel wrappers taking their plain
versions.  Here the backend is held to the numpy oracle on every pattern x
kernel kind, bitwise to ``torch-scan`` (empty, compute, memory), to the
reference ``host-dynamic`` (bitwise at the iteration counts where XLA's
contracted FMA cannot show, ``test_torch_backends.CROSS_ITERS``, within
``check_outputs``' rtol past them), ``run_many`` to ``run``, its dispatch
order to the reference's, and its runner to the rule that nothing is
staged from host memory inside a run.  Also here: the dynamic mode of
``masked_loop`` and the port's copy of ``core.schedule``.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.backends as ref_backends  # noqa: E402
import repro.core as rc  # noqa: E402
import repro.core.schedule as ref_schedule  # noqa: E402
import repro_torch.backends as tb  # noqa: E402
import repro_torch.core.schedule as schedule  # noqa: E402
from repro_torch.core import (check_outputs, execute_reference,  # noqa: E402
                              make_graph, pattern_names, replicate)
from repro_torch.core.kernel_ref import mxu_weight  # noqa: E402
from repro_torch.core.kernel_spec import KernelSpec  # noqa: E402
from repro_torch.kernels import bodies  # noqa: E402

HOSTS = ["torch-host[device=cpu]",
         "torch-host[schedule=steal,workers=3,device=cpu]"]
REF_OF = {HOSTS[0]: "host-dynamic[workers=3]",
          HOSTS[1]: "host-dynamic[schedule=steal,workers=3]"}
SCAN = "torch-scan[device=cpu]"
KINDS = ["empty", "compute", "memory", "compute_mxu"]
PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
# iterations per kind where XLA-CPU agrees with the oracle to the bit
# (tests/test_torch_backends.py)
CROSS_ITERS = {"empty": 4, "compute": 37, "memory": 7}


def graph_kw(pattern="stencil", kind="compute", iterations=5, **kw):
    args = dict(width=6, height=8, pattern=pattern, kernel=kind,
                iterations=iterations, imbalance=0.5, span_bytes=512,
                scratch_bytes=2048, **PATTERN_KW.get(pattern, {}))
    args.update(kw)
    return args


def small(pattern="stencil", kind="compute", **kw):
    its = 2 if kind == "compute_mxu" else 5
    return make_graph(**graph_kw(pattern, kind, its, **kw))


@pytest.fixture(scope="module")
def oracle():
    cache = {}

    def get(graph):
        if graph not in cache:
            cache[graph] = execute_reference(graph)
        return cache[graph]

    return get


# ------------------------------------------------------------ conformance
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pattern", pattern_names())
@pytest.mark.parametrize("backend", HOSTS)
def test_torch_host_matches_oracle_and_torch_scan(backend, pattern, kind,
                                                  oracle):
    """compute_mxu is held within check_outputs' tolerance only: a batch of
    one matmul against torch-scan's batch of W may round differently."""
    g = small(pattern, kind)
    out = tb.get_backend(backend).run([g])[0]
    check_outputs(g, out, expected=oracle(g))
    if kind != "compute_mxu":
        np.testing.assert_array_equal(out, oracle(g))
        np.testing.assert_array_equal(out, tb.get_backend(SCAN).run([g])[0])


@pytest.mark.parametrize("backend", HOSTS)
def test_imbalanced_and_ragged_graphs(backend):
    """The conditions the steal schedule exists for: heterogeneous task
    durations, wavefronts wider than the worker pool
    (``tests/test_conformance.py``'s study-mode cases)."""
    for g in (make_graph(width=6, height=8, pattern="stencil", iterations=6,
                         imbalance=0.7),
              make_graph(width=10, height=6, pattern="stencil", iterations=5,
                         imbalance=1.5),
              make_graph(width=3, height=5, pattern="sweep", iterations=4,
                         imbalance=2.0)):
        out = tb.get_backend(backend).run([g])[0]
        np.testing.assert_array_equal(out, execute_reference(g))


# ------------------------------------------------------- the reference
@pytest.mark.parametrize("kind", ["empty", "compute", "memory"])
@pytest.mark.parametrize("pattern", ["stencil", "sweep", "fft"])
@pytest.mark.parametrize("backend", HOSTS)
def test_matches_host_dynamic_bitwise(backend, pattern, kind):
    kw = graph_kw(pattern, kind, iterations=CROSS_ITERS[kind])
    got = tb.get_backend(backend).run([make_graph(**kw)])[0]
    want = ref_backends.get_backend(REF_OF[backend]).run(
        [rc.make_graph(**kw)])[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,iterations", [("compute", 16),
                                              ("memory", 12)])
@pytest.mark.parametrize("pattern", ["stencil", "sweep", "fft"])
@pytest.mark.parametrize("backend", HOSTS)
def test_matches_host_dynamic_within_rtol(backend, pattern, kind,
                                          iterations):
    """Past CROSS_ITERS the reference's contracted FMA can leave it an ulp
    from the port: checksum slots exact, slots 4+ within rtol 1e-5 /
    atol 1e-6 (check_outputs' contract)."""
    kw = graph_kw(pattern, kind, iterations=iterations)
    g = make_graph(**kw)
    got = tb.get_backend(backend).run([g])[0]
    want = ref_backends.get_backend(REF_OF[backend]).run(
        [rc.make_graph(**kw)])[0]
    check_outputs(g, got, expected=want)


@pytest.mark.parametrize("imbalance", [0.0, 1.5, 3.0])
@pytest.mark.parametrize("workers", [1, 3, 4, 8])
@pytest.mark.parametrize("schedule", ["static", "steal"])
def test_dispatch_order_equals_reference(schedule, workers, imbalance):
    port = tb.get_backend(f"torch-host[schedule={schedule},"
                          f"workers={workers},device=cpu]")
    ref = ref_backends.get_backend(f"host-dynamic[schedule={schedule},"
                                   f"workers={workers}]")
    for pattern in pattern_names():
        kw = dict(width=11, height=5, pattern=pattern, iterations=7,
                  imbalance=imbalance, **PATTERN_KW.get(pattern, {}))
        assert port.dispatch_order(make_graph(**kw)) == \
            ref.dispatch_order(rc.make_graph(**kw)), pattern


@settings(max_examples=25, deadline=None)
@given(width=st.integers(1, 16), imbalance=st.sampled_from([0.0, 1.5, 3.0]),
       workers=st.sampled_from([1, 3, 4, 8]))
def test_steal_dispatch_each_task_once_respecting_deps(width, imbalance,
                                                       workers):
    """``tests/test_patterns.py``'s property on the port: each task issues
    exactly once, and after all of its dependencies."""
    be = tb.get_backend("torch-host", schedule="steal", workers=workers,
                        device="cpu")
    for pattern in pattern_names():
        g = make_graph(width=width, height=5, pattern=pattern, iterations=7,
                       imbalance=imbalance,
                       **({"radix": min(3, width)}
                          if pattern in PATTERN_KW else {}))
        trace = be.dispatch_order(g)
        assert sorted(trace) == [(t, i) for t in range(g.height)
                                 for i in range(g.width)], pattern
        pos = {ti: k for k, ti in enumerate(trace)}
        for t in range(1, g.height):
            for i in range(g.width):
                for j in g.deps(t, i):
                    assert pos[(t - 1, j)] < pos[(t, i)], (pattern, t, i, j)


# ------------------------------------------------------ concurrent runs
@pytest.mark.parametrize("ngraphs", [2, 3])
@pytest.mark.parametrize("pattern", ["stencil", "spread"])
@pytest.mark.parametrize("backend", HOSTS)
def test_run_many_matches_run(backend, pattern, ngraphs):
    g = small(pattern)
    be = tb.get_backend(backend)
    single = be.run([g])[0]
    outs = be.run_many(replicate(g, ngraphs))
    assert len(outs) == ngraphs
    for out in outs:
        np.testing.assert_array_equal(out, single)


@pytest.mark.parametrize("backend", HOSTS)
def test_run_many_imbalanced_kernel(backend):
    """Interleaved wavefronts under an imbalanced kernel must not mix up
    which iteration count belongs to which task
    (``tests/test_conformance.py::test_host_dynamic_run_many_imbalanced_
    kernel``)."""
    g = make_graph(width=6, height=8, pattern="stencil", iterations=6,
                   imbalance=0.7)
    be = tb.get_backend(backend)
    alone = be.run([g])[0]
    np.testing.assert_array_equal(alone, execute_reference(g))
    for out in be.run_many(replicate(g, 3)):
        np.testing.assert_array_equal(out, alone)


@pytest.mark.parametrize("backend", HOSTS)
def test_run_many_mixed_patterns_and_shapes(backend, oracle):
    be = tb.get_backend(backend)
    mixed = [small(p, "memory") for p in ("stencil", "fft", "random",
                                          "nearest")]
    shapes = [small("stencil"), small("stencil", width=5),
              make_graph(width=4, height=5, pattern="sweep", iterations=2),
              small("fft", "empty", output_bytes=40)]
    for graphs in (mixed, shapes):
        outs = be.run_many(graphs)
        assert len(outs) == len(graphs)
        for g, out in zip(graphs, outs):
            assert out.shape == (g.width, g.payload_elems)
            np.testing.assert_array_equal(out, oracle(g))
            np.testing.assert_array_equal(out, be.run([g])[0])


# ------------------------------------------------ nothing from the host
def _forbid(*_, **__):
    raise AssertionError("host data staged inside a run")


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_runner_stages_nothing_from_host_memory(monkeypatch, kind, many):
    """What the reference's task reads from host scalars is staged in
    ``prepare``: the runner runs with every host-staging entry point
    patched to raise, and gives the same output."""
    be = tb.get_backend(HOSTS[1])
    graphs = [small("stencil", kind), small("fft", kind)]
    runner = be.prepare_many(graphs) if many else be.prepare(graphs)
    want = runner()
    with monkeypatch.context() as m:
        for name in ("as_tensor", "tensor", "from_numpy"):
            m.setattr(torch, name, _forbid)
        got = runner()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- registry
def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("torch-host", "torch-host[schedule=steal,workers=2]",
                 "torch-host[device=cuda]"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.get_backend(spec)
    assert tb.get_backend("torch-host[device=cpu]").device == \
        torch.device("cpu")


def test_options_and_model_hints():
    be = tb.get_backend("torch-host[schedule=steal,workers=2,device=cpu]")
    assert (be.schedule, be.workers, be.sched_policy) == ("steal", 2, "steal")
    assert tb.get_backend("torch-host[device=cpu]").sched_policy == "static"
    assert tb.HostBackend.dispatch_model == "per-task"
    assert tb.HostBackend.comm_overlap is False
    assert tb.backend_option_signature("torch-host") == {
        "schedule": "static", "workers": 4, "device": None}
    with pytest.raises(ValueError, match="unknown schedule"):
        tb.get_backend("torch-host[schedule=nope,device=cpu]")
    with pytest.raises(ValueError, match="workers must be >= 1"):
        tb.get_backend("torch-host[workers=0,device=cpu]")


def test_model_hints_match_each_reference_class():
    """Each counterpart carries its reference's ``dispatch_model``,
    ``sched_policy`` and ``comm_overlap``."""
    pairs = {"torch-host": "host-dynamic", "torch-scan": "xla-scan",
             "cuda-graph": "xla-static", "cuda-fused": "pallas-fused"}
    for port, ref in pairs.items():
        a, b = tb.base._BACKENDS[port], ref_backends.base._BACKENDS[ref]
        for attr in ("dispatch_model", "sched_policy", "comm_overlap"):
            assert getattr(a, attr) == getattr(b, attr), (port, attr)


@pytest.mark.parametrize("spec", [
    "torch-host", "torch-host[workers=2,schedule=steal]",
    "x[b=cpu,a=False,c=4]", "x[device=cuda:0]"])
def test_canonical_backend_spec_matches_reference(spec):
    from repro.backends.base import canonical_backend_spec as ref_canon

    assert tb.canonical_backend_spec(spec) == ref_canon(spec)


# --------------------------------------------------------- dynamic mode
STEPS = {
    "compute": (lambda k, a: bodies.compute_step(a), (8, 128)),
    "memory": (lambda k, a: bodies.memory_step(a), (64,)),
    "compute_mxu": (None, (128, 128)),
}


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("kind", ["compute", "memory", "compute_mxu"])
def test_masked_loop_dynamic_is_bitwise_with_static(kind, width):
    """For columns that all run the trip (a task's single column, or equal
    counts), the unmasked dynamic loop gives the static mode's bits."""
    step, shape = STEPS[kind]
    if step is None:
        w = torch.as_tensor(mxu_weight())
        step = lambda k, b: bodies.mxu_step(b, w)  # noqa: E731
    rng = np.random.RandomState(width)
    state = torch.from_numpy(
        rng.uniform(0.0, 0.5, (width,) + shape).astype(np.float32))
    trip = 6
    iters = torch.full((width,), trip, dtype=torch.int32)
    static = bodies.masked_loop(step, state, iters, 9)
    dynamic = bodies.masked_loop(step, state, iters, trip, dynamic=True)
    assert torch.equal(static, dynamic)


@pytest.mark.parametrize("its", [1, 5, 9])
@pytest.mark.parametrize("kind", KINDS)
def test_run_kernel_columns_dynamic_trip_is_bitwise_with_static(kind, its):
    """A task's column in dynamic mode (trip = its own iterations) against
    the static mode's keep-masked ``kernel.iterations`` steps."""
    kernel = KernelSpec(kind=kind, iterations=9, span_bytes=512,
                        scratch_bytes=2048)
    iters = torch.tensor([[its]], dtype=torch.int32)
    seed = torch.tensor([[float((1 << 20) - 3) * bodies.FOLD_BLOCK]])
    static = bodies.run_kernel_columns(kernel, iters, seed, 9)
    for plain in (False, True):
        dynamic = bodies.run_kernel_columns(kernel, iters, seed, its,
                                            dynamic=True, plain=plain)
        assert torch.equal(static, dynamic), plain


# ------------------------------------------------------- core.schedule
@settings(max_examples=60, deadline=None)
@given(costs=st.lists(st.floats(0.0, 1e3, allow_nan=False), min_size=1,
                      max_size=40),
       workers=st.integers(1, 9))
def test_schedule_copy_equals_reference(costs, workers):
    order, start, span = schedule.steal_schedule(costs, workers)
    r_order, r_start, r_span = ref_schedule.steal_schedule(costs, workers)
    assert order == r_order and span == r_span
    np.testing.assert_array_equal(start, r_start)
    for policy in schedule.POLICIES:
        assert schedule.wavefront_makespan(costs, workers, policy) == \
            ref_schedule.wavefront_makespan(costs, workers, policy)
    np.testing.assert_array_equal(
        schedule.static_owners(len(costs), workers),
        ref_schedule.static_owners(len(costs), workers))


def test_schedule_rejects_like_reference():
    for mod in (schedule, ref_schedule):
        with pytest.raises(ValueError):
            mod.steal_schedule([], 2)
        with pytest.raises(ValueError):
            mod.steal_schedule([1.0], 0)
        with pytest.raises(ValueError):
            mod.static_owners(0, 2)
        with pytest.raises(ValueError, match="unknown policy"):
            mod.wavefront_makespan([1.0], 2, "lifo")
