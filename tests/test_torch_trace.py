"""The port's span and counter recorder (``repro_torch.trace``) on the CPU:
nothing kept while it is off, spans nested with their parent and run, the
profiler's clock, and the runner's ``run`` ⊃ ``launch``, ``wait``,
``copy``.  K3's traced instance runs on the card only
(``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.backends import get_backend
from repro_torch.core import make_graph, replicate

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def small_graph(kind="compute"):
    return make_graph(width=4, height=3, kernel=kind, iterations=2,
                      span_bytes=256, scratch_bytes=1024)


def test_off_keeps_no_span_or_counter():
    assert not trace.active()
    ctx = trace.span("run")
    assert ctx is trace.span("launch")
    with ctx:
        pass
    assert trace.device_counters(("a",), 2, CPU) is None
    trace.wait(CPU)
    get_backend("torch-scan[device=cpu]").prepare([small_graph()])()
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == []
    assert not trace.active()


def test_spans_nest_with_their_parent_and_run():
    with trace.recording() as rec:
        assert trace.active()
        with trace.span("run"):
            with trace.span("a"):
                with trace.span("b"):
                    pass
            with trace.span("c"):
                pass
        with trace.span("run"):
            with trace.span("a"):
                pass
    got = [(s.name, s.parent, s.run) for s in rec.spans]
    assert got == [("run", -1, 0), ("a", 0, 0), ("b", 1, 0), ("c", 0, 0),
                   ("run", -1, 4), ("a", 4, 4)]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert rec.spans[1].end_ns <= rec.spans[3].start_ns
    assert all(type(s) is trace.Span and isinstance(s, tuple)
               for s in rec.spans)


def test_counters_are_read_back_when_recording_ends():
    with trace.recording() as rec:
        with trace.span("run"):
            with trace.span("launch"):
                buf = trace.device_counters(("x", "y"), 3, CPU)
                buf.copy_(torch.tensor([[1, 10], [2, 20], [3, 30]]))
        assert rec.counters == []
    assert rec.counters == [trace.Counter("x", 1, 0, (1, 2, 3)),
                            trace.Counter("y", 1, 0, (10, 20, 30))]


def test_recording_does_not_nest_and_ends_on_an_error():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with trace.recording():
                pass
    with pytest.raises(ValueError):
        with trace.recording():
            with trace.span("run"):
                raise ValueError("inside")
    assert not trace.active()
    assert trace.span("run") is trace.span("x")


def test_a_span_holds_its_op_on_the_profilers_clock():
    a = torch.randn(256, 256)
    with trace.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("op"):
                a @ a
    (op,) = rec.spans
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert op.start_ns <= e.start_ns() <= e.end_ns() <= op.end_ns


@pytest.mark.parametrize("many", [False, True])
@pytest.mark.parametrize("spec", ["torch-scan[device=cpu]",
                                  "cuda-fused[device=cpu]",
                                  "cuda-graph[device=cpu]"])
def test_a_runner_records_run_over_launch_wait_copy(spec, many):
    g = small_graph()
    be = get_backend(spec)
    runner = (be.prepare_many(replicate(g, 2)) if many
              else be.prepare([g, g]))
    want = runner()
    with trace.recording() as rec:
        got = runner()
        got2 = runner()
    for out in (got, got2):
        assert len(out) == len(want)
        for a, b in zip(out, want):
            assert np.array_equal(a, b)
    runs = [k for k, s in enumerate(rec.spans) if s.name == "run"]
    assert len(runs) == 2
    for k in runs:
        r = rec.spans[k]
        assert r.parent == -1 and r.run == k
        kids = [s for s in rec.spans if s.parent == k]
        assert [s.name for s in kids] == ["launch", "wait", "copy"]
        edges = [r.start_ns] + [x for s in kids
                                for x in (s.start_ns, s.end_ns)]
        assert edges == sorted(edges) and kids[-1].end_ns <= r.end_ns
    for s in rec.spans:
        root = s
        while root.parent >= 0:
            root = rec.spans[root.parent]
        assert s.run == rec.spans.index(root)
    inside = {s.name for s in rec.spans
              if s.parent >= 0 and rec.spans[s.parent].name == "launch"}
    # K3's plain version on the CPU: the wrapper checks, then computes
    assert inside == ({"fused.check"} if spec.startswith("cuda-fused")
                      else set())
    assert rec.counters == []
