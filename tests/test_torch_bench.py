"""The port's METG layer equals the reference's, and drives the port.

``repro_torch.bench`` keeps its own copy of the metric math, the scenario
specs and ``run_scenario``; these tests hold the copy equal to
``repro.bench`` on the same inputs and run a smoke sweep on the port's
backends (on the CPU, as asked for in the spec string).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.bench as rb  # noqa: E402
import repro_torch.bench as pb  # noqa: E402
from repro_torch.bench.timers import (cached_backend, pick_sample,  # noqa: E402
                                      timer_config)


def synthetic_points(mod, overhead, per_iter, tasks=64,
                     schedule=(4096, 1024, 256, 64, 16, 4, 1)):
    """Points of the paper's overhead model: wall = tasks*(o + it*c)."""
    return [mod.SweepPoint(iterations=it, wall_time=tasks * (overhead
                                                             + it * per_iter),
                           num_tasks=tasks, useful_work=tasks * it * 2048.0)
            for it in schedule]


def metg_fields(res):
    return (res.metg, res.threshold, res.peak_rate,
            [(p.iterations, p.granularity, p.rate, p.efficiency)
             for p in res.points])


@pytest.mark.parametrize("overhead,per_iter", [
    (1e-6, 1e-9), (5e-5, 1e-9), (1e-7, 3e-8), (0.0, 1e-9), (2e-3, 1e-9)])
@pytest.mark.parametrize("threshold", [0.5, 0.8])
def test_compute_metg_matches_reference(overhead, per_iter, threshold):
    got = pb.compute_metg(synthetic_points(pb, overhead, per_iter),
                          threshold=threshold)
    want = rb.compute_metg(synthetic_points(rb, overhead, per_iter),
                           threshold=threshold)
    assert metg_fields(got) == metg_fields(want)


def test_compute_metg_with_pinned_peak_matches_reference():
    got = pb.compute_metg(synthetic_points(pb, 1e-6, 1e-9), peak_rate=4e12)
    want = rb.compute_metg(synthetic_points(rb, 1e-6, 1e-9), peak_rate=4e12)
    assert metg_fields(got) == metg_fields(want)
    assert got.metg is None  # the pinned peak is out of reach


def test_sweep_point_and_curve_match_reference():
    import repro.core as rc
    import repro_torch.core as tc

    kw = dict(width=6, height=5, kernel="memory", iterations=9,
              imbalance=0.7, span_bytes=512, scratch_bytes=2048)
    a = pb.sweep_point([tc.make_graph(**kw)] * 2, 9, 0.25, cores=4)
    b = rb.sweep_point([rc.make_graph(**kw)] * 2, 9, 0.25, cores=4)
    assert vars(a) == vars(b)
    assert [vars(p) for p in pb.efficiency_curve([a])] == \
        [vars(p) for p in rb.efficiency_curve([b])]


@pytest.mark.parametrize("hi,lo,factor", [(4096, 1, 2.0), (4096, 1, 4.0),
                                          (100, 3, 3.0), (1, 1, 2.0)])
def test_geometric_iterations_matches_reference(hi, lo, factor):
    assert pb.geometric_iterations(hi, lo, factor) == \
        rb.geometric_iterations(hi, lo, factor)


def test_geometric_iterations_rejects_like_reference():
    for mod in (pb, rb):
        with pytest.raises(ValueError):
            mod.geometric_iterations(4, 8)


@pytest.mark.parametrize("controls", [
    {}, {"n_points": 3}, {"iterations_hi": 64, "iterations_lo": 2},
    {"schedule": (300, 30, 3)}, {"smoke": True},
    {"smoke": True, "schedule": (300, 64, 30, 3)}])
def test_sweep_controls_match_reference(controls):
    a, b = pb.SweepControls(**controls), rb.SweepControls(**controls)
    assert a.iteration_schedule() == b.iteration_schedule()
    assert dataclasses.asdict(a.resolved()) == dataclasses.asdict(b.resolved())


def test_scenario_spec_matches_reference_but_defaults_to_the_port():
    kw = dict(name="x", pattern="nearest", kernel="memory", width=6,
              height=40, ngraphs=2, graph_kw=(("radix", 5),
                                              ("scratch_bytes", 4096),
                                              ("span_bytes", 512)))
    a, b = pb.ScenarioSpec(**kw).with_smoke(), rb.ScenarioSpec(**kw).with_smoke()
    assert a.resolved().height == b.resolved().height == 8
    ga, gb = a.graphs(16), b.graphs(16)
    assert len(ga) == len(gb) == 2
    assert repr(ga[0]) == repr(gb[0])
    assert pb.ScenarioSpec(name="x").backend == "torch-scan"
    assert rb.ScenarioSpec(name="x").backend == "xla-scan"


def test_pick_sample_matches_reference():
    from repro.bench.timers import pick_sample as ref_pick

    samples = [0.3, 0.1, 0.5, 0.2, 0.4]
    for pct in (0, -1, 1, 50, 90, 100):
        assert pick_sample(samples, pct) == ref_pick(samples, pct)
    with pytest.raises(ValueError):
        pick_sample([], 0)


def test_wallclock_timer_resolves_the_port_registry():
    from repro_torch.backends import ScanBackend

    cache = {}
    be = cached_backend(cache, "torch-scan[device=cpu]")
    assert isinstance(be, ScanBackend)
    assert cached_backend(cache, "torch-scan[device=cpu]") is be
    timer = pb.WallClockTimer(warmup=0, repeats=2)
    assert isinstance(timer, pb.Timer)
    assert timer_config(timer) == {"warmup": 0, "repeats": 2,
                                   "percentile": 0.0}
    with pytest.raises(KeyError, match="unknown backend"):
        cached_backend({}, "xla-scan")


@pytest.mark.parametrize("backend", ["torch-scan[device=cpu]",
                                     "cuda-fused[device=cpu]"])
def test_run_scenario_smoke_sweep(backend):
    spec = pb.ScenarioSpec(name=f"smoke.{backend}", backend=backend,
                           width=4, height=32, ngraphs=2,
                           sweep=pb.SweepControls(smoke=True))
    res = pb.run_scenario(spec)
    assert res.timer == "wallclock"
    assert res.spec.height == 8
    assert [p.iterations for p in res.points] == \
        spec.sweep.iteration_schedule()
    assert all(p.wall_time > 0 and p.num_tasks == 2 * 4 * 8
               for p in res.points)
    assert res.peak_rate == max(p.rate for p in res.points)
    assert max(p.efficiency for p in res.points) == 1.0


def test_run_scenario_default_backend_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.run_scenario(pb.ScenarioSpec(name="x").with_smoke())
