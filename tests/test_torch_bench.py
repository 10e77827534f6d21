"""The port's METG layer equals the reference's, and drives the port.

``repro_torch.bench`` keeps its own copy of the metric math, the scenario
specs, ``run_scenario``, the synthetic clock, the studies and the
artifact writer and differ; these tests hold the copy equal to
``repro.bench`` on the same inputs (the synthetic clock's seconds to the
last bit, for each port backend against the reference backend it
counterparts) and run a smoke sweep on the port's backends (on the CPU,
as asked for in the spec string).
"""
import dataclasses
import json
from pathlib import Path

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


# ------------------------------------------------- the synthetic clock
# each port backend beside the reference backend it counterparts
PAIRS = [("torch-host", "host-dynamic"), ("torch-scan", "xla-scan"),
         ("cuda-graph", "xla-static"), ("cuda-fused", "pallas-fused"),
         ("torch-csp", "shardmap-csp"),
         ("torch-pipeline", "shardmap-pipeline")]


def _graph_pair(**kw):
    import repro.core as rc
    import repro_torch.core as tc

    args = dict(width=8, height=6, pattern="stencil", iterations=64,
                imbalance=2.0)
    args.update(kw)
    return tc.make_graph(**args), rc.make_graph(**args)


@pytest.fixture
def no_card_no_backend(monkeypatch):
    """CUDA unavailable, and any construction of a port backend fails: the
    synthetic clock must need neither."""
    import repro_torch.backends.base as base
    import repro_torch.bench.timers as timers

    def forbid(*_, **__):
        raise AssertionError("the synthetic clock constructed a backend")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(base, "get_backend", forbid)
    monkeypatch.setattr(timers, "cached_backend", forbid)


@pytest.mark.parametrize("timer_kw", [
    {}, {"workers": 4}, {"workers": 3, "seconds_per_iteration": 2e-6},
    {"seconds_per_byte": 4e-9}, {"seconds_per_rendezvous": 2e-6},
    {"seconds_per_dependency": 1e-6, "seconds_per_byte": 4e-9,
     "workers": 2}])
@pytest.mark.parametrize("options", ["", "[schedule=static,workers=2]",
                                     "[schedule=steal]",
                                     "[schedule=steal,workers=3]"])
@pytest.mark.parametrize("pattern", ["stencil", "fft", "nearest"])
def test_synthetic_host_seconds_equal_reference(no_card_no_backend, pattern,
                                                options, timer_kw):
    """``torch-host[...]`` is charged exactly ``host-dynamic[...]``'s
    seconds; the spec's own ``workers`` (or the constructor default, 4)
    overrides the timer's, as the reference's constructed backend does."""
    g, rg = _graph_pair(pattern=pattern,
                        **({"radix": 5} if pattern == "nearest" else {}))
    ours = pb.SyntheticTimer(**timer_kw).measure(f"torch-host{options}",
                                                 [g, g])
    ref = rb.SyntheticTimer(**timer_kw).measure(f"host-dynamic{options}",
                                                [rg, rg])
    assert ours == ref


@pytest.mark.parametrize("timer_kw", [
    {}, {"workers": 4}, {"seconds_per_byte": 4e-9,
                         "seconds_per_rendezvous": 2e-6},
    {"ranks": 1}, {"ranks": 4, "seconds_per_dependency": 1e-6},
    {"ranks": 2, "seconds_per_byte": 4e-9, "seconds_per_rendezvous": 2e-6}])
@pytest.mark.parametrize("port,ref", PAIRS)
def test_synthetic_seconds_equal_reference_for_each_pair(
        no_card_no_backend, port, ref, timer_kw):
    """Per-task (``torch-scan``/``xla-scan``, ``cuda-graph``/``xla-static``),
    per-launch (``cuda-fused``/``pallas-fused``) and the ``ranks >= 1``
    model, to the last bit."""
    g, rg = _graph_pair(imbalance=0.5)
    assert pb.timers.backend_dispatch_model(port) == \
        rb.timers.backend_dispatch_model(ref)
    ours = pb.SyntheticTimer(**timer_kw).measure(port, [g])
    assert ours == rb.SyntheticTimer(**timer_kw).measure(ref, [rg])


def test_synthetic_onesided_hints_equal_reference(no_card_no_backend):
    """The one-sided spec resolves by its options alone, as in the
    reference (``backend_comm_hints``)."""
    g, rg = _graph_pair(pattern="spread", radix=3)
    port = "cuda-fused[comm=onesided,ranks=4]"
    assert pb.timers.backend_comm_hints(port) == \
        rb.timers.backend_comm_hints("shardmap-csp[comm=onesided]")
    for kw in ({"ranks": 4, "seconds_per_byte": 4e-9},
               {"seconds_per_rendezvous": 2e-6}):
        assert pb.SyntheticTimer(**kw).measure(port, [g]) == \
            rb.SyntheticTimer(**kw).measure("pallas-fused[comm=onesided]",
                                            [rg])


def test_synthetic_model_hints_need_a_known_backend(no_card_no_backend):
    """The default path stays backend-free for any name; the study
    extensions need a registered backend, as the reference's do."""
    g, _ = _graph_pair()
    assert pb.SyntheticTimer().measure("no-such-backend", [g]) > 0
    with pytest.raises(KeyError, match="unknown backend"):
        pb.SyntheticTimer(workers=4).measure("host-dynamic", [g])
    assert pb.timers.backend_model_hints("torch-host", 1) == \
        ("static", False, False, 4)
    assert pb.timers.backend_model_hints(
        "torch-host[schedule=steal,workers=2,device=cpu]", 8) == \
        ("steal", False, False, 2)
    assert pb.timers.backend_model_hints("torch-scan", 3) == \
        ("static", False, False, 3)


def _study(mod):
    timer = mod.study_timer(
        mod.SyntheticTimer(), workers=mod.studies.STUDY_WORKERS,
        seconds_per_iteration=mod.studies.IMBALANCE_SECONDS_PER_ITERATION)
    results = {}
    for spec in mod.imbalance_study_specs():
        results[(spec.imbalance, spec.name.split(".")[2])] = \
            mod.run_scenario(spec, timer=timer)
    return results


def test_imbalance_study_equals_reference_on_the_fake_clock(
        no_card_no_backend):
    ours, ref = _study(pb), _study(rb)
    assert sorted(ours) == sorted(ref)
    for key, res in ours.items():
        assert res.spec.backend == ref[key].spec.backend.replace(
            "host-dynamic", "torch-host")
        assert res.spec.name == ref[key].spec.name.replace(
            "host-dynamic", "torch-host")
    curve = [(p.x, p.variant, p.elapsed_s, p.rate, p.metric)
             for p in pb.mitigation_curve(ours)]
    assert curve == [(p.x, p.variant, p.elapsed_s, p.rate, p.metric)
                     for p in rb.mitigation_curve(ref)]
    metric = {(x, v): m for x, v, _, _, m in curve}
    assert metric[(0.0, "static")] == metric[(0.0, "steal")] == 1.0
    assert metric[(2.0, "steal")] > metric[(2.0, "static")]


def _payload_study(mod, backend):
    timer = mod.study_timer(
        mod.SyntheticTimer(),
        seconds_per_byte=mod.studies.SECONDS_PER_BYTE,
        seconds_per_rendezvous=mod.studies.SECONDS_PER_RENDEZVOUS)
    return {(spec.output_bytes, spec.name.split(".")[2]):
            mod.run_scenario(spec, timer=timer)
            for spec in mod.payload_study_specs(backend)}


@pytest.mark.parametrize("port,ref", [("torch-csp", "shardmap-csp"),
                                      ("torch-pipeline",
                                       "shardmap-pipeline")])
def test_payload_study_equals_reference_on_the_fake_clock(
        no_card_no_backend, port, ref):
    """The communication-hiding study of ``metg_payload`` charges the
    reference's seconds to the bit, with no card and no backend built."""
    ours, want = _payload_study(pb, port), _payload_study(rb, ref)
    assert sorted(ours) == sorted(want)
    for key, res in ours.items():
        assert res.spec.backend == want[key].spec.backend.replace(ref, port)
        assert pb.elapsed_s(res) == rb.elapsed_s(want[key])
    curve = [(p.x, p.variant, p.elapsed_s, p.rate, p.metric)
             for p in pb.payload_curve(ours)]
    assert curve == [(p.x, p.variant, p.elapsed_s, p.rate, p.metric)
                     for p in rb.payload_curve(want)]
    elapsed = {(x, v): e for x, v, e, _, _ in curve}
    for ob in pb.studies.PAYLOAD_BYTES:
        assert elapsed[(ob, "onesided")] <= elapsed[(ob, "overlap")] \
            <= elapsed[(ob, "blocking")]


def test_study_specs_and_metrics_match_reference():
    for name in ("PAYLOAD_BYTES", "IMBALANCE_FACTORS", "STUDY_ITERATIONS",
                 "STUDY_WORKERS", "SECONDS_PER_BYTE",
                 "SECONDS_PER_RENDEZVOUS", "IMBALANCE_SECONDS_PER_ITERATION",
                 "PAYLOAD_VARIANTS", "IMBALANCE_VARIANTS",
                 "DEGENERATE_METRIC"):
        assert getattr(pb.studies, name) == getattr(rb.studies, name), name
    for a, b in zip(pb.imbalance_study_specs(), rb.imbalance_study_specs()):
        assert a.backend == b.backend.replace("host-dynamic", "torch-host")
        assert repr(dataclasses.replace(a, name="x", backend="y")) == \
            repr(dataclasses.replace(b, name="x", backend="y"))
    for a, b in zip(pb.payload_study_specs(), rb.payload_study_specs()):
        assert a.name == b.name.replace("shardmap-csp", "torch-csp")
        assert a.backend == b.backend.replace("shardmap-csp", "torch-csp")
    for num, den in ((1.0, 2.0), (0.0, 1.0), (1.0, float("inf")),
                     (-1.0, 1.0), (3.0, 3.0)):
        assert pb.overlap_efficiency(num, den) == \
            rb.overlap_efficiency(num, den)
        assert pb.mitigation_factor(num, den) == \
            rb.mitigation_factor(num, den)


# ----------------------------------------------- artifacts and compare
def _map_backend(doc):
    doc = json.loads(json.dumps(doc))
    for ref, port in [(r, p) for p, r in PAIRS]:
        doc["scenario"]["backend"] = doc["scenario"]["backend"].replace(
            ref, port)
        doc["scenario"]["name"] = doc["scenario"]["name"].replace(ref, port)
    return doc


@pytest.mark.parametrize("port,ref", PAIRS)
def test_bench_artifact_equals_reference(no_card_no_backend, tmp_path, port,
                                         ref):
    kw = dict(pattern="nearest", width=6, height=8, ngraphs=2, imbalance=0.5,
              graph_kw=(("radix", 3),),
              sweep=None)
    res = {}
    for mod, backend in ((pb, port), (rb, ref)):
        spec = mod.ScenarioSpec(
            name=f"artifact.{backend}", backend=f"{backend}[workers=2]"
            if "host" in backend else backend,
            **{**kw, "sweep": mod.SweepControls(iterations_hi=256,
                                                n_points=5)})
        res[mod] = mod.run_scenario(spec, timer=mod.SyntheticTimer(
            workers=3))
    ours, want = pb.bench_artifact(res[pb]), rb.bench_artifact(res[rb])
    assert ours == _map_backend(want)
    path = pb.write_bench_json(res[pb], str(tmp_path))
    assert pb.read_bench_json(path) == json.loads(json.dumps(ours))
    assert rb.read_bench_json(path) == pb.read_bench_json(path)


BASELINES = Path(__file__).resolve().parents[1] / "benchmarks" / "baselines"


def test_port_reads_every_committed_baseline_as_reference_does():
    """All three artifact kinds (metg_sweep, serve_load, metg_scaling)."""
    names = pb.bench_json_names(str(BASELINES))
    assert names == rb.bench_json_names(str(BASELINES))
    assert len(names) >= 10
    kinds = set()
    for f in names:
        doc = pb.read_bench_json(str(BASELINES / f))
        assert doc == rb.read_bench_json(str(BASELINES / f))
        assert pb.scenario_family(f) == rb.scenario_family(f)
        kinds.add(doc["kind"])
    assert kinds == {"metg_sweep", "serve_load", "metg_scaling"}


def _perturbed(doc, scale):
    """A copy of ``doc`` with every time scaled (and, for rates, divided)."""
    doc = json.loads(json.dumps(doc))
    for p in doc.get("points", []):
        p["wall_time_s"] *= scale
    if doc.get("metg_s") is not None:
        doc["metg_s"] *= scale
    for c in doc.get("cells", []):
        c["elapsed_s"] *= scale
        c["weak_efficiency"] /= scale
        for p in c["points"]:
            p["wall_time_s"] *= scale
    m = doc.get("metrics")
    if m:
        for k in ("ttft_s", "tpot_s", "latency_s"):
            for q in m[k]:
                m[k][q] *= scale
        for k in ("throughput_tok_s", "goodput_rps"):
            m[k] /= scale
    return doc


def _verdict(res):
    return (res.scenario, res.ok, res.regressions, res.metg_rel_delta,
            res.note, res.summary(),
            [(p.iterations, p.rel_delta, p.regressed) for p in res.points])


@pytest.mark.parametrize("scale", [1.0, 0.5, 1.2, 1.3, 3.0])
def test_compare_artifacts_gives_reference_verdicts(scale):
    for f in pb.bench_json_names(str(BASELINES)):
        base = rb.read_bench_json(str(BASELINES / f))
        cur = _perturbed(base, scale)
        assert _verdict(pb.compare_artifacts(base, cur)) == \
            _verdict(rb.compare_artifacts(base, cur)), f


def test_compare_identity_mismatches_give_reference_verdicts():
    base = rb.read_bench_json(
        str(BASELINES / "BENCH_metg_imbalance.host-dynamic.steal.imb2.0.json"))
    edits = [("timer", "wallclock"), ("kind", "serve_load")]
    cases = [dict(base, **{k: v}) for k, v in edits]
    reordered = json.loads(json.dumps(base))
    reordered["scenario"]["backend"] = "host-dynamic[workers=4,schedule=steal]"
    lost = json.loads(json.dumps(base))
    lost["metg_s"] = None
    lost["points"] = lost["points"][:1]
    zero = json.loads(json.dumps(base))
    zero["points"][0]["wall_time_s"] = 0.0
    for cur in cases + [reordered, lost]:
        assert _verdict(pb.compare_artifacts(base, cur)) == \
            _verdict(rb.compare_artifacts(base, cur))
    assert _verdict(pb.compare_artifacts(zero, base)) == \
        _verdict(rb.compare_artifacts(zero, base))
    with pytest.raises(ValueError, match="rel_threshold"):
        pb.compare_artifacts(base, base, rel_threshold=0)


def test_compare_dirs_gives_reference_report(tmp_path):
    import shutil

    names = pb.bench_json_names(str(BASELINES))
    cur = tmp_path / "cur"
    cur.mkdir()
    for k, f in enumerate(names[:-1]):  # the last one vanishes
        doc = rb.read_bench_json(str(BASELINES / f))
        (cur / f).write_text(json.dumps(_perturbed(doc, 1.5 if k % 7 == 0
                                                   else 1.0)))
    shutil.copy(BASELINES / names[0], cur / "BENCH_metg.new.json")
    for families in (None, {"metg", "metg_imbalance"}):
        ours = pb.compare_dirs(str(BASELINES), str(cur), families=families)
        want = rb.compare_dirs(str(BASELINES), str(cur), families=families)
        assert [_verdict(r) for r in ours] == [_verdict(r) for r in want]
        assert pb.format_report(ours) == rb.format_report(want)
