"""The port's ``serve_load`` family against the reference's, on the CPU.

``repro_torch.bench.serve`` is a numpy copy of ``repro.bench.serve`` with
the port's engine behind its wall clock: the traces, the simulator's
metrics and the artifact documents must be equal (``==``) for the six
specs of the ``bench_serve_load`` family, in full and at ``--smoke``; the
runner's synthetic family must write the reference's committed
``benchmarks/baselines/BENCH_serve_load.*.json``; the simulator's counters
must equal the port engine's ``stats`` on the same trace, as
``tests/test_serve.py`` checks for the reference's engine.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.bench.serve as rserve  # noqa: E402
from benchmarks import bench_serve_load as rfamily  # noqa: E402

import repro_torch.bench.serve as tserve  # noqa: E402
from repro_torch.bench import SyntheticTimer, read_bench_json  # noqa: E402
from repro_torch.bench.families import bench_serve_load as tfamily  # noqa
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASELINES = os.path.join(ROOT, "benchmarks", "baselines")
SPECS = [(spec.name, smoke) for spec in rfamily.specs()
         for smoke in (False, True)]
COUNTERS = ("prefills", "decode_steps", "chunk_launches", "host_syncs",
            "tokens_generated")


def pair(name, smoke):
    """The reference's family spec ``name`` and the port's, resolved."""
    ref = next(s for s in rfamily.specs() if s.name == name)
    port = next(s for s in tfamily.specs() if s.name == name)
    return ref.resolved(smoke), port.resolved(smoke)


def test_family_specs_equal_the_reference():
    assert tfamily.RATES == rfamily.RATES
    assert [dataclasses.asdict(s) for s in tfamily.specs()] == \
        [dataclasses.asdict(s) for s in rfamily.specs()]


@pytest.mark.parametrize("name,smoke", SPECS)
def test_trace_simulation_and_artifact_equal_the_reference(name, smoke):
    ref, port = pair(name, smoke)
    assert [dataclasses.asdict(r) for r in tserve.synth_trace(port)] == \
        [dataclasses.asdict(r) for r in rserve.synth_trace(ref)]
    want = rserve.simulate_serve_load(ref)
    got = tserve.simulate_serve_load(port)
    assert got.metrics == want.metrics
    assert (got.timer, got.timer_config) == (want.timer, want.timer_config)
    assert tserve.serve_artifact(got) == rserve.serve_artifact(want)
    cost = tserve.ServeCostParams(sync_s=1e-3, decode_step_s=5e-5)
    assert tserve.simulate_serve_load(port, cost=cost).metrics == \
        rserve.simulate_serve_load(ref, cost=rserve.ServeCostParams(
            sync_s=1e-3, decode_step_s=5e-5)).metrics


def test_runner_writes_the_committed_baselines(tmp_path):
    """``python -m repro_torch.bench.run --timer synthetic --only
    bench_serve_load --smoke`` writes the six artifacts the reference
    committed, equal document for document (they name no backend)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--only",
         "bench_serve_load", "--smoke", "--timer", "synthetic",
         "--artifacts", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"BENCH_{s.slug}.json" for s in rfamily.specs())
    for n in names:
        with open(os.path.join(BASELINES, n)) as f:
            assert read_bench_json(str(tmp_path / n)) == json.load(f), n


def test_simulator_counters_equal_the_port_engine():
    """With every arrival effectively immediate, the simulator's counters
    equal the port engine's ``stats`` on the same trace, in both modes."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    params = init_model(cfg, 0, device="cpu")
    for mode in ("chunked", "host"):
        spec = tserve.ServeLoadSpec(
            name=f"serve_load.{mode}.rate1000000000", mode=mode,
            rate_rps=1e9, num_requests=6, batch_slots=2, chunk_size=8,
            max_len=64, prompt_len=(4, 8), out_tokens=(2, 9), seed=0)
        sim = tserve.simulate_serve_load(spec).metrics
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=spec.max_len,
                          chunk_size=spec.chunk_size, decode_mode=mode)
        rng = np.random.default_rng(0)
        for r in tserve.synth_trace(spec):
            eng.submit(rng.integers(1, cfg.vocab_size, size=r.prompt_len)
                       .astype(np.int32), max_new_tokens=r.out_tokens)
        eng.run()
        assert {k: sim[k] for k in COUNTERS} == eng.stats, mode


def test_wall_clock_cell_on_the_cpu(tmp_path):
    """``run_engine_load`` serves a smoke trace open loop through the
    port's engine (reduced qwen1.5-0.5b on the CPU), every request
    completes, and the artifact validates; its counters are the
    simulator's when no arrival waits."""
    spec = dataclasses.replace(tfamily.specs()[0], num_requests=5)
    res = tserve.run_engine_load(spec, device="cpu")
    m = res.metrics
    assert res.timer == "wallclock" and m["completed"] == 5
    assert m["prefills"] == 5 and m["makespan_s"] > 0
    assert all(v >= 0 for v in m["ttft_s"].values())
    doc = read_bench_json(tserve.write_serve_json(res, str(tmp_path)))
    assert doc["scenario"]["mode"] == "host" and doc["timer"] == "wallclock"
    ref_tokens = rserve.simulate_serve_load(spec).metrics["tokens_generated"]
    assert m["tokens_generated"] == ref_tokens


def test_run_serve_load_dispatches_on_the_timer():
    spec = tfamily.specs()[0]
    assert tserve.run_serve_load(spec, timer=SyntheticTimer()).metrics == \
        rserve.simulate_serve_load(next(
            s for s in rfamily.specs() if s.name == spec.name)).metrics

    class Cycles:
        name = "cycles"

    with pytest.raises(ValueError, match="wallclock and synthetic"):
        tserve.run_serve_load(spec, timer=Cycles())


BAD_SPECS = [
    dict(name=""),
    dict(name="s", mode="turbo"),
    dict(name="s", rate_rps=0),
    dict(name="s", num_requests=0),
    dict(name="s", prompt_len=(0, 4)),
    dict(name="s", out_tokens=(5, 4)),
    dict(name="s", prompt_len=(4, 80), out_tokens=(4, 24)),
]


@pytest.mark.parametrize("kw", BAD_SPECS)
def test_spec_validation_equals_the_reference(kw):
    with pytest.raises(ValueError) as want:
        rserve.ServeLoadSpec(**kw)
    with pytest.raises(ValueError) as got:
        tserve.ServeLoadSpec(**kw)
    assert str(got.value) == str(want.value)
