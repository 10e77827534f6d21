"""The port's weak-scaling layer equals the reference's.

On the synthetic clock the port's ``metg_scaling`` artifact for each
``SCALING_BACKENDS`` entry equals the reference's ``scaling_artifact``
built from its ``run_rank_cell`` in this process (no JAX child process),
with the backend names mapped; on the wall clock the port runs every rank
count in this process, the rank count a backend option
(``torch-csp[ranks=N,device=cpu]`` here).
"""
import copy
import json

import pytest

torch = pytest.importorskip("torch")

import repro.bench as rb  # noqa: E402
import repro.bench.scaling as rs  # noqa: E402
import repro_torch.bench.scaling as ps  # noqa: E402
from repro_torch.bench import SyntheticTimer, SweepControls  # noqa: E402
from repro_torch.bench.artifact import validate_artifact  # noqa: E402
from repro_torch.bench.compare import compare_artifacts  # noqa: E402
from repro_torch.bench.names import port_label, port_spec  # noqa: E402
from repro_torch.bench import run as prun  # noqa: E402


def mapped(doc):
    """A reference artifact with its names mapped to the port's."""
    doc = copy.deepcopy(doc)
    doc["scenario"]["name"] = port_label(doc["scenario"]["name"])
    doc["scenario"]["backend"] = port_spec(doc["scenario"]["backend"])
    return doc


def reference_artifact(backend, smoke, ranks=rs.RANKS):
    spec = rs.ScalingSpec(name=f"metg_scaling.{backend}", backend=backend,
                          ranks=ranks)
    payload = rs._timer_payload(rs.scaling_timer(rb.SyntheticTimer()))
    cells = [rs.run_rank_cell(spec, n, smoke, payload) for n in spec.ranks]
    return rs.scaling_artifact(spec, cells, smoke)


def test_constants_are_the_reference_constants_mapped():
    assert ps.RANKS == rs.RANKS == (1, 2, 4, 8)
    assert ps.SCALING_BACKENDS == tuple(port_spec(b)
                                        for b in rs.SCALING_BACKENDS)
    for name in ("WIDTH_PER_RANK", "SCALING_SCHEDULE", "SCALING_OUTPUT_BYTES",
                 "SCALING_SECONDS_PER_BYTE",
                 "SCALING_SECONDS_PER_RENDEZVOUS"):
        assert getattr(ps, name) == getattr(rs, name), name
    from benchmarks import bench_metg_scaling as rfam
    from repro_torch.bench.families import bench_metg_scaling as pfam

    assert pfam._LABELS == {port_spec(k): port_label(v)
                            for k, v in rfam._LABELS.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("backend", rs.SCALING_BACKENDS)
def test_synthetic_artifact_equals_the_reference(backend, smoke):
    spec = ps.ScalingSpec(name=f"metg_scaling.{port_spec(backend)}",
                          backend=port_spec(backend))
    got = ps.run_scaling(spec, timer=SyntheticTimer(), smoke=smoke).doc
    assert got == mapped(reference_artifact(backend, smoke))
    assert [c["ranks"] for c in got["cells"]] == [1, 2, 4, 8]
    assert [c["devices"] for c in got["cells"]] == [1, 2, 4, 8]
    assert got["cells"][0]["weak_efficiency"] == 1.0


def test_spec_validation_matches_the_reference():
    for bad, match in (((1, 4, 2), "ascending"), ((2, 4), "include 1"),
                       ((), "non-empty")):
        for mod in (ps, rs):
            with pytest.raises(ValueError, match=match):
                mod.ScalingSpec(name="s", ranks=bad)
    with pytest.raises(ValueError, match="needs a name"):
        ps.ScalingSpec(name="")
    spec = ps.ScalingSpec(name="s", ranks=(1, 2))
    sc = spec.scenario_for(2, smoke=True)
    assert (sc.width, sc.name, sc.backend) == (8, "s.r2", "torch-csp")
    assert spec.scenario_for(2, backend="torch-csp[ranks=2]").backend == \
        "torch-csp[ranks=2]"
    with pytest.raises(ValueError, match="not in"):
        spec.scenario_for(8)


def test_rank_backend_pins_the_rank_option():
    assert ps.rank_backend("torch-csp", 4) == "torch-csp[ranks=4]"
    assert ps.rank_backend("torch-pipeline[comm=onesided,device=cpu]", 2) \
        == "torch-pipeline[comm=onesided,device=cpu,ranks=2]"
    assert ps.rank_backend("cuda-fused[comm=onesided]", 8) == \
        "cuda-fused[comm=onesided,ranks=8]"
    assert ps.rank_backend("torch-csp[ranks=2]", 2) == "torch-csp[ranks=2]"
    with pytest.raises(ValueError, match="fixes its ranks"):
        ps.rank_backend("torch-csp[ranks=2]", 4)
    for spec in ("torch-auto", "torch-scan"):
        with pytest.raises(ValueError, match="needs a backend with a ranks"):
            ps.rank_backend(spec, 2)


def test_other_timers_are_refused():
    class Dry:
        name = "dryrun"

        def measure(self, backend_name, graphs):
            return 1.0

    with pytest.raises(ValueError, match="cannot run under timer 'dryrun'"):
        ps.run_scaling(ps.ScalingSpec(name="s", ranks=(1,)), timer=Dry())


def test_wall_clock_runs_each_rank_count_in_process(tmp_path):
    """Each cell runs ``torch-csp[ranks=n]``: n rank processes, recorded as
    the cell's devices."""
    spec = ps.ScalingSpec(
        name="metg_scaling.wall", backend="torch-csp[device=cpu]",
        ranks=(1, 2), height=4,
        sweep=SweepControls(schedule=(16, 1), repeats=1, warmup=0))
    res = ps.run_scaling(spec)
    doc = validate_artifact(res.doc)
    assert doc["timer"] == "wallclock"
    assert doc["scenario"]["backend"] == "torch-csp[device=cpu]"
    assert [(c["ranks"], c["devices"], c["width"]) for c in res.cells] == \
        [(1, 1, 4), (2, 2, 8)]
    assert all(p["wall_time_s"] > 0 for c in res.cells for p in c["points"])
    assert res.cell(1)["weak_efficiency"] == 1.0
    path = ps.write_scaling_json(res, str(tmp_path))
    assert path.endswith("BENCH_metg_scaling.wall.json")
    with pytest.raises(KeyError):
        res.cell(4)


def test_scaling_compare_gate_gives_the_reference_verdicts():
    mine = mapped(reference_artifact("shardmap-csp", True))
    ref = reference_artifact("shardmap-csp", True)
    for shrink in (1.0, 0.5):
        for mod_cmp, base in ((compare_artifacts, mine),
                              (rb.compare_artifacts, ref)):
            cur = copy.deepcopy(base)
            for c in cur["cells"][1:]:
                c["weak_efficiency"] *= shrink
            res = mod_cmp(base, cur)
            assert res.ok == (shrink == 1.0)


def test_family_runner_writes_the_reference_artifact(tmp_path, capsys):
    prun.main(["--only", "bench_metg_scaling", "--smoke", "--timer",
               "synthetic", "--backends", "torch-csp,torch-auto",
               "--artifacts", str(tmp_path)])
    out = capsys.readouterr().out
    assert "metg_scaling.torch-auto.r8" in out
    for ref in ("shardmap-csp", "auto"):
        got = json.loads((tmp_path / f"BENCH_metg_scaling."
                          f"{port_spec(ref)}.json").read_text())
        assert got == mapped(reference_artifact(ref, True))
    # --ranks narrows the sweep; a wall-clock sweep of the planner, which
    # has no rank option, fails the family
    prun.main(["--only", "bench_metg_scaling", "--smoke", "--timer",
               "synthetic", "--backends", "torch-csp", "--ranks", "1,2,4",
               "--artifacts", str(tmp_path / "r")])
    got = json.loads((tmp_path / "r" / "BENCH_metg_scaling.torch-csp.json")
                     .read_text())
    assert got == mapped(reference_artifact("shardmap-csp", True, (1, 2, 4)))
    with pytest.raises(SystemExit) as exc:
        prun.main(["--only", "bench_metg_scaling", "--smoke", "--backends",
                   "torch-auto", "--device", "cpu", "--artifacts", ""])
    assert exc.value.code == 1
    assert "needs a backend with a ranks option" in capsys.readouterr().out
