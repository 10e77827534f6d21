"""The port's runner, bench families and suite layer equal the reference's.

Each of the twelve families, run on the synthetic clock with ``--smoke``,
writes the artifacts the reference's family writes, with the backend
names mapped (the reference's scaling family runs its ``run_rank_cell`` in
this process instead of a JAX child process); ``bench_model_step``, which
times real train steps whatever the timer, runs on the CPU and gives the
reference's rows, names and extras; the suite parses and
validates TOML as the reference's does, runs its cells as ``python -m
repro_torch.bench.run`` subprocesses and byte-compares rollouts.
"""
import copy
import importlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

import repro.bench as rb  # noqa: E402
import repro.bench.scaling as rs  # noqa: E402
import repro.bench.suite as rsu  # noqa: E402
import repro_torch.bench.suite as psu  # noqa: E402
from benchmarks.common import BenchContext as RefContext  # noqa: E402
from repro_torch.bench import run as prun  # noqa: E402
from repro_torch.bench.names import port_label, port_spec  # noqa: E402

FAMILIES = list(prun.MODULES)
PAPER = os.path.join(os.path.dirname(psu.__file__), "suites", "paper.toml")


def mapped(doc):
    doc = copy.deepcopy(doc)
    doc["scenario"]["name"] = port_label(doc["scenario"]["name"])
    if "backend" in doc["scenario"]:  # serve_load names none
        doc["scenario"]["backend"] = port_spec(doc["scenario"]["backend"])
    return doc


def test_families_are_the_reference_families_less_the_lm_ones():
    from benchmarks.run import MODULES

    assert FAMILIES == MODULES  # bench_model_step too, in the same order


@pytest.mark.parametrize("family", FAMILIES)
def test_family_writes_the_reference_artifacts(family, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(rs, "_launch_cell", lambda spec, n, smoke, payload,
                        python: rs.run_rank_cell(spec, n, smoke, payload))
    ctx = RefContext(smoke=True, artifacts_dir=str(tmp_path / "ref"),
                     timer=rb.SyntheticTimer())
    want_rows = importlib.import_module(f"benchmarks.{family}").run(ctx)
    # bench_model_step runs on the wall clock whatever the timer: the CPU
    device = "cpu" if family == "bench_model_step" else None
    prun.main(["--only", family, "--smoke", "--timer", "synthetic",
               "--artifacts", str(tmp_path / "port")]
              + (["--device", device] if device else []))
    port = tmp_path / "port"  # bench_moe_dispatch writes no artifact
    got = sorted(os.listdir(port)) if port.exists() else []
    assert got == sorted(port_label(os.path.basename(p)[:-5]) + ".json"
                         for p in ctx.written)
    for path in ctx.written:
        name = port_label(os.path.basename(path)[:-5]) + ".json"
        mine = json.loads((tmp_path / "port" / name).read_text())
        with open(path) as f:
            assert mine == mapped(json.load(f)), name
    mod = importlib.import_module(f"repro_torch.bench.families.{family}")
    from repro_torch.bench import SyntheticTimer
    from repro_torch.bench.families.common import BenchContext

    rows = mod.run(BenchContext(smoke=True, timer=SyntheticTimer(),
                                device=device))
    if family == "bench_model_step":
        # timings on both sides: the same rows in the same order, each
        # with the reference's extras, and every time measured
        def keys(derived):
            return [kv.split("=")[0] for kv in derived.split(";")]

        assert [r.name for r in rows] == [port_label(r.name)
                                          for r in want_rows]
        assert [keys(r.derived) for r in rows] == [keys(r.derived)
                                                   for r in want_rows]
        assert all(r.us_per_call > 0 for r in rows)
        return
    # the same rows; a family over the registry takes it in name order,
    # and the port's names sort otherwise
    want = sorted((port_label(r.name), r.us_per_call, r.derived)
                  for r in want_rows)
    if family == "bench_moe_dispatch":
        # its microseconds are bytes over the link rate, the card's in the
        # port and the TPU's in the reference: equal once rescaled, to the
        # rounding of the one division
        from repro.launch.roofline import LINK_BW
        from repro_torch.bench.moe import LINK_BW as PORT_LINK_BW
        want = [(n, pytest.approx(us * LINK_BW / PORT_LINK_BW, rel=1e-12),
                 d) for n, us, d in want]
    assert sorted((r.name, r.us_per_call, r.derived) for r in rows) == want


def test_runner_rejects_an_unknown_family_and_an_empty_filter(capsys):
    for argv in (["--only", "bench_metg_patern"], ["--only", ","],
                 ["--backends", ","], ["--tune", "--only", "bench_peak"],
                 ["--tune-baseline", "x"]):
        with pytest.raises(SystemExit) as exc:
            prun.main(argv + ["--timer", "synthetic"])
        assert exc.value.code == 2, argv
    assert "unknown bench family(s) bench_metg_patern" in \
        capsys.readouterr().err


def test_runner_filter_matching_nothing_fails_the_family(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        prun.main(["--only", "bench_metg_patterns", "--smoke", "--timer",
                   "synthetic", "--backends", "xla-scan",
                   "--artifacts", str(tmp_path)])
    assert exc.value.code == 1
    assert "matches none of the registered backends" in \
        capsys.readouterr().out


def test_runner_baseline_gate(tmp_path, capsys):
    argv = ["--only", "bench_metg_deps", "--smoke", "--timer", "synthetic"]
    prun.main(argv + ["--artifacts", str(tmp_path / "a")])
    prun.main(argv + ["--artifacts", str(tmp_path / "b"), "--baseline",
                      str(tmp_path / "a")])
    path = tmp_path / "a" / "BENCH_metg_deps.torch-csp.radix0.json"
    doc = json.loads(path.read_text())
    for p in doc["points"]:
        p["wall_time_s"] /= 4
    path.write_text(json.dumps(doc))
    with pytest.raises(SystemExit) as exc:
        prun.main(argv + ["--artifacts", str(tmp_path / "c"), "--baseline",
                          str(tmp_path / "a")])
    assert exc.value.code == 1
    assert "compared 18 scenario(s): 1 regression(s)" in \
        capsys.readouterr().out


def test_wall_clock_runner_on_the_cpu(tmp_path):
    """The wall clock's path of ``chip_smoke.py`` phase 11 on the CPU:
    ``torch-auto`` and the backends it resolves to each build and run,
    and the artifacts validate."""
    from repro_torch.bench import read_bench_json

    prun.main(["--only", "bench_metg_patterns", "--smoke", "--backends",
               "torch-auto,cuda-graph", "--device", "cpu",
               "--artifacts", str(tmp_path)])
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"BENCH_metg.{b}.{case}.json"
                           for b in ("cuda-graph", "torch-auto")
                           for case in ("stencil", "nearest", "spread",
                                        "nearest_x4"))
    for n in names:
        doc = read_bench_json(str(tmp_path / n))
        assert doc["timer"] == "wallclock"
        assert doc["scenario"]["backend"].endswith("[device=cpu]")
        assert all(p["wall_time_s"] > 0 for p in doc["points"])


# ------------------------------------------------------------ the suite
BAD_SUITES = [
    'name = ',
    'name="s"\nparallell=2\n[[tasks]]\nfamily="bench_peak"',
    'name="s"',
    'name="s"\n[[tasks]]\nfamily="bench_peak"\n[[tasks]]\n'
    'family="bench_metg_deps"\nrolouts=2',
    'name="s"\n[[tasks]]\nfamily="bench_peak"\nrollouts=0',
    'name="s"\n[[tasks]]\nfamily="bench_peak"\ntimer="cpu-cycles"',
    'name="s"\n[[tasks]]\nfamily="bench_peak"\nbackends="torch-scan"',
    'name="s"\n[[tasks]]\nfamily="bench_peak"\nbackends=[]',
    '[[tasks]]\nfamily="bench_peak"',
    'name="s"\nparallel=0\n[[tasks]]\nfamily="bench_peak"',
]


@pytest.mark.parametrize("text", BAD_SUITES)
def test_parse_suite_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError) as want:
        rsu.parse_suite(text, source="x.toml")
    with pytest.raises(ValueError) as got:
        psu.parse_suite(text, source="x.toml")
    assert str(got.value) == str(want.value)


def test_validate_suite_names_the_entry():
    S, C = psu.Suite, psu.SuiteCell
    with pytest.raises(ValueError, match="entry #2.*bench_typo"):
        psu.validate_suite(S(name="s", cells=(C("bench_peak"),
                                              C("bench_typo"))), FAMILIES)
    with pytest.raises(ValueError, match="duplicate family"):
        psu.validate_suite(S(name="s", cells=(C("bench_peak"),
                                              C("bench_peak"))), FAMILIES)
    with pytest.raises(ValueError, match="unknown backend 'xla-scan'"):
        psu.validate_suite(S(name="s", cells=(
            C("bench_peak", backends=("xla-scan",)),)), FAMILIES,
            known_backends=["torch-scan"])
    psu.validate_suite(S(name="s", cells=(
        C("bench_peak", backends=("torch-scan", "torch-auto[device=cpu]")),
    )), FAMILIES, known_backends=["torch-scan", "torch-auto"])


def test_paper_campaign_is_valid():
    from repro_torch.backends import backend_names

    suite = psu.load_suite(PAPER)
    psu.validate_suite(suite, FAMILIES, backend_names())
    assert [c.family for c in suite.cells] == FAMILIES
    assert {c.family: c.rollouts for c in suite.cells if c.rollouts > 1} \
        == {"bench_metg_patterns": 2}
    assert (suite.name, suite.parallel, suite.timer) == ("paper", 4,
                                                         "synthetic")


def test_cell_command_is_the_serial_cli():
    suite = psu.parse_suite('name="s"\ntimer="synthetic"\n'
                            '[[tasks]]\nfamily="bench_metg_scaling"\n'
                            'backends=["torch-csp", "torch-auto"]')
    assert psu.cell_command(suite, suite.cells[0], "/out", smoke=True,
                            python="PY") == [
        "PY", "-m", "repro_torch.bench.run", "--only", "bench_metg_scaling",
        "--artifacts", "/out", "--timer", "synthetic", "--smoke",
        "--backends", "torch-csp,torch-auto"]
    assert psu.cell_command(suite, suite.cells[0], "/out", smoke=False,
                            python="PY", device="cpu")[-2:] == [
        "--device", "cpu"]


def test_compare_rollout_flags_byte_drift(tmp_path):
    primary, roll = tmp_path / "out", tmp_path / "out" / "r1"
    roll.mkdir(parents=True)
    (primary / "BENCH_x.a.json").write_text('{"v": 1}')
    (roll / "BENCH_x.a.json").write_text('{"v": 1}')
    run = psu.CellRun(cell=psu.SuiteCell(family="bench_peak"),
                      out_dir=str(roll), rollout=1, returncode=0, stdout="",
                      stderr="")
    assert psu._compare_rollout(str(primary), run) == []
    (roll / "BENCH_x.a.json").write_text('{"v": 2}')
    bad = psu._compare_rollout(str(primary), run)
    assert len(bad) == 1 and "differs byte-wise" in bad[0][1]


def test_suite_cli_exits_2_before_any_cell_on_a_misspelt_family(tmp_path,
                                                                capsys):
    bad = tmp_path / "bad.toml"
    bad.write_text('name="x"\n[[tasks]]\nfamily="bench_peak"\n'
                   '[[tasks]]\nfamily="bench_metg_patern"\n')
    with pytest.raises(SystemExit) as exc:
        psu.main([str(bad), "--smoke", "--artifacts", str(tmp_path / "out")])
    assert exc.value.code == 2
    assert "bench_metg_patern" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()  # nothing ran
    with pytest.raises(SystemExit) as exc:
        psu.main([str(tmp_path / "missing.toml")])
    assert exc.value.code == 2


def test_two_family_suite_with_rollouts_passes_its_byte_compare(tmp_path,
                                                               capsys):
    toml = tmp_path / "two.toml"
    toml.write_text('name="two"\nparallel=3\ntimer="synthetic"\n'
                    '[[tasks]]\nfamily="bench_metg_payload"\n'
                    '[[tasks]]\nfamily="bench_metg_patterns"\nrollouts=2\n')
    out = tmp_path / "out"
    psu.main([str(toml), "--smoke", "--artifacts", str(out)])
    text = capsys.readouterr().out
    assert "suite,0,suite 'two': 3 cell run(s), all ok" in text
    assert "metg.torch-auto.nearest_x4" in text
    roll = out / "rollouts" / "bench_metg_patterns.r1"
    assert len(os.listdir(roll)) == 28
    assert len([n for n in os.listdir(out) if n.endswith(".json")]) == 46
    # and a rollout that differs fails the suite
    suite = psu.load_suite(str(toml))
    first = roll / "BENCH_metg.torch-auto.stencil.json"
    first.write_text(first.read_text().replace("torch-auto", "torch-auto "))
    run = psu.CellRun(cell=suite.cells[1], out_dir=str(roll), rollout=1,
                      returncode=0, stdout="", stderr="")
    assert len(psu._compare_rollout(str(out), run)) == 1


def test_metg_study_example_matches_the_reference_on_the_synthetic_clock(
        capsys):
    """``examples/torch_metg_study.py --fast`` on the synthetic clock (the
    port's counterpart of ``examples/metg_study.py``): every backend and
    pattern of its table, each METG and peak rate the reference's
    ``metg_for`` gives on the same clock for the backend of that name."""
    import importlib.util
    from pathlib import Path

    from benchmarks.common import metg_for
    from repro.backends import backend_names
    from repro_torch.bench.names import PORT_NAMES

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_metg_study.py"
    spec = importlib.util.spec_from_file_location("torch_metg_study", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    table, curve = mod.main(["--fast", "--timer", "synthetic"])
    assert "METG(50%) =" in capsys.readouterr().out
    ctx = RefContext(timer=rb.SyntheticTimer())
    want = {}
    for be in backend_names():
        for pat, kw, ng in mod.CASES:
            name = pat + ("_x4" if ng > 1 else "")
            want[PORT_NAMES[be], name] = metg_for(
                ctx, be, pat, name=f"metg_study.{be}.{name}", num_graphs=ng,
                iterations_hi=512, n_points=5, **kw)
    assert sorted(table) == sorted(want)
    for key, res in table.items():
        assert (res.metg, res.peak_rate) == (want[key].metg,
                                             want[key].peak_rate), key
    assert len(curve.points) == 8
