"""The port's planner equals the reference's: the tuner, ``torch-auto`` and
the ``repro_torch.core`` names.

The port's tuning table, built on the synthetic clock over the port's
registry, is held to the reference's committed ``TUNE_default.json``
entry by entry with the backend names mapped (``bench.names``); the
synthetic clock charges ``torch-auto`` exactly what the reference charges
``auto``; and ``torch-auto[device=cpu]`` is bitwise with the backend it
resolves to and with the numpy oracle.
"""
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.bench as rb  # noqa: E402
import repro.bench.tuner as rt  # noqa: E402
import repro.core as rc  # noqa: E402
import repro_torch.bench as pb  # noqa: E402
import repro_torch.bench.tuner as pt  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.bench import run as prun  # noqa: E402
from repro_torch.bench.names import (PORT_NAMES, port_label,  # noqa: E402
                                     port_spec)

REF_TABLE = rt.default_table_path()
PORT_TABLE = pt.default_table_path()

# phase 11's graphs at a small size: (make_graph kwargs, ngraphs, the
# port's winner)
GRAPHS = {
    "stencil": (dict(pattern="stencil", iterations=16), 1, "cuda-fused"),
    "nearest_x4": (dict(pattern="nearest", iterations=16, radix=5), 4,
                   "cuda-fused"),
    "memory": (dict(pattern="stencil", kernel="memory", iterations=4,
                    span_bytes=1 << 12, scratch_bytes=1 << 14), 1,
               "cuda-fused"),
    "stencil_4096B": (dict(pattern="stencil", iterations=16,
                           output_bytes=4096), 1,
                      "torch-csp[comm=onesided]"),
}


def graphs(mod, case, width=6, height=5):
    kw, n, _ = GRAPHS[case]
    return mod.replicate(mod.make_graph(width=width, height=height, **kw), n)


@pytest.fixture(scope="module")
def port_doc():
    return pt.build_tuning_table(pb.SyntheticTimer())


@pytest.fixture(scope="module")
def ref_doc():
    return rt.read_tuning_json(REF_TABLE)


# ------------------------------------------------------------ names
def test_name_map_pairs_every_registered_backend():
    import repro.backends as rbk
    import repro_torch.backends as tbk

    assert sorted(PORT_NAMES) == rbk.backend_names()
    assert sorted(PORT_NAMES.values()) == tbk.backend_names()
    assert PORT_NAMES["auto"] == "torch-auto"
    assert port_spec("shardmap-csp[comm_overlap=True,comm=onesided]") == \
        "torch-csp[comm=onesided,comm_overlap=True]"
    assert port_label("metg_scaling.shardmap-csp.onesided") == \
        "metg_scaling.torch-csp.onesided"
    assert port_label("metg.auto.stencil") == "metg.torch-auto.stencil"


def test_port_constants_are_the_reference_constants_mapped():
    assert pt.DEFAULT_FALLBACK == port_spec(rt.DEFAULT_FALLBACK)
    assert pt.AUTO == port_spec("auto")
    assert pt._comm_candidates() == tuple(sorted(
        port_spec(s) for s in rt._comm_candidates()))
    for name in ("GRANULARITY_BUCKETS", "GRANULARITY_EDGES",
                 "GRANULARITY_REPRESENTATIVE", "PAYLOAD_BUCKETS",
                 "PAYLOAD_EDGES", "PAYLOAD_REPRESENTATIVE", "TUNE_PATTERNS",
                 "SMOKE_PATTERNS", "_MODE_SPACE", "_TUNE_WIDTH",
                 "_TUNE_HEIGHT", "_SMOKE_HEIGHT"):
        assert getattr(pt, name) == getattr(rt, name), name


def test_core_offers_the_reference_names():
    from repro_torch.bench import metg
    from repro_torch.core import metg as shim

    assert sorted(tc.__all__) == sorted(rc.__all__)
    assert shim.__all__ == __import__("repro.core.metg",
                                      fromlist=["x"]).__all__
    for name in shim.__all__:
        assert getattr(shim, name) is getattr(metg, name)
    assert tc.compute_metg is metg.compute_metg


# ------------------------------------------------------- mode space
def test_mode_space_is_the_reference_mode_space_mapped():
    got = pt.enumerate_mode_space()
    assert len(got) == 14
    assert got == sorted(port_spec(s) for s in rt.enumerate_mode_space())
    assert "torch-auto" not in got
    assert "cuda-fused[comm=onesided]" in got  # ranks default, not vetoed
    assert pt.backend_mode_specs("cuda-fused") == [
        "cuda-fused", "cuda-fused[comm=onesided]"]


def test_mode_space_veto_needs_no_card_and_starts_no_rank(monkeypatch):
    from repro_torch.dist import ranks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_pool(*a, **kw):
        raise AssertionError("the veto started a rank pool")

    monkeypatch.setattr(ranks, "get_pool", no_pool)
    monkeypatch.setattr(ranks.RankPool, "__init__", no_pool)
    specs = pt.enumerate_mode_space()
    assert len(specs) == 14
    assert all("device" not in s for s in specs)


# ------------------------------------------------------- the table
def mapped_entry(e):
    return {
        "key": e["key"], "family": e["family"],
        "winner": port_spec(e["winner"]), "elapsed_s": e["elapsed_s"],
        "margin": e["margin"],
        # ties sort by spec string, and the port's names sort otherwise
        "candidates": sorted(([port_spec(s), t] for s, t in e["candidates"]),
                             key=lambda c: (c[1], c[0])),
    }


def test_tuning_table_equals_the_reference_table_mapped(port_doc, ref_doc):
    fresh = rt.build_tuning_table(rb.SyntheticTimer())
    assert port_doc["timer"] == ref_doc["timer"] == "synthetic"
    assert port_doc["timer_config"] == fresh["timer_config"]
    # the committed reference table predates the timer's rank model
    assert ref_doc["timer_config"] == {
        k: v for k, v in fresh["timer_config"].items() if k != "ranks"}
    assert port_doc["schema"] == ref_doc["schema"]
    assert ref_doc["entries"] == fresh["entries"]
    assert len(port_doc["entries"]) == len(ref_doc["entries"]) == 12
    for mine, ref in zip(port_doc["entries"], ref_doc["entries"]):
        assert mine == mapped_entry(ref)
        want = 14 if mine["family"] == "metg" else 6
        assert len(mine["candidates"]) == want


def test_committed_table_is_a_fresh_build_byte_for_byte(port_doc, tmp_path):
    path = pt.write_tuning_json(port_doc, str(tmp_path))
    assert os.path.basename(path) == "TUNE_torch.json"
    assert filecmp.cmp(path, PORT_TABLE, shallow=False)
    assert pt.read_tuning_json(PORT_TABLE) == port_doc


def test_smoke_table_is_the_reference_smoke_table_mapped():
    mine = pt.build_tuning_table(pb.SyntheticTimer(), smoke=True)
    ref = rt.build_tuning_table(rb.SyntheticTimer(), smoke=True)
    assert mine["entries"] == [mapped_entry(e) for e in ref["entries"]]


def test_tune_cli_regenerates_the_table_and_passes_its_gate(tmp_path,
                                                            capsys):
    out = tmp_path / "full"
    prun.main(["--tune", "--timer", "synthetic", "--artifacts", str(out)])
    assert filecmp.cmp(out / "TUNE_torch.json", PORT_TABLE, shallow=False)
    prun.main(["--tune", "--smoke", "--timer", "synthetic", "--artifacts",
               str(tmp_path / "smoke"), "--tune-baseline",
               os.path.dirname(PORT_TABLE)])
    assert "winners match the committed table" in capsys.readouterr().out
    # a changed winner at a shared key fails the gate
    doc = json.loads((out / "TUNE_torch.json").read_text())
    e = next(e for e in doc["entries"] if e["key"]["pattern"] == "stencil"
             and e["key"]["granularity"] == "fine")
    e["winner"] = e["candidates"][-1][0]
    bad = tmp_path / "bad"
    pt.write_tuning_json(doc, str(bad))
    with pytest.raises(SystemExit) as exc:
        prun.main(["--tune", "--smoke", "--timer", "synthetic",
                   "--artifacts", str(tmp_path / "smoke2"),
                   "--tune-baseline", str(bad)])
    assert exc.value.code == 1
    assert "FATAL winner changed at stencil.fine.small" in \
        capsys.readouterr().out


@pytest.mark.parametrize("mutate,match", [
    (lambda d: d.update(kind="bench"), "kind"),
    (lambda d: d["entries"][0].update(margin=-1.0), "margin"),
    (lambda d: d["entries"][0].update(winner="nobody"), "not among"),
    (lambda d: d["entries"][0]["key"].update(granularity="tiny"),
     "not a bucket"),
    (lambda d: d["entries"].append(dict(d["entries"][0])), "duplicate"),
    (lambda d: d["entries"][0]["candidates"][0].__setitem__(1, True),
     "seconds"),
])
def test_table_schema_rejects_what_the_reference_rejects(port_doc, ref_doc,
                                                         mutate, match):
    for mod, doc in ((pt, port_doc), (rt, ref_doc)):
        bad = json.loads(json.dumps(doc))
        mutate(bad)
        with pytest.raises(ValueError, match=match):
            mod.validate_tuning_table(bad)


def test_resolution_is_the_reference_resolution_mapped(port_doc, ref_doc):
    mine, ref = pt.TuningTable(port_doc), rt.TuningTable(ref_doc)
    n = 0
    for pattern in ("stencil", "nearest", "spread", "fft", "tree"):
        for gran in pt.GRANULARITY_BUCKETS:
            for pay in pt.PAYLOAD_BUCKETS:
                for ndev in (1, 2, 8):
                    for ngraphs in (1, 2, 4):
                        key = dict(pattern=pattern, granularity=gran,
                                   payload=pay, ndev=ndev, ngraphs=ngraphs)
                        got = mine.resolve(pt.TuningKey(**key))
                        want = ref.resolve(rt.TuningKey(**key))
                        assert got == (None if want is None
                                       else port_spec(want)), key
                        n += got is not None
    assert n == 3 * 3 * 3 * 3 * 3  # every key of a tuned pattern resolves


def test_diff_tuning_tables_gives_the_reference_verdicts(port_doc, ref_doc):
    def changed(doc, spec):
        d = json.loads(json.dumps(doc))
        d["entries"][0]["winner"] = spec
        del d["entries"][-1]
        return d

    def mapped(msg):
        for ref, port in PORT_NAMES.items():
            msg = msg.replace(f"'{ref}'", f"'{port}'")
        return msg

    for subset_ok in (False, True):
        got = pt.diff_tuning_tables(port_doc, changed(port_doc, "torch-scan"),
                                    subset_ok=subset_ok)
        want = rt.diff_tuning_tables(ref_doc, changed(ref_doc, "xla-scan"),
                                     subset_ok=subset_ok)
        assert got == tuple([mapped(m) for m in ms] for ms in want)
        assert got[0] and "winner changed" in got[0][0]
    other = dict(port_doc, timer="wallclock")
    fatal, _ = pt.diff_tuning_tables(port_doc, other)
    assert fatal and "timer changed" in fatal[0]


# ------------------------------------------------- the synthetic clock
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_synthetic_clock_charges_the_planner_as_the_reference(case):
    mine = pb.SyntheticTimer().measure("torch-auto", graphs(tc, case))
    ref = rb.SyntheticTimer().measure("auto", graphs(rc, case))
    assert mine == ref
    assert mine == pb.SyntheticTimer().measure(GRAPHS[case][2],
                                               graphs(tc, case))


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_auto_resolve_is_the_reference_resolve_mapped(case):
    got = pt.auto_resolve("torch-auto", graphs(tc, case))
    assert got == GRAPHS[case][2]
    assert got == port_spec(rt.auto_resolve("auto", graphs(rc, case)))
    assert pt.auto_resolve("torch-auto[device=cpu]", graphs(tc, case)) == got
    assert pt.auto_resolve("torch-scan", graphs(tc, case)) == "torch-scan"


def test_auto_resolve_guards_its_options(tmp_path):
    g = [tc.make_graph(width=4, height=3)]
    with pytest.raises(ValueError, match="does not accept option 'ranks'"):
        pt.auto_resolve("torch-auto[ranks=2]", g)
    with pytest.raises(ValueError, match="tuned on timer 'synthetic'"):
        pt.auto_resolve("torch-auto[timer=wallclock]", g)
    assert pt.auto_resolve(
        "torch-auto[fallback=cuda-graph,table=" + PORT_TABLE + "]",
        [tc.make_graph(width=4, height=3, pattern="fft")]) == "cuda-graph"


# ------------------------------------------------------- torch-auto
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_auto_on_the_cpu_is_bitwise_with_its_winner_and_the_oracle(case):
    gs = graphs(tc, case)
    auto = get_backend("torch-auto[device=cpu]")
    spec = auto.resolve_spec(gs)
    assert spec == GRAPHS[case][2]
    assert auto._delegates == {}  # resolving builds nothing
    out = auto.run_many(gs)
    winner = auto.delegate(gs)
    assert list(auto._delegates) == [spec]
    assert winner.device == torch.device("cpu")
    want = get_backend(spec, device="cpu").run_many(gs)
    for g, a, b in zip(gs, out, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, tc.execute_reference(g))


def test_auto_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend("torch-auto")
    assert get_backend("torch-auto[device=cpu]")._ndev == 1


def test_auto_refuses_a_bad_table_or_fallback(tmp_path, port_doc):
    with pytest.raises(ValueError, match="not found"):
        get_backend(f"torch-auto[table={tmp_path / 'TUNE_x.json'},"
                    f"device=cpu]")
    garbage = tmp_path / "TUNE_garbage.json"
    garbage.write_text("{not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        get_backend(f"torch-auto[table={garbage},device=cpu]")
    wall = dict(port_doc, timer="wallclock")
    path = pt.write_tuning_json(wall, str(tmp_path), slug="wall")
    with pytest.raises(ValueError, match="tuned on timer 'wallclock'"):
        get_backend(f"torch-auto[table={path},device=cpu]")
    be = get_backend(f"torch-auto[table={path},timer=wallclock,device=cpu]")
    assert be.table.timer == "wallclock"
    with pytest.raises(ValueError, match="cannot fall back to itself"):
        get_backend("torch-auto[fallback=torch-auto,device=cpu]")
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("torch-auto[fallback=slurm,device=cpu]")
