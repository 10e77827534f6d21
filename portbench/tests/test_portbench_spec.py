"""``BENCHMARK.json`` against the benchmark's contract, and every entry
against the files it names.  Each check is a function of a spec and its
tree, so the same checks hold the benchmark with the configuration of
another kind added (``another_kind/``)."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import (REPO, add_another_kind, cells,
                                      copy_tree, kind, root_of)

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def keys_names_and_units(spec):
    assert set(spec) == KEYS["top"]
    assert 1 <= spec["run_seconds"] <= 51
    for section in ("config", "workload"):
        for e in spec[section + "s"]:
            assert set(e) == KEYS[section], e
            assert NAME.match(e["name"]), e["name"]
            assert 1 <= len(e["why"]) <= 200
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            assert set(m) - {"workloads"} == KEYS[section], m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(spec)) <= 64 * 1024


def test_keys_names_and_units():
    keys_names_and_units(SPEC)


def bounds_and_metric_sources(spec):
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in spec["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_bounds_and_metric_sources():
    bounds_and_metric_sources(SPEC)


def paths_and_command_stay_inside(spec, root):
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (root / p).is_dir()
    assert len(spec["command"]) <= 32
    for word in spec["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"])
    for c in spec["configs"]:
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])


def test_paths_and_command_stay_inside():
    paths_and_command_stay_inside(SPEC, REPO)


@pytest.mark.parametrize("workload", cells())
def test_every_workload_resolves_to_its_files(workload, another_tree):
    cell = harness.resolve(workload, root_of(workload, another_tree))
    root = cell.root / "portbench"
    assert cell.chips in (1, 4)
    assert (root / "loops" / f"{cell.traffic['loop']}.py").is_file()
    assert (root / "reference" / f"{cell.config['reference']}.py").is_file()
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(harness.reader(cell, m), "read"), m["name"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported


def every_config_is_used_and_listed_metrics_name_cells(spec):
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_every_config_is_used_and_listed_metrics_name_cells():
    every_config_is_used_and_listed_metrics_name_cells(SPEC)


def config_files_name_their_source(spec, root):
    """The file names the entry's source and name.  Each key the entry
    lists in ``reduced`` (a cut from the source, as the chip's share of a
    stated deployment) the file states: the value held here, the
    published value under ``published``, and under ``deployment`` how
    many chips share a layer, and how.  The file's own ``reduced`` is the
    entry's."""
    for c in spec["configs"]:
        cfg = json.loads(Path(root / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["name"] == c["name"]
        assert cfg.get("reduced", []) == c["reduced"], c["name"]
        for key in c["reduced"]:
            assert key in cfg, (c["name"], key)
            assert key in cfg.get("published", {}), (c["name"], key)
            assert cfg["published"][key] != cfg[key], (c["name"], key)
        if c["reduced"]:
            d = cfg.get("deployment")
            assert isinstance(d, str) and d.strip(), c["name"]


def test_config_files_name_their_source():
    config_files_name_their_source(SPEC, REPO)


def test_the_spec_checks_hold_with_another_kind_added(another_tree):
    spec = json.loads((another_tree / "BENCHMARK.json").read_text())
    assert len(spec["configs"]) == len(SPEC["configs"]) + 1
    keys_names_and_units(spec)
    bounds_and_metric_sources(spec)
    paths_and_command_stay_inside(spec, another_tree)
    every_config_is_used_and_listed_metrics_name_cells(spec)
    config_files_name_their_source(spec, another_tree)


@pytest.mark.parametrize("drop", ["published", "deployment"])
def test_a_cut_without_its_published_value_or_deployment_fails(tmp_path,
                                                               drop):
    root = add_another_kind(copy_tree(tmp_path))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config_files_name_their_source(spec, root)
    path = root / "portbench" / "configs" / "t5-ffn-swiglu.json"
    cfg = json.loads(path.read_text())
    del cfg[drop]
    path.write_text(json.dumps(cfg))
    with pytest.raises(AssertionError):
        config_files_name_their_source(spec, root)


@pytest.mark.parametrize("workload", cells())
def test_every_cell_has_a_kind_with_a_control_and_two_faults(workload,
                                                             another_tree):
    k = kind(root_of(workload, another_tree), workload)
    assert len(k.FAULTS) >= 2 and callable(k.control)


@pytest.mark.parametrize("breakage", ["no_module", "no_control",
                                      "one_fault"])
def test_a_kind_lacking_its_module_control_or_faults_fails(tmp_path,
                                                          breakage):
    root = add_another_kind(copy_tree(tmp_path))
    path = root / "portbench" / "tests" / "kinds" / "ffn_swiglu.py"
    kind(root, "t5-ffn-swiglu.rows64")
    if breakage == "no_module":
        path.unlink()
    elif breakage == "no_control":
        path.write_text(path.read_text() + "\ndel control\n")
    else:
        path.write_text(path.read_text()
                        + "\nFAULTS = dict(list(FAULTS.items())[:1])\n")
    with pytest.raises(AssertionError):
        kind(root, "t5-ffn-swiglu.rows64")
