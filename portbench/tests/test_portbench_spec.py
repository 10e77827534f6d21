"""``BENCHMARK.json`` against the benchmark's contract, and every entry
against the files it names."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.conftest import REPO, workloads

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


def test_keys_names_and_units():
    assert set(SPEC) == KEYS["top"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for kind in ("config", "workload"):
        for e in SPEC[kind + "s"]:
            assert set(e) == KEYS[kind], e
            assert NAME.match(e["name"]), e["name"]
            assert 1 <= len(e["why"]) <= 200
    for kind in ("end_to_end", "per_layer"):
        for m in SPEC[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_bounds_and_metric_sources():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_paths_and_command_stay_inside():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (REPO / p).is_dir()
    assert len(SPEC["command"]) <= 32
    for word in SPEC["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])


@pytest.mark.parametrize("workload", workloads())
def test_every_workload_resolves_to_its_files(workload):
    cell = harness.resolve(workload)
    root = REPO / "portbench"
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


def test_every_config_is_used_and_listed_metrics_name_cells():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_config_files_name_their_source():
    for c in SPEC["configs"]:
        cfg = json.loads(Path(REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["name"] == c["name"]
        assert c["reduced"] == []
