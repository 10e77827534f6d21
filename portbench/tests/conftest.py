"""Fixtures of the benchmark's CPU tests.

``small_tree`` copies ``BENCHMARK.json`` and ``portbench/`` into a
temporary directory, adds the configuration of another kind kept in
``another_kind/`` (files and entries alone, ``add_another_kind``), and
cuts every configuration to a size the CPU runs in a fraction of a second:
that copy is what the harness's CPU path runs.

A configuration's ``reference`` names its test kind,
``portbench/tests/kinds/<reference>.py`` (``kinds/taskbench.py`` says what
a kind gives): the cut for the CPU, the control, the faults.  The tests
that run on every cell take their cases from it, over ``cells()``: the
benchmark's own cells and the added one.
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
ANOTHER = Path(__file__).resolve().parent / "another_kind"
KIND_NAMES = ("cut_config", "cut_traffic", "control", "reference", "sound")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The CPU tests run under several workers: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def copy_tree(dst: Path) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def edit_json(path: Path, **changes) -> None:
    d = json.loads(path.read_text())
    d.update(changes)
    path.write_text(json.dumps(d, indent=2))


def another_entries() -> dict:
    return json.loads((ANOTHER / "entries.json").read_text())


def add_another_kind(root: Path) -> Path:
    """Add the configuration of another kind to the tree at ``root``: its
    files beside the benchmark's (config, traffic, loop, reference, test
    kind) and its entries at the end of ``BENCHMARK.json``'s lists."""
    shutil.copytree(ANOTHER, root / "portbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("entries.json",
                                                  "__pycache__"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for key, entries in another_entries().items():
        spec[key].extend(entries)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def kind(root: Path, workload: str):
    """The test kind of a cell's configuration, from the tree at ``root``;
    fails where the reference has none, or where the kind gives no
    control or fewer than two faults."""
    name = harness.resolve(workload, root).config["reference"]
    path = root / "portbench" / "tests" / "kinds" / f"{name}.py"
    assert path.is_file(), f"reference {name!r} has no kind module {path}"
    mod = harness.load_module(path, "kind_" + name)
    missing = [n for n in KIND_NAMES if not callable(getattr(mod, n, None))]
    assert not missing, f"kind {name!r} lacks {missing}"
    assert len(getattr(mod, "FAULTS", {})) >= 2, \
        f"kind {name!r} gives fewer than two faults"
    return mod


@pytest.fixture
def small_tree(tmp_path) -> Path:
    root = add_another_kind(copy_tree(tmp_path))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in spec["configs"]}
    for w in spec["workloads"]:
        k = kind(root, w["name"])
        cfg = root / files[w["config"]]
        tr = root / "portbench" / "traffic" / f"{w['traffic']}.json"
        edit_json(cfg, **k.cut_config(json.loads(cfg.read_text())))
        edit_json(tr, **k.cut_traffic(json.loads(tr.read_text())))
    return root


@pytest.fixture(scope="session")
def another_tree(tmp_path_factory) -> Path:
    """The benchmark's tree with the configuration of another kind added,
    at its own size."""
    return add_another_kind(copy_tree(tmp_path_factory.mktemp("another")))


def root_of(workload: str, another_tree: Path) -> Path:
    """The tree that holds a cell at its own size."""
    return REPO if workload in workloads() else another_tree


def workloads():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


def cells():
    """The benchmark's cells and the cell of another kind."""
    return workloads() + [w["name"] for w in another_entries()["workloads"]]


def faults():
    """(cell, fault) for every fault of every cell's kind.  Read from the
    files as they are here, with no tree built: the kind modules the trees
    copy."""
    spec, added = json.loads((REPO / "BENCHMARK.json").read_text()), \
        another_entries()
    configs = {c["name"]: c["file"]
               for c in spec["configs"] + added["configs"]}
    out = []
    for w in spec["workloads"] + added["workloads"]:
        rel = Path(configs[w["config"]])
        cfg = REPO / rel if (REPO / rel).is_file() \
            else ANOTHER / rel.relative_to("portbench")
        ref = json.loads(cfg.read_text())["reference"]
        path = REPO / "portbench" / "tests" / "kinds" / f"{ref}.py"
        if not path.is_file():
            path = ANOTHER / "tests" / "kinds" / f"{ref}.py"
        mod = harness.load_module(path, "kind_" + ref)
        out += [(w["name"], f) for f in sorted(mod.FAULTS)]
    return out
