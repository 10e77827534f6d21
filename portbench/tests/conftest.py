"""Fixtures of the benchmark's CPU tests.

``small_tree`` copies ``BENCHMARK.json`` and ``portbench/`` into a
temporary directory and cuts every configuration to a size the CPU runs in
a fraction of a second: that copy is what the harness's CPU path runs.
"""
import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
SMALL = {"width": 7, "height": 9}
SMALL_MEMORY = {"scratch_bytes": 8192, "span_bytes": 1024}
SMALL_ITERATIONS = 5


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


@pytest.fixture
def small_tree(tmp_path) -> Path:
    root = copy_tree(tmp_path)
    for cfg in (root / "portbench" / "configs").glob("*.json"):
        extra = SMALL_MEMORY if json.loads(cfg.read_text())["kind"] \
            == "memory" else {}
        edit_json(cfg, **SMALL, **extra)
    for tr in (root / "portbench" / "traffic").glob("*.json"):
        edit_json(tr, iterations=SMALL_ITERATIONS)
    return root


def workloads():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]
