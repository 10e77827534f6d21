"""The benchmark's command on the card: one short run of a cell.

    python -m pytest -q -m gpu portbench/tests/test_portbench_gpu.py

Skips without a CUDA card.
"""
import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO


@pytest.mark.gpu
@pytest.mark.parametrize("workload,trace", [
    ("stencil-compute.fused-i64", 0), ("stencil-compute.fused-i64", 1),
    ("stencil-memory.graph", 1)])
def test_a_two_second_cell_runs_correct(workload, trace):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 5),
         "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["body_state_mismatches"]["value"] == 0
    assert result["device"]["platform"] == "gpu"
    names = set(result["metrics"])
    if workload == "stencil-memory.graph":
        assert names == {"k2_roofline", "task_mbu",
                         "device_idle_share.memory"}
    elif trace:
        assert names == {"k3_roofline", "task_mfu", "device_idle_share",
                         "run_overhead_us", "host_launch_us",
                         "k3_wait_share", "idle_host_share"}
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
    else:
        assert names == {"tasks_per_s", "run_ms_p95", "setup_s"}
