"""Run phase 11 of ``chip_smoke.py`` alone: the planner and the campaign.

    python3 tools/planner_phase.py

Computes the numpy oracle of the stencil, 4 x nearest[radix=5], memory and
4096-byte stencil graphs at the main shape (W=132, H=1000) in worker
processes while ``cuda-fused`` runs phase 6's METG sweep on the card, then
calls ``chip_smoke.planner_phase``: ``--tune`` against the committed
table, ``torch-auto`` at full size against its winners and the oracle,
its METG beside ``cuda-fused``'s, the runner on the wall clock and a
two-family suite.  About 2 minutes on an H100 host; needs a CUDA card and
exits non-zero without one.
"""
from __future__ import annotations

import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("planner_phase: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.smi("name,power.limit")
    print(card, torch.__version__, torch.version.cuda, sys.version.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = (("stencil", "stencil", [cs.full_size("stencil")]),
             ("4 x nearest[radix=5]", "nearest",
              cs.replicate(cs.full_size("nearest"), 4)),
             ("memory 1 MiB", "memory", [cs.full_size("memory")]),
             ("stencil 4096 B", "stencil_4096B",
              [cs.full_size("stencil_4096B")]))
    with ProcessPoolExecutor(4, mp_context=get_context("spawn")) as pool:
        oracles = {key: pool.submit(cs.oracle, key) for _, key, _ in cases}
        fused = cs.run_scenario(cs.ScenarioSpec(
            name="metg.cuda-fused.stencil", backend="cuda-fused",
            pattern="stencil", kernel="compute", width=cs.WIDTH,
            height=cs.HEIGHT, cores=sms,
            sweep=cs.SweepControls(iterations_hi=4096, n_points=7,
                                   repeats=3, warmup=1)))
        print(f"cuda-fused METG {fused.metg_s * 1e6} us")
        print(cs.planner_phase(cases, oracles, {"cuda-fused": fused}, sms,
                               card))
    print(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
