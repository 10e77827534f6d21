"""Run phase 10 of ``chip_smoke.py`` alone: ``torch-csp`` and
``torch-pipeline`` with 4 rank processes sharing one card.

    python3 tools/csp_phase.py

Computes the numpy oracle of the stencil, 4 x nearest[radix=5], memory and
sweep graphs at the main shape (W=132, H=1000) in worker processes while
``torch-scan`` runs the three main cases on the card, then calls
``chip_smoke.csp_phase`` with those outputs: every mode at full size
against the oracle and ``torch-scan``, the ranks' K1/K2 counts, the
one-sided mode against K4, each rank's split of a step, the wall a
timestep beside ``torch-scan``'s, METG and the payload study.  Without
phase 6's results the METG is only self-normalised.  About 3 minutes on an
H100 host; needs a CUDA card and exits non-zero without one.
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
        print("csp_phase: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.smi("name,power.limit")
    print(card, torch.__version__, torch.version.cuda, sys.version.split()[0])
    cases = {"stencil": [cs.full_size("stencil")],
             "nearest": cs.replicate(cs.full_size("nearest"), 4),
             "memory": [cs.full_size("memory")]}
    scan = cs.get_backend("torch-scan")
    with ProcessPoolExecutor(4, mp_context=get_context("spawn")) as pool:
        oracles = {k: pool.submit(cs.oracle, k)
                   for k in ("stencil", "nearest", "memory", "sweep")}
        scan_outs = {k: scan.run_many(g) for k, g in cases.items()}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(cs.csp_phase(cases, oracles, scan_outs, {}, sms, card))
    print(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
