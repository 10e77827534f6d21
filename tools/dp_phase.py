"""Run the data-parallel and pipeline phase of ``chip_smoke.py`` alone: 15.

    python3 tools/dp_phase.py

Builds the kernels, then trains ``qwen1.5-0.5b`` whole on one device and
over 4 rank processes sharing the card (``psum`` and ``compressed_psum``),
runs the data-parallel ``Trainer``'s failure and bit-exact resume on 2
ranks, ``yi-6b`` pipelined against its forward and the pipelined gradient,
and ``bench_model_step`` at ``--smoke``.  Needs a CUDA card and exits
non-zero without one.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_phase: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.smi("name,power.limit")
    print(card, torch.__version__, torch.version.cuda, sys.version.split()[0])
    cs._build.library()
    got = cs.dp_phase(torch.device("cuda"), card)
    print(f"launches: {got}")
    print(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
