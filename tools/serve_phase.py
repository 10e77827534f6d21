"""Run the serving phases of ``chip_smoke.py`` alone: 7, 8 and 12.

    python3 tools/serve_phase.py

Builds the kernels, serves ``mamba2-2.7b`` (phase 7) and
``recurrentgemma-2b`` (phase 8) at full width through the chunked and host
engines with the decode step captured and the chunked engine eager, then
runs phase 12: ``bench_serve_load`` on the wall clock at ``--smoke``, the
full-width ``qwen1.5-0.5b`` serve_load cells, ``yi-6b`` and
``minitron-8b`` at full width and ``qwen2-72b`` cut to 32 layers.  About
3 minutes on an H100 host; needs a CUDA card and exits non-zero without
one.
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
        print("serve_phase: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.smi("name,power.limit")
    print(card, torch.__version__, torch.version.cuda, sys.version.split()[0])
    cs._build.library()
    dev = torch.device("cuda")
    counters = {"K5": cs.flash_attention, "K6": cs.ssd_chunked}
    launches = {"K6": cs.serve_phase(cs.MAMBA, "7", dev, card, counters),
                "K5": cs.serve_phase(cs.GEMMA, "8", dev, card, counters)}
    cs.dense_phase(dev, card)
    print(f"launches on the serving paths: {launches}")
    print(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
