"""Run the training phase of ``chip_smoke.py`` alone: 14.

    python3 tools/train_phase.py

Builds the kernels, then K5 at D = 80 against its plain version and timed,
the gradients through K5 and K6, ``hubert-xlarge`` trained whole at full
width, ``qwen2-vl-2b`` whole (a forward on embeddings, text served), the
``Trainer``'s failure and bit-exact resume, and a Mamba-2 train step.
Needs a CUDA card and exits non-zero without one.
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
        print("train_phase: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.smi("name,power.limit")
    print(card, torch.__version__, torch.version.cuda, sys.version.split()[0])
    cs._build.library()
    for line in cs._build.log_path().read_text().splitlines():
        if "flash_attention" in line or "spill" in line:
            print("   " + line.strip())
    sass = cs.sass_counts(cs._build.library_path(), "flash_attention_sm90")
    for name, (hgmma, tma) in sorted(sass.items()):
        print(f"   {name}: {hgmma} HGMMA, {tma} UTMALDG instructions (SASS)")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(cs.smi("clocks.max.sm").split()[0])
    peak_bf16 = sms * cs.BF16_FLOP_PER_SM_CLOCK * mhz * 1e6

    def bound(flops: float, nbytes: float, peak: float):
        t_ops, t_bytes = flops / peak, nbytes / cs.HBM_BYTES_PER_S
        return ((t_ops, "operations") if t_ops >= t_bytes
                else (t_bytes, "bytes"))

    got = cs.train_phase(dev, card, bound, peak_bf16, sms)
    print(f"training: {got}")
    print(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
