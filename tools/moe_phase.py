"""Run the MoE phase of ``chip_smoke.py`` alone: 13, after K5's checks at
the MoE prefill shapes.

    python3 tools/moe_phase.py

Builds the kernels, holds K5 against its plain version at ``ATTN_MOE``
(float32 and bf16), then serves ``mixtral-8x7b`` (20 layers) and
``arctic-480b`` (2 layers) at full width, runs the a2a path on 4 rank
processes and the ``bench_moe_dispatch`` family.  About 2-3 minutes on an
H100 host; needs a CUDA card and exits non-zero without one.
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
        print("moe_phase: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.smi("name,power.limit")
    print(card, torch.__version__, torch.version.cuda, sys.version.split()[0])
    cs._build.library()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(cs.smi("clocks.max.sm").split()[0])
    peak_bf16 = sms * cs.BF16_FLOP_PER_SM_CLOCK * mhz * 1e6

    def bound(flops: float, nbytes: float, peak: float):
        t_ops, t_bytes = flops / peak, nbytes / cs.HBM_BYTES_PER_S
        return ((t_ops, "operations") if t_ops >= t_bytes
                else (t_bytes, "bytes"))

    for case in cs.ATTN_MOE:
        *shape, causal, window, q_offset = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = cs.attn_inputs(*shape, dev, dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            cs.attn_agree(f"{tuple(shape)} window={window} "
                          f"{str(dtype)[6:]}", cs.flash_attention(q, k, v, **kw),
                          cs.flash_attention_plain(q, k, v, **kw))
    launches = cs.moe_phase(dev, card, bound, peak_bf16, sms)
    print(f"launches on the MoE serving path: {launches}")
    print(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
