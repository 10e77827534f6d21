"""Run the dry-run cost model's phase of ``chip_smoke.py`` alone: 16.

    python3 tools/cost_phase.py

Builds the kernels, measures what phase 16 reads from earlier phases (the
METG sweep of phase 6 on ``cuda-fused`` and ``torch-scan``, the
single-device ``qwen1.5-0.5b`` train step of phase 15), then runs phase
16.  Needs a CUDA card and exits non-zero without one.
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
        print("cost_phase: no CUDA device available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = cs.smi("name,power.limit")
    print(card, torch.__version__, torch.version.cuda, sys.version.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(cs.smi("clocks.max.sm").split()[0])
    cs._build.library()
    metg = {}
    for be_name in ("cuda-fused", "torch-scan"):
        metg[be_name] = cs.run_scenario(cs.metg_spec(be_name, cs.HEIGHT, sms))
        print(f"phase 6's sweep on {be_name}: "
              f"{[(p.iterations, p.wall_time) for p in metg[be_name].points]}")
    cfg = cs.get_config("qwen1.5-0.5b")
    B, S = cs.DP_BATCH
    tcfg = cs.TS.TrainConfig(**cs.DP_TCFG)
    dcfg = cs.DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    state = cs.TS.init_state(cfg, tcfg, torch.Generator(dev).manual_seed(0),
                             dev)
    step, walls = cs.TS.make_train_step(cfg, tcfg), []
    for s in range(cs.DP_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, cs.make_batch(dcfg, s))
        float(m["loss"])
        walls.append(time.perf_counter() - t)
    print(f"phase 15's single-device step: walls {walls} s")
    del state, step, m
    cs.release()
    cs.cost_phase(dev, card, sms, max_mhz, metg, min(walls[1:]))
    print(f"total {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
