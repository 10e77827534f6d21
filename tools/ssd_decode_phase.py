"""The Mamba-2 decode step (K7) in the decode cell it serves, profiled on
the card.

    python3 tools/ssd_decode_phase.py [--seed N] [--out FILE]

The benchmark's decode cell (``granite-4.0-h-small.decode-b128``) set up
from ``--seed`` through its own loop (weights, 128 prefills, the captured
step); the captured step's device time by CUDA events over 8 replays;
then one eager decode step profiled: device time by kernel, K7's among
them, and the step's busy time.  The line is printed as JSON and appended
to ``--out`` (default ``build/ssd_decode_phase.jsonl``).  Needs a CUDA
card.  K7 against its plain version, and K7 timed alone, are phases 3
and "kernel times" of ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import trace as tr  # noqa: E402

CELL = "granite-4.0-h-small.decode-b128"


def profile_step(seed: int):
    from torch.profiler import ProfilerActivity, profile

    cell = harness.resolve(CELL, ROOT)
    mod = harness.load_module(ROOT / "portbench" / "loops"
                              / f"{cell.traffic['loop']}.py", "loop_decode")
    loop = mod.Loop(cell.config, cell.traffic, seed, torch.device("cuda"))
    eng = loop.engine
    step = eng._chunk_step

    def once(fn):
        eng._d_t.zero_()  # the step's index into the chunk's buffers
        fn()

    replay_ms = None
    if eng.program is not None:  # before the profile: replays after one
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ms = []
        for _ in range(8):
            eng._d_t.zero_()
            start.record()
            eng.program()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        replay_ms = sorted(ms)
    once(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        once(step)
        torch.cuda.synchronize()
    ev = [e for e in tr.kineto_events(prof) if e.device]
    totals = {}
    for e in ev:
        key = tr.short_name(e.name)
        totals[key] = totals.get(key, 0.0) + (e.end_ns - e.start_ns) / 1e6
    busy = sum(b - a for a, b in tr.union([(e.start_ns, e.end_ns)
                                           for e in ev])) / 1e6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:16]
    return {"part": "profile", "cell": CELL, "seed": seed,
            "eager_step_busy_ms": busy, "eager_step_kernels": len(ev),
            "eager_top_ms": top,
            "k7_ms": sum(v for k, v in totals.items()
                         if "ssd_decode_kernel" in k),
            "captured_step_ms": replay_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "ssd_decode_phase.jsonl"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_decode_phase: no CUDA device available", file=sys.stderr)
        return 1
    harness.set_cache_dirs(ROOT)
    torch.set_num_threads(1)
    card = harness.power_limit()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    line = profile_step(args.seed)
    line["card"] = card
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        print(json.dumps(line), flush=True)
        f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
