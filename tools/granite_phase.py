"""Granite 4.0-H Small's decode cell on the card, with the readings that
set its limit.

    python3 tools/granite_phase.py --seeds 2147484625,7 --seconds 2 \\
        --trace 1 [--root DIR] [--device cpu] [--out FILE]

For each seed, the cell ``granite-4.0-h-small.decode-b128`` runs through
the benchmark's own ``harness.run_cell`` with the reference's ``check``
watched: beside its numbers, the same runs are judged against the
reference computed in float8_e4m3fn put in the program's place (the
control, ``reference.fp8``), each returned position's error is kept (its
largest, 99th percentile and median), and the port's own bfloat16 forward
(``models.model.forward``, no cache) over the checked slots' sequences is
compared with the reference's float32 forward: its logits' error, and the
share of (token, layer) routings whose top-k sets differ between the two
(route flips at near-ties of the router's k-th and k+1-th logits).  Each
seed's line (the result line's numbers and these readings) is printed and
appended to ``--out`` (default ``build/granite_phase.jsonl``).
``--root`` runs the cell of another tree (a cut for the CPU);
``--device cpu`` runs it on the CPU.  Needs a CUDA card unless asked for
the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402

CELL = "granite-4.0-h-small.decode-b128"




def readings(ref, graph, outputs, state, device):
    """The control's error, the distribution of the program's errors, the
    port's cacheless forward against the reference, the route flips."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe

    loop = harness.load_module(ROOT / "portbench" / "loops"
                               / "engine_decode.py", "loop_engine_decode")
    runs, malformed, need = ref.wanted(graph, outputs, state)
    params = ref.inputs(graph, device)
    t0 = time.perf_counter()
    want = ref.reference_logits(graph, params, state, need, device)
    t_ref = time.perf_counter() - t0
    errs = []
    for pos, lg in runs:
        for s in range(pos.shape[0]):
            for j, p in enumerate(pos[s]):
                w = want[(s, int(p))]
                errs.append(float(np.abs(lg[s, j] - w).max()
                                  / np.abs(w).max()))
    low = ref.reference_logits(graph, params, state, need, device, ref.fp8)
    fake = [(pos, np.stack([[low[(s, int(p))] for p in pos[s]]
                            for s in range(pos.shape[0])]).astype(np.float32))
            for pos, _ in runs]
    control = ref.compare(want, fake, 0)["max_err_over_scale"]

    # the port's bfloat16 forward and the reference's float32 forward over
    # the same sequences, each layer's top-k kept
    cfg = loop.port_config(get_config("granite-4.0-h-small"), graph["model"],
                           graph["precision"])
    allp, _ = ref.prompts(graph)
    last = [max(nd) for nd in need]
    T = max(last) + 1
    tokens = torch.zeros((len(last), T), dtype=torch.int64)
    for s, slot in enumerate(state["slots"]):
        seq = np.concatenate([allp[slot], state["history"][s]])
        tokens[s, :last[s] + 1] = torch.from_numpy(seq[:last[s] + 1])
    tokens = tokens.to(device)
    valid = (torch.arange(T)[None] <= torch.tensor(last)[:, None]).reshape(-1)
    port_idx, ref_idx = [], []
    router, ref_moe = moe._router, ref.moe

    def port_router(x2d, wr, E, k):
        out = router(x2d, wr, E, k)
        port_idx.append(out[1].sort(-1).values.cpu())
        return out

    def ref_router(h, p, c, *rnd):
        x = h.reshape(-1, h.shape[-1])
        probs = torch.softmax(ref.mm(x, p["router"], *rnd), dim=-1)
        ref_idx.append(torch.topk(probs, c["num_experts_per_tok"], dim=-1)[1]
                       .sort(-1).values.cpu())
        return ref_moe(h, p, c, *rnd)

    moe._router, ref.moe = port_router, ref_router
    try:
        with torch.no_grad():
            port_lg, _ = M.forward(params, cfg, tokens)
            ref_lg = ref.forward(params, graph["model"], tokens)
    finally:
        moe._router, ref.moe = router, ref_moe
    flips = sum(int(((a != b).any(-1) & valid).sum())
                for a, b in zip(port_idx, ref_idx))
    pairs = int(valid.sum()) * len(port_idx)
    v = valid.reshape(len(last), T).to(device)
    diff = (port_lg.float() - ref_lg).abs().amax(-1)
    scale = ref_lg.abs().amax(-1)
    forward_err = float((diff / scale)[v].max())
    return {"control_max_err_over_scale": control,
            "program_err_max": max(errs), "program_err_p99":
            float(np.percentile(errs, 99)), "program_err_median":
            float(np.median(errs)), "positions": len(errs),
            "cacheless_forward_err_max": forward_err,
            "route_flip_share": flips / max(pairs, 1),
            "route_flips": flips, "routings": pairs,
            "reference_s": t_ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "granite_phase.jsonl"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("granite_phase: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(args.root)
    harness.set_cache_dirs(root)
    torch.set_num_threads(1 if device.type == "cuda" else 4)
    card = harness.power_limit() if device.type == "cuda" else "cpu"
    print(card, torch.__version__, torch.version.cuda, flush=True)
    load, extra = harness.load_module, {}

    def watching(path, name):
        mod = load(path, name)
        if name.startswith("reference_"):
            check = mod.check

            def watched(graph, outputs, ngraphs, state, device=None):
                t0 = time.perf_counter()
                out = check(graph, outputs, ngraphs, state, device=device)
                extra["check_s"] = time.perf_counter() - t0
                extra.update(readings(mod, graph, outputs, state, device))
                return out

            mod.check = watched
        return mod

    harness.load_module = watching
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        extra.clear()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = harness.run_cell(harness.resolve(CELL, root), seed, args.seconds,
                             bool(args.trace), device, t0)
        line = {"seed": seed, "card": card, "wall_s": time.perf_counter() - t0,
                "correct": r["correct"], "attempted": r["attempted"],
                "checks": {k: c["value"] for k, c in r["checks"].items()},
                "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                "device": r["device"], "setup_parts": r["setup_parts"],
                "breakdown": r.get("breakdown"), **extra}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
