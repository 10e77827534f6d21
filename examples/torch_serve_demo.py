"""Serve a small MoE model with continuous batching on the PyTorch port
(the port's ``examples/serve_demo.py``).

Six requests share three persistent batch slots: each request prefills
unpadded at batch 1 the moment a slot frees up (mid-decode for everyone
else) and decodes in on-device chunks — the host syncs once per chunk,
not once per token.  On a card the engine replays its decode step as a
CUDA graph.  The engine stats printed at the end show the sync
arithmetic; rerun with ``decode_mode="host"`` to see the per-token
baseline pay one round-trip per generated token.

Run: PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.models import model as M
from repro_torch.serve import ServeEngine


def main(argv=None, params=None):
    """Serve the demo's requests; ``params`` (the reduced model's, on the
    device) replaces the weights made from seed 0."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    cfg = reduced(get_config("mixtral-8x7b"))  # MoE family, ring KV cache
    if params is None:
        params = M.init_model(cfg, 0, device=args.device)
    engine = ServeEngine(cfg, params, batch_slots=3, max_len=128,
                         chunk_size=4, decode_mode="chunked")

    rng = np.random.RandomState(0)
    rids = [engine.submit(rng.randint(1, cfg.vocab_size, size=n),
                          max_new_tokens=m)
            for n, m in [(5, 8), (3, 4), (9, 6), (2, 10), (7, 5)]]
    # eos early-stop: this request halts as soon as it emits token 7
    rids.append(engine.submit(rng.randint(1, cfg.vocab_size, size=4),
                              max_new_tokens=12, eos_id=7))
    print(f"submitted {len(rids)} requests into {engine.slots} batch slots")
    out = engine.run()
    for rid in rids:
        print(f"  request {rid}: {len(out[rid])} tokens -> {out[rid]}")
    s = engine.stats
    print(f"stats: {s['prefills']} prefills, {s['decode_steps']} decode "
          f"steps in {s['chunk_launches']} chunk launches, "
          f"{s['host_syncs']} host syncs for {s['tokens_generated']} tokens")


if __name__ == "__main__":
    main()
