"""Fault tolerance on the PyTorch port: crash mid-run, restart, verify a
bit-exact resume (the port's ``examples/elastic_restart.py``).

Runs on the card unless ``--device cpu`` is given; ``--steps`` and
``--fail-at`` shorten the run (checkpoints every ``--steps // 3`` steps).

Run: PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]
     [--steps 24] [--fail-at 13]
"""
import argparse
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import LoopConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card)")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--fail-at", type=int, default=13)
    args = ap.parse_args(argv)

    cfg = reduced(get_config("yi-6b"))
    tcfg = TS.TrainConfig(base_lr=1e-3, warmup_steps=4, total_steps=60)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    every = max(args.steps // 3, 1)

    def trainer(prefix):
        d = tempfile.mkdtemp(prefix=prefix)
        return Trainer(cfg, tcfg, dcfg, LoopConfig(
            num_steps=args.steps, ckpt_dir=d, ckpt_every=every, log_every=0),
            device=args.device)

    ref = trainer("repro_torch_elastic_")
    ref.run(0)
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}
    print(f"reference run: {len(ref_losses)} steps")

    crashed = trainer("repro_torch_elastic_b_")
    try:
        crashed.run(0, fail_at=args.fail_at)
    except RuntimeError as e:
        print(f"crash injected: {e}")

    resumed = Trainer(cfg, tcfg, dcfg, crashed.loop, device=args.device)
    resumed.run(0)
    first = resumed.metrics_log[0]["step"]
    exact = all(m["loss"] == ref_losses[m["step"]]
                for m in resumed.metrics_log)
    print(f"resumed from checkpointed step {first} "
          f"(crash was at {args.fail_at}); losses bit-exact vs reference: "
          f"{exact}")
    assert exact
    return ref, resumed


if __name__ == "__main__":
    main()
