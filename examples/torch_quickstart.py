"""Quickstart on the PyTorch port: end-to-end training with checkpoints
(the port's ``examples/quickstart.py``).

Trains a reduced Qwen1.5-family model on the synthetic pipeline for a few
hundred steps with checkpointing, then resumes from the checkpoint to show
restart-determinism.  Runs on the card unless ``--device cpu`` is given.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--steps 200]
     [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import LoopConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where checkpoints go (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    print(f"arch: {cfg.name} ({cfg.num_layers}L d={cfg.d_model})")
    tcfg = TS.TrainConfig(base_lr=1e-3, warmup_steps=20,
                          total_steps=args.steps, grad_accum=1)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                      embed_dim=cfg.d_model if cfg.frontend else 0)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="repro_torch_quickstart_")
    loop = LoopConfig(num_steps=args.steps, ckpt_dir=ckpt_dir,
                      ckpt_every=max(args.steps // 4, 1), log_every=20)

    trainer = Trainer(cfg, tcfg, dcfg, loop, device=args.device)
    trainer.run(0)
    losses = [m["loss"] for m in trainer.metrics_log]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps on {trainer.device}")
    print(f"checkpoints in {ckpt_dir}; straggler events: "
          f"{len(trainer.straggler_events)}")

    # resume determinism: a fresh trainer continues from the checkpoint
    loop2 = LoopConfig(num_steps=args.steps + 10, ckpt_dir=ckpt_dir,
                       ckpt_every=1000, log_every=5)
    trainer2 = Trainer(cfg, tcfg, dcfg, loop2, device=args.device)
    trainer2.run(0)
    print(f"resumed at step {trainer2.metrics_log[0]['step']} and ran to "
          f"{trainer2.metrics_log[-1]['step'] + 1}")
    return trainer, trainer2


if __name__ == "__main__":
    main()
