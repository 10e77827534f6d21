"""Framework METG: the paper's metric applied to the port's own training
runtime (the counterpart of ``benchmarks/bench_model_step.py``).

One transformer block is the "task": with the layer count fixed, the work a
layer is varied through the sequence length, and the train step's time a
layer is set against the dispatch floor, the time below which PyTorch's
launch overhead (Python, the dispatcher, the CUDA launch) takes more than
half a step.  That is the number a user needs to pick microbatch sizes on
real hardware, the paper's §V-C question asked of this framework itself.

The steps are ``train_step.make_train_step``'s, the loss synced to the
host, timed by ``bench.time_run``; the floor is 100 calls of a one-element
in-place add on the device and one synchronize (the reference's jitted
``noop``).  The rows are the reference's, names and extras.  Like the
reference's family it always runs on the wall clock, on the card unless
the context asks for another device (``--device cpu``), and writes no
artifact.
"""
from __future__ import annotations

import time
from typing import List

import torch

from ...backends.base import resolve_device
from ...configs import get_config, reduced
from ...data.pipeline import DataConfig, make_batch
from ...train import train_step as TS
from ..metg import time_run

from .common import BenchContext, Row

ARCHS = ["qwen1.5-0.5b", "mixtral-8x7b", "mamba2-2.7b"]
SEQS = (16, 64, 256)
FLOOR_CALLS = 100


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dispatch_floor(device: torch.device) -> float:
    """Seconds a call of a one-element in-place add, over FLOOR_CALLS calls
    and one synchronize."""
    x = torch.zeros((), device=device)
    x.add_(1)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(FLOOR_CALLS):
        x.add_(1)
    _sync(device)
    return (time.perf_counter() - t0) / FLOOR_CALLS


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    device = resolve_device(ctx.device)
    archs = ARCHS[:1] if ctx.smoke else ARCHS
    seqs = SEQS[:1] if ctx.smoke else SEQS
    repeats = 1 if ctx.smoke else 3
    rows: List[Row] = []
    for arch in archs:
        cfg = reduced(get_config(arch))
        tcfg = TS.TrainConfig(total_steps=100)
        state = TS.init_state(cfg, tcfg, 0, device)
        step = TS.make_train_step(cfg, tcfg)
        per_layer = []
        for seq in seqs:
            dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=4,
                              embed_dim=cfg.d_model if cfg.frontend else 0)
            batch = TS.to_device(make_batch(dcfg, 0), device)
            state, m = step(state, batch)  # the first call builds the kernels
            float(m["loss"])

            def one_step():
                nonlocal state
                state, mm = step(state, batch)
                float(mm["loss"])

            best = time_run(one_step, repeats=repeats)
            gran = best / cfg.num_layers
            per_layer.append(gran)
            rows.append(Row(f"model_step.{arch}.seq{seq}", best * 1e6,
                            f"per_layer_task_us={gran * 1e6:.1f}"))
        floor = dispatch_floor(device)
        rows.append(Row(f"model_step.{arch}.dispatch_floor", floor * 1e6,
                        f"min_layer_task_us={min(per_layer) * 1e6:.1f};"
                        f"framework_overhead_ratio="
                        f"{floor / max(min(per_layer), 1e-9):.3f}"))
    return rows
