"""Fault-tolerant training loop (the port of ``repro.train.trainer``).

  - periodic asynchronous checkpoints with an atomic commit;
  - resume from the latest committed one, bit-exact on one device (the
    data is a pure function of the step, the state restored whole);
  - a step watchdog: an EMA of the step time, and steps slower than
    ``straggler_factor`` x the EMA logged as straggler events;
  - failure injection for tests (raise at step N, restart, resume);
  - SIGTERM: checkpoint, then exit (preemption).

The loop syncs the loss to the host once a step (``float``), as the
reference's ``block_until_ready`` does, so a step's time is the device's.
``grad_sync`` runs the data-parallel step (``train.dist_step``) on the
rank processes of a pool: the replicated state lives in the ranks, rank 0
writes the checkpoints, and a resume is bit-exact there too.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable, Dict, List, Optional, Union

import torch

from ..backends.base import resolve_device
from ..checkpoint import checkpoint as ckpt
from ..data.pipeline import DataConfig, make_batch
from . import dist_step as DS
from . import train_step as TS


@dataclasses.dataclass
class LoopConfig:
    num_steps: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    keep_metrics: bool = True


class Trainer:
    def __init__(self, cfg, tcfg: TS.TrainConfig, dcfg: DataConfig,
                 loop: LoopConfig, step_fn: Optional[Callable] = None,
                 grad_sync: Optional[str] = None, pool=None, device=None):
        """``step_fn`` defaults to ``make_train_step(cfg, tcfg)``; the state
        lives on ``device`` (``cuda`` unless the caller asks for the
        CPU).  ``grad_sync`` selects the data-parallel step
        (``train.dist_step``) over the ranks of ``pool`` (a
        ``dist.ranks.RankPool``, the counterpart of a mesh's data axis):
        ``"psum"`` for the exact all-reduce, ``"compressed_psum"`` for the
        int8-range shared-scale one; the state then lives in the ranks,
        on the pool's device, and ``run`` returns its ``DataParallel``."""
        self.cfg, self.tcfg, self.dcfg, self.loop = cfg, tcfg, dcfg, loop
        if grad_sync is not None:
            if step_fn is not None:
                raise ValueError("pass either step_fn or grad_sync, not both")
            if grad_sync not in ("psum", "compressed_psum"):
                raise ValueError(f"unknown grad_sync {grad_sync!r}")
            if pool is None:
                raise ValueError("grad_sync needs a pool of rank processes "
                                 "(the data axis)")
            compress = grad_sync == "compressed_psum"
            self._open = lambda seed: DS.DataParallel.open(
                pool, cfg, tcfg, compress, seed, self.loop.ckpt_dir)
            step_fn = lambda dp, batch: (dp, dp.run_step(batch))  # noqa
        else:
            self.device = resolve_device(device)
            self._open = self._open_local
        self.step_fn = step_fn or TS.make_train_step(cfg, tcfg)
        self.metrics_log: List[Dict] = []
        self.straggler_events: List[Dict] = []
        self._ema = None
        self._pending_ckpt = None
        self._term = False

    # -- lifecycle -----------------------------------------------------------
    def init_or_restore(self, generator: Union[torch.Generator, int] = 0
                        ) -> Union[TS.TrainState, DS.DataParallel]:
        return self._open(generator)

    def _open_local(self, generator) -> TS.TrainState:
        last = ckpt.latest_step(self.loop.ckpt_dir)
        state = TS.init_state(self.cfg, self.tcfg, generator, self.device)
        if last is not None:
            state = ckpt.restore(self.loop.ckpt_dir, last, state,
                                 device=self.device)
        return state

    def _sigterm(self, signum, frame):  # pragma: no cover - signal path
        self._term = True

    # -- main loop -----------------------------------------------------------
    def run(self, generator: Union[torch.Generator, int] = 0,
            fail_at: Optional[int] = None
            ) -> Union[TS.TrainState, DS.DataParallel]:
        os.makedirs(self.loop.ckpt_dir, exist_ok=True)
        prev = signal.signal(signal.SIGTERM, self._sigterm)
        state = self.init_or_restore(generator)
        try:
            start = int(state.step)
            for step in range(start, self.loop.num_steps):
                if fail_at is not None and step == fail_at:
                    raise RuntimeError(f"injected failure at step {step}")
                batch = make_batch(self.dcfg, step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])  # the step's one sync
                dt = time.perf_counter() - t0
                self._watch(step, dt)
                if self.loop.keep_metrics:
                    self.metrics_log.append(
                        {"step": step, "time_s": dt,
                         **{k: float(v) for k, v in metrics.items()}})
                if self.loop.log_every and step % self.loop.log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} gnorm "
                          f"{float(metrics['grad_norm']):.3f} "
                          f"{dt * 1e3:.0f}ms")
                next_step = step + 1
                if next_step % self.loop.ckpt_every == 0 or self._term:
                    self._checkpoint(state, next_step)
                if self._term:
                    print("SIGTERM: checkpointed, exiting")
                    break
            self._checkpoint(state, int(state.step))
            return state
        finally:
            # commit any in-flight checkpoint even when the loop raised: a
            # restart must see the last completed save
            self._join_ckpt()
            signal.signal(signal.SIGTERM, prev)

    # -- internals -----------------------------------------------------------
    def _watch(self, step: int, dt: float):
        if self._ema is None:
            self._ema = dt
        if dt > self.loop.straggler_factor * self._ema and step > 2:
            self.straggler_events.append({"step": step, "time_s": dt,
                                          "ema_s": self._ema})
        self._ema = 0.9 * self._ema + 0.1 * dt

    def _checkpoint(self, state, step: int):
        self._join_ckpt()
        if isinstance(state, DS.DataParallel):
            state.save(self.loop.ckpt_dir, step)  # committed on return
        else:
            self._pending_ckpt = ckpt.save(self.loop.ckpt_dir, step, state)

    def _join_ckpt(self):
        if self._pending_ckpt is not None:
            self._pending_ckpt.join()
            self._pending_ckpt = None
