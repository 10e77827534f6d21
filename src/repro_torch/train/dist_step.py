"""The data-parallel train step on the rank processes, with the compressed
gradient all-reduce (the port of ``repro.train.dist_step``).

The reference's step is a ``shard_map`` over a data axis: the batch is
split over the ranks, each rank computes the gradients of its rows
(``train_step.compute_grads``), the gradients are averaged over the ranks
exactly (``pmean``) or through ``dist.compression.compressed_psum``, and
every rank runs the same AdamW update, so the state stays replicated.
Here a rank is a process of a ``dist.ranks.RankPool`` and its collectives
go through its ``RankComm``: ``dp_train_step`` is a rank's program, and
``DataParallel`` the controller's side (the counterpart of
``jit_dp_train_step``).

The replicated ``TrainState`` lives in the ranks.  Each rank builds it
from the same seed on its own device, or restores it (``load``: a
``TrainState`` sent to every rank, or a checkpoint directory every rank
reads).  A step sends each rank its rows of the batch, rows ``[r B/N, (r+1)
B/N)`` as ``P("data")`` gives them (the data is a pure function of the
step, but ``DataParallel`` takes the batch the trainer gives it, so it is a
drop-in for ``make_train_step``); a batch whose rows do not split over the
ranks raises, as the reference's sharding does.  A step returns rank 0's
metrics.  Rank 0 writes checkpoints in the reference's format (``save``),
``state()`` fetches its state to the controller, and ``fingerprint()``
checks that every replica holds the same parameters, bit for bit.

Numerics: without compression the step is the single-device step up to
the reduction split (each rank's mean over its rows, a float32 sum over
the ranks, ``/ N`` and a cast to the gradient's dtype); with it the
gradients also carry the int8 quantization error, at most ``0.5 * scale``
a rank.  The int32 sum is exact, so a resumed run repeats an
uninterrupted one bit for bit either way.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import tree as T
from ..checkpoint import checkpoint as ckpt
from ..dist.compression import compressed_psum
from ..kernels import _build
from ..optim import adamw
from ..optim.schedule import warmup_cosine
from . import train_step as TS

_GRAD_TAG, _METRICS_TAG = 0, 1  # the host buffers the all-reduces use


def _pmean(g: torch.Tensor, comm) -> torch.Tensor:
    """The mean of ``g`` over ``comm``'s ranks: a float32 sum, then ``/ N``,
    in ``g``'s dtype."""
    total = comm.all_reduce(g.float().contiguous(), _GRAD_TAG).wait()
    return (total / comm.size).to(g.dtype)


def sync_grads(grads, comm, compress: bool):
    """The gradients' mean over the ranks, leaf by leaf: compressed
    (``compressed_psum / N``) or exact (``pmean``)."""
    n = comm.size
    if compress:
        return T.tree_map(
            lambda g: compressed_psum(g, comm, _GRAD_TAG) / n, grads)
    return T.tree_map(lambda g: _pmean(g, comm), grads)


def dp_train_step(state: TS.TrainState, batch: Dict, cfg,
                  tcfg: TS.TrainConfig, comm, compress: bool = True):
    """One data-parallel optimizer step inside a rank, on this rank's rows
    of the batch (numpy arrays or tensors); the state is updated in place
    -> (state, metrics averaged over the ranks)."""
    batch = TS.to_device(batch, state.step.device)
    lr = warmup_cosine(state.step, tcfg.base_lr, tcfg.warmup_steps,
                       tcfg.total_steps)
    grads, metrics = TS.compute_grads(state.params, batch, cfg, tcfg)
    grads = sync_grads(grads, comm, compress)
    names = sorted(metrics)
    stacked = torch.stack([metrics[k].float() for k in names])
    mean = comm.all_reduce(stacked, _METRICS_TAG).wait() / comm.size
    metrics = dict(zip(names, mean.unbind()))
    metrics.update(adamw.update_(grads, state.opt, state.params, tcfg.adamw,
                                 lr=lr))
    state.step.add_(1)
    return state, metrics


# ------------------------------------------------------------ the ranks
@dataclasses.dataclass
class _Replica:
    state: TS.TrainState
    cfg: object
    tcfg: TS.TrainConfig
    compress: bool


def _rank_init(ctx, job: int, cfg, tcfg, compress: bool, seed: int) -> int:
    gen = torch.Generator(ctx.device).manual_seed(int(seed))
    state = TS.init_state(cfg, tcfg, gen, ctx.device)
    ctx.jobs[job] = _Replica(state, cfg, tcfg, compress)
    return int(state.step)


def _rank_load(ctx, job: int, src, step: Optional[int]) -> int:
    rep = ctx.jobs[job]
    if isinstance(src, str):
        if step is None:
            step = ckpt.latest_step(src)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {src}")
        like = TS.init_state(rep.cfg, rep.tcfg, 0, device="meta")
        rep.state = ckpt.restore(src, step, like, device=ctx.device)
    else:
        rep.state = T.tree_map(lambda t: t.to(ctx.device, copy=True), src)
    return int(rep.state.step)


def _rank_step(ctx, job: int, rows: Dict) -> Tuple[Dict, Dict]:
    rep = ctx.jobs[job]
    ctx.comm.reset_stats()
    before = _build.launch_counts()
    t0 = time.perf_counter()
    _, metrics = dp_train_step(rep.state, rows, rep.cfg, rep.tcfg, ctx.comm,
                               rep.compress)
    metrics = {k: float(v) for k, v in metrics.items()}  # the step's sync
    stats = dict(ctx.comm.stats, wall_s=time.perf_counter() - t0,
                 **_build.launch_counts(before))
    if ctx.device.type == "cuda":
        stats["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)
    return metrics, stats


def _rank_fingerprint(ctx, job: int) -> Dict[str, int]:
    return T.fingerprint(ctx.jobs[job].state.params)


def _rank_fetch(ctx, job: int, part: str):
    """Rank 0's state (``part="state"``), parameters (``"params"``) or
    AdamW master weights (``"master"``), copied to the CPU: a CPU tensor
    sent as it is would be shared with the rank, which goes on updating it
    in place."""
    if ctx.rank:
        return None
    state = ctx.jobs[job].state
    tree = {"state": state, "params": state.params,
            "master": state.opt.master}[part]
    return T.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _rank_save(ctx, job: int, ckpt_dir: str, step: int) -> None:
    if ctx.rank == 0:
        ckpt.save(ckpt_dir, step, ctx.jobs[job].state, async_write=False)


# ----------------------------------------------------------- controller
def shard_rows(batch: Dict, ranks: int) -> List[Dict[str, np.ndarray]]:
    """Rank r's rows ``[r B/N, (r+1) B/N)`` of every array of ``batch``
    (numpy arrays or tensors), as numpy arrays."""
    out = [{} for _ in range(ranks)]
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        if v.shape[0] % ranks:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {ranks} ranks")
        n = v.shape[0] // ranks
        for r in range(ranks):
            out[r][k] = np.ascontiguousarray(v[r * n:(r + 1) * n])
    return out


class DataParallel:
    """The replicated train state in every rank of ``pool`` (the ranks are
    the data axis), and its data-parallel step: the counterpart of
    ``jit_dp_train_step``.

    Each rank builds the state from ``seed`` on its own device (the same
    seed and device type give the controller's ``init_state`` the same
    bits); ``open`` also restores the latest checkpoint of a directory.
    ``run_step(batch)`` runs one step and returns rank 0's metrics as
    floats.  ``step`` is the replicas' step count.
    After a step, ``stats`` holds each rank's ``RankComm.stats`` of that
    step, its wall (``wall_s``), its launches by kernel id (K5 and K6 on
    a card; ``kernels._build.launch_counts``, a kernel that did not launch
    absent) and (on a card) its peak device memory.  The reference's
    ``ep_mode`` override is left out: the port's forward runs the MoE dense
    path, which no ``ep_mode`` changes.
    """

    def __init__(self, pool, cfg, tcfg: TS.TrainConfig, compress: bool = True,
                 seed: int = 0):
        self.pool = pool
        self.job = pool.new_job()
        weakref.finalize(self, pool.drop_job, self.job)
        self.step = pool.call(_rank_init, self.job, cfg, tcfg, compress,
                              seed)[0]
        self.stats: List[Dict] = []

    @classmethod
    def open(cls, pool, cfg, tcfg: TS.TrainConfig, compress: bool = True,
             seed: int = 0, ckpt_dir: Optional[str] = None
             ) -> "DataParallel":
        """The replicas built from ``seed``, then restored from the latest
        checkpoint in ``ckpt_dir`` when it holds one (a trainer's start)."""
        if not isinstance(seed, int):
            raise TypeError("the ranks build their replicas from an int "
                            "seed, not a generator")
        dp = cls(pool, cfg, tcfg, compress=compress, seed=seed)
        last = None if ckpt_dir is None else ckpt.latest_step(ckpt_dir)
        return dp if last is None else dp.load(ckpt_dir, last)

    def run_step(self, batch: Dict) -> Dict[str, float]:
        out = self.pool.map(_rank_step, [
            (self.job, rows) for rows in shard_rows(batch, self.pool.ranks)])
        self.stats = [s for _, s in out]
        self.step += 1
        return out[0][0]

    def load(self, src: Union[TS.TrainState, str],
             step: Optional[int] = None) -> "DataParallel":
        """Replace every replica: by ``src``, a ``TrainState`` (sent to
        each rank and moved to its device), or from the checkpoint of
        ``step`` (default: the latest) in the directory ``src``, which
        every rank reads."""
        if not isinstance(src, str):
            src = T.tree_map(lambda t: t.detach().cpu(), src)
        steps = self.pool.call(_rank_load, self.job, src, step)
        self.step = steps[0]
        return self

    def state(self) -> TS.TrainState:
        """Rank 0's state, copied to the controller's CPU."""
        return self.pool.call(_rank_fetch, self.job, "state")[0]

    def params(self, master: bool = False):
        """Rank 0's parameters (``master``: AdamW's float32 master
        weights, when it keeps them), copied to the controller's CPU."""
        return self.pool.call(_rank_fetch, self.job,
                              "master" if master else "params")[0]

    def save(self, ckpt_dir: str, step: int) -> None:
        """Rank 0 writes the checkpoint of ``step`` (``checkpoint.save``'s
        format) and has committed it when this returns."""
        self.pool.call(_rank_save, self.job, ckpt_dir, step)

    def fingerprint(self) -> Dict[str, int]:
        """The parameters' ``tree.fingerprint``, after checking that every
        replica has the same one (raises RuntimeError if not)."""
        prints = self.pool.call(_rank_fingerprint, self.job)
        for r, p in enumerate(prints):
            if p != prints[0]:
                bad = sorted(k for k in p if p[k] != prints[0][k])
                raise RuntimeError(f"the replicas diverged: rank {r} "
                                   f"differs from rank 0 at {bad[:3]}")
        return prints[0]

