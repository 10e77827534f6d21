"""Training step: loss, gradients, microbatch accumulation, optimizer (the
port of ``repro.train.train_step``).

``TrainState`` is the one checkpointable tree.  ``make_train_step`` is the
counterpart of the reference's ``jit_train_step``: it returns a callable
that updates the state's tensors in place (the counterpart of donating
them), accumulating gradients over ``grad_accum`` microbatches and adding
the MoE aux losses to the objective.  ``train_step`` is the functional
form, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

from .. import tree as T
from ..backends.base import resolve_device
from ..models import model as M
from ..optim import adamw
from ..optim.schedule import warmup_cosine

Z_LOSS = 1e-4
MOE_LB_COEF = 1e-2
MOE_Z_COEF = 1e-3
METRICS = ("loss", "z_loss", "moe_lb_loss", "total_loss")


@dataclasses.dataclass
class TrainState:
    step: Any  # int32, 0-d, on the parameters' device
    params: Any
    opt: adamw.AdamWState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_accum: int = 1
    adamw: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)


def init_state(cfg, tcfg: TrainConfig,
               generator: Union[torch.Generator, int] = 0,
               device=None) -> TrainState:
    """Random parameters (``models.model.init_model``) and a fresh AdamW
    state on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    params = M.init_model(cfg, generator, device)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=params, opt=adamw.init(params, tcfg.adamw))


def token_loss(logits: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, z-loss) of next-token logits, in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, labels.long()[..., None],
                               dim=-1)[..., 0]
    nll = (logz - tgt).mean()
    zloss = Z_LOSS * (logz ** 2).mean()
    return nll, zloss


def loss_fn(params, cfg, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    logits, _, aux = M.forward(params, cfg, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"), return_aux=True)
    nll, zloss = token_loss(logits, batch["labels"])
    total = nll + zloss
    total = total + MOE_LB_COEF * aux["moe_lb_loss"] \
        + MOE_Z_COEF * aux["moe_z_loss"]
    metrics = {"loss": nll, "z_loss": zloss,
               "moe_lb_loss": aux["moe_lb_loss"], "total_loss": total}
    return total, metrics


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(True)


def _value_and_grad(params, cfg, batch: Dict):
    """(metrics, grads in the parameters' dtypes, in ``tree.leaves``
    order); a parameter the loss does not reach (the embedding table of a
    model fed embeddings) gets zeros, as JAX gives it.

    A stacked block tree (``blocks_scanned``) is differentiated a layer at
    a time: each layer's slice of a stacked weight is a leaf of its own,
    handed to the model as the per-layer list ``blocks``, and the layers'
    gradients are stacked once.  Differentiating the stacked weight itself
    through the layer loop's indexing would build a full-size zero
    gradient and add it up for every layer (L^2 of the stack's bytes)."""
    n = len(M.layer_params(params, cfg))
    diff = {k: T.tree_map(_leaf, v) for k, v in params.items()
            if k != "blocks_scanned"}
    if "blocks_scanned" in params:
        diff["blocks"] = [T.tree_map(lambda t: _leaf(t[i]),
                                     params["blocks_scanned"])
                          for i in range(n)]
    total, metrics = loss_fn(diff, cfg, batch)
    got = dict(zip((k for k, _ in T.flatten(diff)), torch.autograd.grad(
        total, T.leaves(diff), materialize_grads=True)))
    grads = []
    for key, _ in T.flatten(params):
        if key.startswith("['blocks_scanned']"):
            sub = key[len("['blocks_scanned']"):]
            grads.append(torch.stack([got[f"['blocks'][{i}]{sub}"]
                                      for i in range(n)]))
        else:
            grads.append(got[key])
    return {k: v.detach() for k, v in metrics.items()}, grads


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data.make_batch``) or tensors on
    ``device``."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def compute_grads(params, batch: Dict, cfg, tcfg: TrainConfig):
    """-> (grads, loss metrics), averaged over ``tcfg.grad_accum``
    microbatches (the batch split along its leading dim) as the reference
    does: float32 sums times 1 / grad_accum."""
    n = tcfg.grad_accum
    if n == 1:
        metrics, grads = _value_and_grad(params, cfg, batch)
        return T.unflatten(params, grads), metrics
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split into {n} microbatches")
    rows = next(iter(batch.values())).shape[0] // n
    # microbatch i is rows [i rows, (i + 1) rows) of each entry: slices,
    # which DTensor shards as it does the batch (a reshape to (n, rows)
    # of a dim split over two mesh axes it cannot lay out)
    g_acc = [torch.zeros_like(p, dtype=torch.float32)
             for p in T.leaves(params)]
    m_acc = {k: torch.zeros((), dtype=torch.float32,
                            device=g_acc[0].device) for k in METRICS}
    for i in range(n):
        m, g = _value_and_grad(params, cfg, {k: v[i * rows:(i + 1) * rows]
                                             for k, v in batch.items()})
        for a, b in zip(g_acc, g):
            a.add_(b)
        for k in METRICS:
            m_acc[k] = m_acc[k] + m[k]
    inv = 1.0 / n
    return (T.unflatten(params, [g * inv for g in g_acc]),
            {k: v * inv for k, v in m_acc.items()})


def _lr(state: TrainState, tcfg: TrainConfig) -> torch.Tensor:
    return warmup_cosine(state.step, tcfg.base_lr, tcfg.warmup_steps,
                         tcfg.total_steps)


def train_step(state: TrainState, batch: Dict, cfg, tcfg: TrainConfig):
    """One optimizer step, functional -> (new state, metrics)."""
    grads, metrics = compute_grads(state.params, batch, cfg, tcfg)
    new_params, new_opt, opt_metrics = adamw.update(
        grads, state.opt, state.params, tcfg.adamw, lr=_lr(state, tcfg))
    metrics.update(opt_metrics)
    return TrainState(step=state.step + 1, params=new_params,
                      opt=new_opt), metrics


def make_train_step(cfg, tcfg: TrainConfig) -> Callable:
    """The step the trainer runs: ``step(state, batch) -> (state,
    metrics)``, with ``batch`` numpy arrays or tensors (moved to the
    state's device), the state's tensors updated in place and returned."""
    def step(state: TrainState, batch: Dict):
        batch = to_device(batch, state.step.device)
        lr = _lr(state, tcfg)
        grads, metrics = compute_grads(state.params, batch, cfg, tcfg)
        metrics.update(adamw.update_(grads, state.opt, state.params,
                                     tcfg.adamw, lr=lr))
        state.step.add_(1)
        return state, metrics

    return step
