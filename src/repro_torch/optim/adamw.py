"""AdamW with the reference's production knobs (the port of
``repro.optim.adamw``):

- decoupled weight decay under a mask (no decay on 1-D parameters);
- global-norm gradient clipping;
- float32 master weights when the parameters are not float32, or the
  moments in bf16 (``state_dtype``) for memory-bound giants;
- int8 error-feedback gradient compression (``dist.compression``).

The arithmetic is the reference's, step by step, in float32.  ``update``
is functional, as the reference's; ``update_`` writes the same values into
the parameters and the state in place, a leaf at a time (the counterpart of
the reference's donated buffers), so a step holds one leaf's temporaries
beside the model, not a second copy of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import tree as T
from ..dist.compression import ef_compress_tree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # mu/nu dtype
    master_weights: bool = True       # float32 master copy when params aren't
    compression: Optional[str] = None  # None | "int8_ef"


@dataclasses.dataclass
class AdamWState:
    step: Any         # int32, 0-d
    mu: Any
    nu: Any
    master: Any       # float32 copy of the params, or None
    ef_residual: Any  # error-feedback residual, or None


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    try:
        return DTYPES[cfg.state_dtype]
    except KeyError:
        raise ValueError(f"unsupported state_dtype {cfg.state_dtype!r}; "
                         f"known: {sorted(DTYPES)}") from None


def decay_mask(params) -> Any:
    """True where weight decay applies: parameters of 2 or more dims."""
    return T.tree_map(lambda p: p.ndim >= 2, params)


def init(params, cfg: AdamWConfig) -> AdamWState:
    sdt = _state_dtype(cfg)
    leaves = T.leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    master = None
    if cfg.master_weights and any(p.dtype != torch.float32 for p in leaves):
        master = T.tree_map(lambda p: p.detach().float().clone(), params)
    ef = None
    if cfg.compression == "int8_ef":
        ef = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    elif cfg.compression is not None:
        raise ValueError(f"unknown compression {cfg.compression!r}")
    zeros = lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=T.tree_map(zeros, params),
                      nu=T.tree_map(zeros, params), master=master,
                      ef_residual=ef)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in T.leaves(tree)))


def _prepare(grads, state: AdamWState, cfg: AdamWConfig):
    """float32 grads, compressed when asked, and clipped -> (grads leaves,
    new residual leaves or None, global norm before clipping)."""
    g = [x.float() for x in T.leaves(grads)]
    new_ef = None
    if cfg.compression == "int8_ef":
        g, new_ef = ef_compress_tree(g, T.leaves(state.ef_residual))
    gnorm = global_norm(g)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    return [x * scale for x in g], new_ef, gnorm


def _leaf(cfg: AdamWConfig, sdt, lr, c1, c2, ref, m, v, g, decay: bool):
    """One parameter's AdamW step in float32 -> (new mu, new nu, new
    float32 parameter)."""
    new_m = (cfg.b1 * m.float() + (1 - cfg.b1) * g).to(sdt)
    new_v = (cfg.b2 * v.float() + (1 - cfg.b2) * g * g).to(sdt)
    p32 = ref.float()
    mh = new_m.float() / c1
    vh = new_v.float() / c2
    upd = mh / (torch.sqrt(vh) + cfg.eps)
    if decay:
        upd = upd + cfg.weight_decay * p32
    return new_m, new_v, p32 - lr * upd


def _coeffs(state: AdamWState, cfg: AdamWConfig, lr):
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                      device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                      device=t.device), t)
    lr = cfg.lr if lr is None else lr
    return step, c1, c2, torch.as_tensor(lr, dtype=torch.float32,
                                         device=t.device)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           lr: Optional[torch.Tensor] = None):
    """One AdamW step -> (new params, new state, metrics)."""
    sdt = _state_dtype(cfg)
    g, new_ef, gnorm = _prepare(grads, state, cfg)
    step, c1, c2, lr_t = _coeffs(state, cfg, lr)
    ref = state.master if state.master is not None else params
    outs = [_leaf(cfg, sdt, lr_t, c1, c2, r, m, v, gg, p.ndim >= 2)
            for r, m, v, gg, p in zip(T.leaves(ref), T.leaves(state.mu),
                                      T.leaves(state.nu), g,
                                      T.leaves(params))]
    new_ref = [o[2] for o in outs]
    new_params = T.unflatten(params, [r.to(p.dtype) for r, p in
                                      zip(new_ref, T.leaves(params))])
    new_state = AdamWState(
        step=step, mu=T.unflatten(params, [o[0] for o in outs]),
        nu=T.unflatten(params, [o[1] for o in outs]),
        master=(T.unflatten(params, new_ref) if state.master is not None
                else None),
        ef_residual=(T.unflatten(params, new_ef) if new_ef is not None
                     else state.ef_residual))
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr_t}


@torch.no_grad()
def update_(grads, state: AdamWState, params, cfg: AdamWConfig,
            lr: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``update`` written into ``params`` and ``state`` in place, a leaf at
    a time -> metrics.  The clipped float32 grads are let go a leaf at a
    time, as the update uses them."""
    sdt = _state_dtype(cfg)
    g, new_ef, gnorm = _prepare(grads, state, cfg)
    step, c1, c2, lr_t = _coeffs(state, cfg, lr)
    if new_ef is not None:
        for r, n in zip(T.leaves(state.ef_residual), new_ef):
            r.copy_(n)
    plist = T.leaves(params)
    ref = T.leaves(state.master) if state.master is not None else plist
    for i, (r, m, v, p) in enumerate(zip(ref, T.leaves(state.mu),
                                         T.leaves(state.nu), plist)):
        new_m, new_v, new_r = _leaf(cfg, sdt, lr_t, c1, c2, r, m, v, g[i],
                                    p.ndim >= 2)
        g[i] = None
        m.copy_(new_m)
        v.copy_(new_v)
        if state.master is not None:
            r.copy_(new_r)
        p.copy_(new_r)
    state.step.copy_(step)
    return {"grad_norm": gnorm, "lr": lr_t}


def state_logical_axes(state: AdamWState, param_axes) -> AdamWState:
    """Optimizer-state axes mirror parameter axes (FSDP-aligned)."""
    return AdamWState(
        step=(),
        mu=param_axes,
        nu=param_axes,
        master=param_axes if state.master is not None else None,
        ef_residual=param_axes if state.ef_residual is not None else None,
    )
