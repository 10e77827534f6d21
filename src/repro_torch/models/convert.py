"""Weights carried across from the reference package's parameter tree.

``params_from_jax`` takes the JAX package's parameters as numpy arrays
(``split_leaves(init_model(...))[0]`` mapped through ``np.asarray``: nested
dicts, with ``blocks_scanned`` stacked on a leading layer dim or ``blocks``
a list of per-layer dicts) and returns the port's parameters, so that both
packages compute the same function in the tests.  It imports no JAX: it
walks the numpy tree by key and index, against the keys, shapes and dtypes
``model.init_model`` makes (the RG-LRU block's float32 ``lam``, ``b_a``
and ``b_i`` among them).

``train_state_from_jax`` carries a reference ``TrainState`` across the same
way (its leaves as numpy arrays, ``jax.tree.map(np.asarray, state)``, which
keeps the dataclasses): step, params, and the AdamW state's step, mu, nu,
master weights and error-feedback residual, each against the dtypes the
port's ``train_step.init_state`` makes for the same configs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..backends.base import resolve_device
from .model import check_supported, init_model


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy (arrays from JAX are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        bits = a.view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _carry(src, like, path: str, device: torch.device):
    if isinstance(like, dict):
        if not isinstance(src, dict) or set(src) != set(like):
            got = sorted(src) if isinstance(src, dict) else type(src).__name__
            raise ValueError(f"{path or 'params'}: keys {got}, the port "
                             f"expects {sorted(like)}")
        return {k: _carry(src[k], like[k], f"{path}/{k}", device)
                for k in like}
    if isinstance(like, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(like):
            got = (len(src) if isinstance(src, (list, tuple))
                   else type(src).__name__)
            raise ValueError(f"{path}: {got} layers, the port expects a list "
                             f"of {len(like)}")
        return [_carry(s, l, f"{path}/{i}", device)
                for i, (s, l) in enumerate(zip(src, like))]
    t = _tensor(src, device)
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise ValueError(f"{path}: {t.dtype} {tuple(t.shape)}, the port "
                         f"expects {like.dtype} {tuple(like.shape)}")
    return t


def params_from_jax(tree: Dict, cfg, device=None) -> Dict:
    """The port's parameters for ``cfg`` from the reference's numpy tree,
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    like = init_model(cfg, 0, device="meta")
    return _carry(tree, like, "", device)


def _carry_tree(src, like, path: str, device: torch.device):
    if like is None:
        if src is not None:
            raise ValueError(f"{path}: the port expects None")
        return None
    return _carry(src, like, path, device)


def train_state_from_jax(state, cfg, tcfg, device=None):
    """The port's ``TrainState`` for ``cfg`` and ``tcfg`` from the
    reference's (numpy leaves), on ``device`` (``cuda`` unless the caller
    asks for the CPU)."""
    from ..train.train_step import TrainState, init_state

    check_supported(cfg)
    device = resolve_device(device)
    like = init_state(cfg, tcfg, 0, device="meta")
    opt = state.opt
    return TrainState(
        step=_tensor(state.step, device),
        params=_carry(state.params, like.params, "params", device),
        opt=type(like.opt)(
            step=_tensor(opt.step, device),
            mu=_carry(opt.mu, like.opt.mu, "opt.mu", device),
            nu=_carry(opt.nu, like.opt.nu, "opt.nu", device),
            master=_carry_tree(opt.master, like.opt.master, "opt.master",
                               device),
            ef_residual=_carry_tree(opt.ef_residual, like.opt.ef_residual,
                                    "opt.ef_residual", device)))
