"""Asynchronous, atomically committed checkpoints (the port of
``repro.checkpoint.checkpoint``), in the reference's format.

One ``step_<N>/`` directory per save, holding
  manifest.json: step, the flat key list (``tree.flatten``'s, which are
                 JAX's ``keystr`` paths), shapes, dtypes, ``num_hosts``;
  host0.npz:     the leaves as ``a0``, ``a1``, ... (one host), bf16 stored
                 as its ``uint16`` bits and named ``bfloat16`` in the
                 manifest.
The leaves are copied to the host before ``save`` returns; a writer thread
writes them into ``.tmp_step_<N>_<host>`` and commits with one rename, so
``latest_step`` trusts only directories that hold a manifest.  ``restore``
is bit-exact: the trainer's resume replays the uninterrupted run's losses.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import tree as T
from ..backends.base import resolve_device

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.int32: np.int32, torch.int64: np.int64, torch.int8: np.int8,
          torch.uint8: np.uint8, torch.bool: np.bool_,
          torch.float16: np.float16}
# npz cannot hold bf16: its bits as an integer view of the same width
_VIEW = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16)}
_TORCH = {"bfloat16": torch.bfloat16,
          **{np.dtype(n).name: t for t, n in _NUMPY.items()}}


def _to_host(t: torch.Tensor):
    """-> (dtype name, numpy array as stored), a copy also of a CPU tensor
    (the trainer updates its state in place while the writer runs)."""
    t = t.detach()
    if t.dtype in _VIEW:
        name, as_int, stored = _VIEW[t.dtype]
        return name, t.view(as_int).to("cpu", copy=True).numpy().view(stored)
    a = t.to("cpu", copy=True).numpy()
    return a.dtype.name, a


def _from_host(a: np.ndarray, name: str, device) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def save(ckpt_dir: str, step: int, tree, host_id: int = 0,
         async_write: bool = True) -> threading.Thread:
    """Write the checkpoint of ``step``; returns the writer thread."""
    flat = T.flatten(tree)
    host = [_to_host(leaf) for _, leaf in flat]  # on the host before return
    manifest = {
        "step": int(step),
        "keys": [k for k, _ in flat],
        "shapes": [list(a.shape) for _, a in host],
        "dtypes": [name for name, _ in host],
        "num_hosts": 1,
    }
    arrays = {f"a{i}": a for i, (_, a) in enumerate(host)}

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{host_id}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"host{host_id}.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the commit

    t = threading.Thread(target=_write, daemon=False)
    t.start()
    if not async_write:
        t.join()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, name, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like, device=None) -> Any:
    """The checkpoint of ``step`` in the structure of ``tree_like``, its
    tensors on ``device`` (``cuda`` unless the caller asks for the CPU).
    Raises ValueError when the saved keys, shapes or dtypes are not
    ``tree_like``'s."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = T.flatten(tree_like)
    keys = manifest["keys"]
    if [k for k, _ in flat_like] != keys:
        raise ValueError(f"checkpoint/tree structure mismatch: the "
                         f"checkpoint holds {len(keys)} leaves "
                         f"{keys[:3]}..., the tree {len(flat_like)}")
    for (k, like), shape, name in zip(flat_like, manifest["shapes"],
                                      manifest["dtypes"]):
        if list(like.shape) != shape or _TORCH.get(name) != like.dtype:
            raise ValueError(f"{k}: the checkpoint holds {name} {shape}, "
                             f"the tree {like.dtype} {list(like.shape)}")
    with np.load(os.path.join(path, "host0.npz")) as data:
        arrays = [_from_host(data[f"a{i}"], manifest["dtypes"][i], device)
                  for i in range(len(keys))]
    return T.unflatten(tree_like, arrays)
