"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
mesh (the port of ``repro.launch.dryrun``).

For each cell this starts a fake process group of the production mesh's
size (256 or 512 ranks in this one process; no rank exists and nothing
is sent), builds the mesh over it, places the abstract inputs of the
cell on it as DTensors of fake tensors (``FakeTensorMode``: shapes and
dtypes, no storage) through the logical-axes rules, runs the real step
once — ``train.train_step.make_train_step``'s step (remat and gradient
accumulation as the config and the mesh ask) for train shapes,
``models.model.forward`` with ``last_token_only`` for prefill,
``serve.engine.serve_step`` (the body of the engine's host step) for
decode — and counts what rank 0 dispatches with
``launch.roofline.CostCounter``.  This is the one entry point that uses
no device: its mesh is fake by design.  A one-rank mesh places every
tensor whole, so its cells trace plain fake tensors.

The result dict has the reference's keys.  The port has no lowering or
compilation: ``lower_s`` and ``compile_s`` both hold the trace's seconds.
``xla_cost_*`` hold the counter's own totals (no second, loop-unaware
count exists).  ``memory`` is the port's own measure, per device:
``argument_gb`` the local shards of the inputs, ``output_gb`` of the
outputs, ``alias_gb`` of the outputs that are inputs updated in place
(the train state, the caches), ``temp_gb`` the peak of the bytes that the
step's ops allocated and still held.

Results accumulate in a JSON cache (one entry per cell x mesh x strategy)
so interrupted sweeps resume; ``--force`` recomputes.  The default output
is ``results/dryrun_torch.json``, beside (never over) the reference's
``results/dryrun.json``.

Usage:
  python -m repro_torch.launch.dryrun                     # full sweep
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --strategy dp_only
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Optional, Sequence, Tuple, Union

import torch

from .. import tree as T
from ..configs import ALL_ARCHS, SHAPES, InputShape, get_config, \
    shape_applicable
from ..dist.sharding import make_rules, use_rules
from ..launch import specs as SP
from ..launch.mesh import make_debug_mesh, production_mesh_spec
from ..launch.roofline import CostCounter
from ..models import model as M
from ..optim import adamw
from ..serve.engine import _greedy, serve_step
from ..train import train_step as TS

RESULTS_PATH = os.path.join("results", "dryrun_torch.json")


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this process (this
    process is rank 0; collectives return at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already started in this "
                           "process; the dry run starts its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _Live:
    """The bytes of the tensors the step's ops allocated that are still
    alive, and their peak (a dispatch mode under the counter)."""

    def __init__(self):
        self.live = self.peak = 0

    def track(self, out, args) -> None:
        ins = {id(a) for a in args if isinstance(a, torch.Tensor)}
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor) or id(t) in ins \
                    or t._base is not None:
                continue
            nb = t.numel() * t.element_size()
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, nb)

    def _free(self, nb: int) -> None:
        self.live -= nb


class _MemoryCounter(CostCounter):
    def __init__(self):
        super().__init__()
        self.memory = _Live()

    def _count(self, func, args, kwargs, out) -> None:
        super()._count(func, args, kwargs, out)
        if not getattr(func, "is_view", False):
            self.memory.track(out, args)


def _local_bytes(tree) -> int:
    """Bytes of a tree's tensors, a DTensor's local shard for each."""
    total = 0
    for leaf in T.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = getattr(leaf, "_local_tensor", leaf)
            total += t.numel() * t.element_size()
    return total


def _placed(struct_tree, axes_tree, mesh, rules):
    """Fake tensors of the structs' shapes and dtypes, as DTensors laid out
    by their axes (whole fake tensors without a mesh)."""
    fakes = SP.map_axes(lambda _, s: torch.zeros(s.shape, dtype=s.dtype),
                        axes_tree, struct_tree)
    return fakes if mesh is None else SP.place(fakes, axes_tree, rules)


def lower_cell(arch: str, shape_name: Union[str, InputShape],
               multi_pod: bool, strategy: str = "tp+fsdp+sp",
               overrides=None, accum: int = 0, *, cfg=None,
               mesh_spec: Optional[Tuple[Sequence[int],
                                         Sequence[str]]] = None):
    """Returns a result dict for one cell (raises on tracing bugs).

    ``cfg`` replaces the registered config of ``arch`` and ``mesh_spec``
    (shape, axes) the production mesh, for small cells."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **{k: v for k, v in overrides.items()
                                          if hasattr(cfg, k)})
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    mesh_shape, mesh_axes = mesh_spec or production_mesh_spec(
        multi_pod=multi_pod)
    ranks = 1
    for n in mesh_shape:
        ranks *= n
    sizes = dict(zip(mesh_axes, mesh_shape))
    group = fake_group(ranks) if ranks > 1 else contextlib.nullcontext()

    t0 = time.time()
    with group, contextlib.ExitStack() as stack:
        mesh = (make_debug_mesh(tuple(mesh_shape), tuple(mesh_axes),
                                device="cpu") if ranks > 1 else None)
        stack.enter_context(FakeTensorMode())
        rules = make_rules(mesh if mesh is not None else sizes,
                           strategy=strategy)
        extra = {}
        if shape.kind == "train":
            accum = accum or SP.train_grad_accum(cfg, shape, sizes)
            tcfg = TS.TrainConfig(
                grad_accum=accum,
                adamw=adamw.AdamWConfig(
                    state_dtype=cfg.opt_state_dtype,
                    master_weights=(cfg.opt_state_dtype == "float32")))
            state_s, state_axes = SP.state_struct(cfg, tcfg)
            batch_s, batch_axes = SP.batch_struct(cfg, shape)
            state = _placed(state_s, state_axes, mesh, rules)
            state.step = torch.zeros((), dtype=torch.int32)
            batch = _placed(batch_s, batch_axes, mesh, rules)
            step = TS.make_train_step(cfg, tcfg)
            args, run = (state, batch), lambda: step(state, batch)
            aliased = state
            extra = {"grad_accum": accum}
        elif shape.kind == "prefill":
            params_s, axes = SP.params_struct(cfg)
            batch_s, batch_axes = SP.batch_struct(cfg, shape)
            params = _placed(params_s, axes, mesh, rules)
            batch = _placed(batch_s, batch_axes, mesh, rules)

            def run():
                logits, _ = M.forward(params, cfg, tokens=batch.get("tokens"),
                                      embeds=batch.get("embeds"),
                                      last_token_only=True)
                return _greedy(logits)

            args, aliased = (params, batch), None
        else:  # decode / long_decode: one new token against a full cache
            params_s, axes = SP.params_struct(cfg)
            params = _placed(params_s, axes, mesh, rules)
            B = shape.global_batch
            caches_s, cache_axes = SP.caches_struct(cfg, B, shape.seq_len)
            caches = _placed(caches_s, cache_axes, mesh, rules)
            toks_s = torch.empty(B, 1, dtype=torch.int64, device="meta")
            toks = _placed(toks_s, ("batch", None), mesh, rules)
            pos = torch.zeros((), dtype=torch.int64)

            def run():
                return serve_step(params, toks, caches, pos, cfg=cfg)

            args, aliased = (params, toks, caches), caches
        arg_bytes = _local_bytes(args)
        t_setup = time.time() - t0
        rules_ctx = use_rules(rules) if mesh is not None \
            else contextlib.nullcontext()
        with rules_ctx, _replication(mesh), _MemoryCounter() as counter:
            out = run()
        out_bytes = _local_bytes(out)
        alias_bytes = _local_bytes(aliased) if aliased is not None else 0
        t_trace = time.time() - t0 - t_setup

    analysis = counter.analysis()
    trace_s = round(t_trace, 1)
    return {
        "arch": arch, "shape": shape.name,
        "mesh": ("x".join(map(str, mesh_shape)) if mesh_spec
                 else _mesh_name(multi_pod)),
        "strategy": strategy, "status": "ok",
        "lower_s": trace_s, "compile_s": trace_s,
        "setup_s": round(t_setup, 1),
        "flops_per_device": analysis["flops"],
        "hbm_bytes_per_device": analysis["hbm_bytes"],
        "ops_per_device": analysis["ops"],
        "attn_sq_bytes": analysis["attn_sq_bytes"],
        "collectives": analysis["collectives"],
        "unknown_trip_whiles": analysis["unknown_trip_whiles"],
        "xla_cost_flops": analysis["flops"],
        "xla_cost_bytes": analysis["hbm_bytes"],
        "memory": {
            "argument_gb": arg_bytes / 1e9,
            "output_gb": out_bytes / 1e9,
            "temp_gb": counter.memory.peak / 1e9,
            "alias_gb": alias_bytes / 1e9,
        },
        **extra,
    }


def _replication(mesh):
    """DTensor ops may take plain tensors (positions, masks, scalars) as
    replicas."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def cell_key(r) -> str:
    return f"{r['arch']}|{r['shape']}|{r['mesh']}|{r['strategy']}"


def load_results(path):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path, results):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ALL_ARCHS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="tp+fsdp+sp")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_PATH))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--accum", type=int, default=0,
                    help="override gradient-accumulation steps (train cells)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ALL_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = load_results(args.out)
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            runnable, why = shape_applicable(cfg, SHAPES[shape_name])
            for mp in meshes:
                key = f"{arch}|{shape_name}|{_mesh_name(mp)}|{args.strategy}"
                if key in results and not args.force \
                        and results[key].get("status") in ("ok", "skip"):
                    print(f"[cached] {key}")
                    continue
                if not runnable:
                    results[key] = {
                        "arch": arch, "shape": shape_name,
                        "mesh": _mesh_name(mp), "strategy": args.strategy,
                        "status": "skip", "reason": why,
                    }
                    save_results(args.out, results)
                    print(f"[skip]   {key}: {why}")
                    continue
                print(f"[trace]  {key} ...", flush=True)
                try:
                    r = lower_cell(arch, shape_name, mp, args.strategy,
                                   accum=args.accum)
                    results[key] = r
                    print(f"[ok]     {key}: trace {r['compile_s']}s "
                          f"args {r['memory']['argument_gb']:.2f}GB "
                          f"temp {r['memory']['temp_gb']:.2f}GB", flush=True)
                except Exception as e:  # record the failure, keep sweeping
                    results[key] = {
                        "arch": arch, "shape": shape_name,
                        "mesh": _mesh_name(mp), "strategy": args.strategy,
                        "status": "error", "error": str(e)[:2000],
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    print(f"[FAIL]   {key}: {e}", flush=True)
                save_results(args.out, results)


if __name__ == "__main__":
    main()
