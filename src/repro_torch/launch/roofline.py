"""Roofline analysis of a traced step (the port of ``repro.launch.roofline``).

Three terms per (arch x shape x mesh), all in seconds, at the NVIDIA H100
SXM's rates:

  compute    = per-device matmul FLOPs / PEAK_FLOPS (the bf16 tensor-core
               peak: SMs x 4096 FLOP a clock x the max SM clock)
  memory     = per-device HBM bytes / HBM_BW (3.35 TB/s, data sheet)
  collective = per-device collective bytes / LINK_BW (one direction of
               NVLink 4: 900 GB/s both ways together, data sheet)

The reference walks the optimized HLO of a compiled program.  The port
has no compiler between the model and the device, so ``CostCounter``
counts the aten ops one traced step dispatches (a ``TorchDispatchMode``;
run it under ``FakeTensorMode`` and a fake process group and the step
allocates nothing), with the reference's conventions:

  * FLOPs: matmuls and convolutions only (``torch.utils.flop_counter``'s
    formulas), counted on each rank's local shards.  Under DTensor the
    counter defers every op on DTensors to DTensor's dispatch and counts
    the local ops it issues; the global-shape ops DTensor runs to infer
    output shapes are not counted (``FlopCounterMode`` counts both).
  * HBM bytes: each dispatched op's operand and result bytes (views and
    factories of empty tensors excepted).  This counts every op as its
    own pass over memory, with no fusion, so it reads higher than the
    reference's count of an XLA program's fusions: the port's own measure,
    not held equal to the reference's.
  * Collective bytes, per device: all-gather, all-to-all and permute
    (point-to-point receives) = result bytes; all-reduce = 2x result;
    reduce-scatter = operand bytes.  Seen at dispatch: the functional
    collectives DTensor issues and the c10d ops of ``dist.ranks.RankComm``
    (every exchange of ``dist/collectives.py``).
  * The hand-written kernels K1-K7 charge their declared cost
    (``kernels/_cost.py``) wherever the kernel or its plain version runs,
    and their plain version's ops are not counted; their elementwise
    operations go to ``ops`` (at PEAK_FP32).

Also reported: MODEL_FLOPS = 6*N_active*D and its ratio to the counted
FLOPs — the "useful compute" fraction exposing remat/redundancy waste.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# -------------------------------------------------- hardware constants
SMS = 132                  # H100 SXM
MAX_SM_CLOCK_HZ = 1.98e9   # its max SM clock (nvidia-smi clocks.max.sm)
PEAK_FLOPS = SMS * 4096 * MAX_SM_CLOCK_HZ   # bf16 tensor-core FLOP/s
PEAK_FP32 = SMS * 128 * 2 * MAX_SM_CLOCK_HZ  # fp32 FMA lanes, FLOP/s
HBM_BW = 3.35e12           # bytes/s, data sheet
LINK_BW = 450e9            # bytes/s, one direction of NVLink 4

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name -> (kind, its result, the bytes it is charged): functional
# collectives return their result; c10d ops write into output arguments
def _out(args, out):
    return out


def _arg(i):
    return lambda args, out: args[i]


_COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", _out, 1),
    "_c10d_functional::all_gather_into_tensor_coalesced":
        ("all-gather", _out, 1),
    "_c10d_functional::all_reduce": ("all-reduce", _out, 2),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", _out, 2),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", _out, 0),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", _out, 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", _out, 1),
    "c10d::allgather_": ("all-gather", _arg(0), 1),
    "c10d::_allgather_base_": ("all-gather", _arg(0), 1),
    "c10d::allreduce_": ("all-reduce", _arg(0), 2),
    "c10d::reduce_scatter_": ("reduce-scatter", _arg(0), 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", _arg(0), 0),
    "c10d::alltoall_base_": ("all-to-all", _arg(0), 1),
    "c10d::alltoall_": ("all-to-all", _arg(0), 1),
    "c10d::recv_": ("collective-permute", _arg(0), 1),
}
# a reduce-scatter (scale 0 above) is charged its operand: the functional
# op's first argument, the c10d ops' second
_RS_OPERAND = {"_c10d_functional::reduce_scatter_tensor": 0,
               "_c10d_functional::reduce_scatter_tensor_coalesced": 0,
               "c10d::reduce_scatter_": 1, "c10d::_reduce_scatter_base_": 1}
_SILENT = {"_c10d_functional::wait_tensor", "c10d::send", "prim::device",
           "aten::detach", "aten::alias", "aten::lift_fresh",
           "aten::empty", "aten::empty_like", "aten::empty_strided",
           "aten::_local_scalar_dense", "aten::set_"}


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _is_attn_quadratic(shape) -> bool:
    """rank>=3 tensor containing two equal dims >= 1024 — the (B, H, S, S)
    logits/probs family, which a flash-attention kernel keeps on chip;
    their traffic is reported separately."""
    if len(shape) < 3:
        return False
    big = [d for d in shape if d >= 1024]
    return any(big.count(d) >= 2 for d in set(big))


_ACTIVE: List["CostCounter"] = []


def active_counter() -> Optional["CostCounter"]:
    """The innermost counter in effect, unless it is paused."""
    if _ACTIVE and not _ACTIVE[-1].is_paused:
        return _ACTIVE[-1]
    return None


class CostCounter(TorchDispatchMode):
    """Counts one traced step's per-device cost (see the module doc).

    ``with CostCounter() as c: step(...)`` then ``c.analysis()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.attn_sq_bytes = 0.0
        self.ops = 0.0
        self.collectives: Dict[str, float] = {}
        self.is_paused = False
        self._patched = None

    # -- the kernels' declared costs -----------------------------------
    def charge(self, cost) -> None:
        if self.is_paused:
            return
        self.flops += float(cost.flops)
        self.hbm_bytes += float(cost.bytes)
        self.ops += float(cost.ops)

    @contextlib.contextmanager
    def paused(self):
        was, self.is_paused = self.is_paused, True
        try:
            yield
        finally:
            self.is_paused = was

    # -- dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(args, kwargs):
            return NotImplemented  # DTensor dispatches its local ops here
        out = func(*args, **kwargs)
        if not self.is_paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.name().split(".")[0]
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            kind, result, scale = coll
            res = _bytes(result(args, out))
            nb = (scale * res if scale else
                  _bytes(args[_RS_OPERAND[name]]))
            self.collectives[kind] = self.collectives.get(kind, 0.0) + nb
            self.hbm_bytes += res
            return
        if name in _SILENT or getattr(func, "is_view", False):
            return
        packet = func._overloadpacket
        from torch.utils.flop_counter import flop_registry

        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        tensors = [t for t in tree_leaves((args, kwargs, out))
                   if isinstance(t, torch.Tensor)]
        nb = sum(t.numel() * t.element_size() for t in tensors)
        self.hbm_bytes += nb
        if any(_is_attn_quadratic(tuple(t.shape)) for t in tensors):
            self.attn_sq_bytes += nb

    # -- the context ---------------------------------------------------
    def __enter__(self):
        self._patch_dtensor()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            if self._patched is not None:
                cls, attr, orig = self._patched
                setattr(cls, attr, orig)
                self._patched = None

    def _patch_dtensor(self) -> None:
        """Pause the count while DTensor infers an op's output shape by
        running it on global-shape fake tensors (not a device's work)."""
        try:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
        except ImportError:  # no DTensor in this build: nothing to hide
            return
        for attr in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            orig = ShardingPropagator.__dict__.get(attr)
            if orig is not None:
                break
        else:
            return
        counter = self

        def hidden(*a, **kw):
            with counter.paused():
                return orig(*a, **kw)

        setattr(ShardingPropagator, attr, hidden)
        self._patched = (ShardingPropagator, attr, orig)

    def analysis(self) -> Dict:
        """{flops, hbm_bytes, attn_sq_bytes, ops, collectives{kind: bytes,
        total}, unknown_trip_whiles} per device (the last is always 0: a
        traced step runs every loop)."""
        colls = dict(self.collectives)
        colls["total"] = float(sum(self.collectives.values()))
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "attn_sq_bytes": self.attn_sq_bytes, "ops": self.ops,
                "collectives": colls, "unknown_trip_whiles": 0}


def _has_dtensor(args, kwargs) -> bool:
    cls = _dtensor_class()
    return cls is not None and any(isinstance(a, cls)
                                   for a in tree_leaves((args, kwargs)))


_DTENSOR = []


def _dtensor_class():
    if not _DTENSOR:
        try:
            from torch.distributed.tensor import DTensor
        except ImportError:
            DTensor = None
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def count_program(fn, *args, **kwargs):
    """(fn's result, the counter's analysis) of one call of ``fn``."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.analysis()


def step_seconds(a: Dict) -> float:
    """One program's binding term: the largest of its matmul FLOPs at
    PEAK_FLOPS, its elementwise operations at PEAK_FP32, its HBM bytes at
    HBM_BW and its collective bytes at LINK_BW."""
    return max(a["flops"] / PEAK_FLOPS, a.get("ops", 0.0) / PEAK_FP32,
               a["hbm_bytes"] / HBM_BW, a["collectives"]["total"] / LINK_BW)


# ------------------------------------------------------------- terms
def model_flops(cfg, shape) -> float:
    """Useful model FLOPs for the step: 6*N_active*tokens (train),
    2*N_active*tokens (prefill), 2*N_active*batch (decode)."""
    n_active = cfg.params_active
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def model_bytes(cfg, shape) -> float:
    """Useful HBM traffic for one decode step: every active parameter is
    read once (weights dominate batched decode) plus the KV/state cache."""
    param_bytes = 2.0 * cfg.params_active  # bf16
    cache = 0.0
    for kind in cfg.pattern_for_depth():
        if kind in ("attn", "moe"):
            w = cfg.window or shape.seq_len
        elif kind == "local_attn":
            w = cfg.local_window or shape.seq_len
        elif kind == "ssd":
            d_in = cfg.ssm_expand * cfg.d_model
            cache += (d_in // cfg.ssm_headdim) * cfg.ssm_headdim \
                * cfg.ssm_state * 4.0 * shape.global_batch
            continue
        elif kind == "rglru":
            cache += (cfg.lru_width or cfg.d_model) * 4.0 * shape.global_batch
            continue
        else:
            continue
        w = min(w, shape.seq_len)
        cache += (2 * w * cfg.num_kv_heads * cfg.head_dim * 2.0
                  * shape.global_batch)
    return param_bytes + cache


def roofline_terms(analysis: Dict, cfg, shape, chips: int) -> Dict:
    flops_dev = float(analysis.get("flops", 0.0))
    bytes_dev = float(analysis.get("hbm_bytes", 0.0))
    coll_dev = float(analysis.get("collectives", {}).get("total", 0.0))
    attn_sq = float(analysis.get("attn_sq_bytes", 0.0))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    # K5 keeps the (B,H,S,S) logits family on chip; where the trace ran
    # an unfused attention (the oracle on a cache's cursor), its quadratic
    # traffic is removed from the memory term (raw value still reported
    # as memory_s_raw)
    memory_flash_s = max(bytes_dev - attn_sq, 0.0) / HBM_BW
    coll_s = coll_dev / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_flash_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_total = flops_dev * chips
    bound = max(terms.values())
    out = {
        **terms,
        "memory_s_raw": memory_s,
        "attn_sq_bytes": attn_sq,
        "dominant": dom,
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_ratio": (mf / hlo_total) if hlo_total else 0.0,
        "bound_step_s": bound,
        # fraction of the machine's peak the useful FLOPs achieve when the
        # step runs at its binding roofline term
        "roofline_fraction": (mf / bound / (chips * PEAK_FLOPS)
                              if bound > 0 else 0.0),
    }
    if shape.kind in ("decode", "long_decode"):
        # decode is bandwidth-limited by construction: score useful HBM
        # traffic (weights + cache, read once) against the machine's HBM
        ub = model_bytes(cfg, shape)
        out["useful_bytes"] = ub
        out["bw_fraction"] = (ub / bound / (chips * HBM_BW)
                              if bound > 0 else 0.0)
        out["roofline_fraction"] = out["bw_fraction"]
    return out
