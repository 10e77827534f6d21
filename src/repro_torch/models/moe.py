"""Mixture-of-Experts layer of the port: top-k token-choice routing
(Mixtral, Arctic); the port of ``repro.models.moe``.

Two execution paths:

* ``dense`` — every expert computed for every token, gate-weighted
  (exact, O(E/k) compute overhead).  The path a model's forward runs.

* ``a2a`` — expert parallelism over the ``data`` axis of a grid of rank
  processes (``ExpertGrid``, over ``dist.ranks``) with explicit dispatch
  and combine through ``dist.collectives.TokenA2APlan``, and tensor
  parallelism over ``model`` inside each expert.  The reference runs the
  same rank program inside ``shard_map`` on a ``(data, model)`` mesh.

The a2a path runs in one of two expert-parallel modes (``cfg.ep_mode``,
overridable per call):

``ep_mode="replicated"``
    Tokens are replicated over ``model``; every model plane performs the
    identical dispatch all-to-all.  Collectives a layer: dispatch a2a
    (x |model| planes), expert-TP sum, combine a2a (x |model| planes).

``ep_mode="sp"``
    The sequence stays sharded over ``model``, so each model plane routes
    and all-to-alls only its own sequence shard (per-plane a2a volume /
    |model|).  The received rows are gathered over ``model`` so the
    f-sliced expert-TP sum adds partials of the same rows, each plane
    slices its own rows back out, and the combine a2a again moves only
    the plane's shard.  Falls back to ``replicated`` when the sequence
    length does not divide the ``model`` axis.

Virtual sub-experts: each expert is stored split into ``sub =
lcm(E, 16) / E`` f-slices (``virtual_experts``), the layout the
reference's 16-wide ``data`` axis needs.  A token routed to expert e goes
to all ``sub`` slices and their partial outputs are summed: numerically
the unsplit expert.

Router: softmax over E in float32, top-k, renormalised gates, the
load-balance aux loss (Switch) and the router z-loss.  Capacity drops are
deterministic in token order.

The expert products keep the reference's ``preferred_element_type=
float32``: the gate and up products, the down product and the weighted
sum stay in float32 and only ``h`` is rounded to the activation type
(``_bmm_f32``: ``torch.bmm(..., out_dtype=float32)`` on the card, one
expert at a time upcast on the CPU, whose build has no kernel for it).
Routing is capture-safe (a ``scatter_`` of the gates, no ``F.one_hot``,
which checks its indices on the host), and every sum is in a fixed order
(no atomics), so a replayed decode step gives an eager step's tokens.

Held experts (``cfg.experts_held = (lo, hi)``, one chip's expert-parallel
share): the layer stores experts ``lo..hi-1`` alone (unsplit, ``sub`` 1),
routes over all ``num_experts`` and adds, for each token, only its held
experts' gated outputs: a token routed to none of them gets nothing from
the routed experts.  The dense product runs over the held experts, with
zero gates where a pair was not routed here, so the shapes are fixed and
nothing is dropped.  Given ``held_pairs`` (an int64 tensor on the
device), the layer adds the (token, held expert) pairs it served to it,
with no host sync (the engine's ``moe.held_pairs``).
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, Optional, Tuple

import torch

from .. import tree as T
from ..dist.collectives import TokenA2APlan, dispatch_capacity
from ..dist.sharding import constrain
from .layers import _act, _dense_init, dtype_of, leaf

EP_MODES = ("replicated", "sp")
IMPLS = ("auto", "dense", "a2a")


def _sub_factor(E: int, ndata: int) -> int:
    return math.lcm(E, ndata) // E


def virtual_experts(num_experts: int, d_ff: int) -> Tuple[int, int, int]:
    """The stored expert layout ``(E_v, f_v, sub)`` of ``init_moe``."""
    sub = _sub_factor(num_experts, 16)
    if d_ff % sub:
        sub = 1
    return num_experts * sub, d_ff // sub, sub


def init_moe(gen, cfg, dtype, device, layers: Optional[int] = None,
             leaves: bool = False) -> Dict:
    """The float32 router ``(d, E)`` and the expert weights stored as
    ``E_v`` virtual experts: ``w_gate``/``w_up`` ``(E_v, d, f_v)``,
    ``w_down`` ``(E_v, f_v, d)`` (a leading layer dim with ``layers``);
    with ``cfg.experts_held``, the held experts alone, unsplit."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    held = getattr(cfg, "experts_held", None)
    E_v, f_v, _ = (virtual_experts(E, f) if held is None
                   else (held[1] - held[0], f, 1))
    lead = () if layers is None else (layers,)

    def dense(shape, fan_in, dt, axes):
        return leaf(_dense_init(gen, lead + shape, fan_in, dt, device),
                    axes, layers, leaves)

    return {
        "router": dense((d, E), d, torch.float32, (None, None)),
        "w_gate": dense((E_v, d, f_v), d, dtype,
                        ("expert", "expert_embed", "expert_ffn")),
        "w_up": dense((E_v, d, f_v), d, dtype,
                      ("expert", "expert_embed", "expert_ffn")),
        "w_down": dense((E_v, f_v, d), f, dtype,
                        ("expert", "expert_ffn", "expert_embed")),
    }


def _router(x2d: torch.Tensor, wr: torch.Tensor, E: int, k: int):
    """float32 routing -> (gates (N, k), top_idx (N, k), loss pieces).

    The loss pieces (load (E,), importance (E,), n, z_sum) are sums, so
    the a2a path can sum them over the ranks and form the exact global
    losses."""
    logits = x2d.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # the k indices of a row are distinct: a scatter is the one-hot sum
    load = torch.zeros_like(probs).scatter_(1, top_idx, 1.0).sum(0)
    importance = probs.sum(0)
    n = torch.full((), float(probs.shape[0]), dtype=torch.float32,
                   device=probs.device)
    z_sum = (torch.logsumexp(logits, dim=-1) ** 2).sum()
    return gates, top_idx, (load, importance, n, z_sum)


def _form_losses(pieces, E: int, k: int):
    load, importance, n, z_sum = pieces
    lb = E * torch.sum((load / (n * k)) * (importance / n))
    return lb, z_sum / n


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(E, M, K) @ (E, K, N) -> float32 (E, M, N): float32 accumulation,
    the products never rounded to the operands' type.  Differentiable:
    bf16 operands that need a gradient go through ``_BmmF32``."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _BmmF32.apply(a, b)
    return _bmm_f32_forward(a, b)


def _bmm_f32_forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type != "cpu":
        return torch.bmm(a, b, out_dtype=torch.float32)
    # the CPU build has no aten::bmm.dtype: one expert at a time
    out = torch.empty(a.shape[0], a.shape[1], b.shape[2],
                      dtype=torch.float32)
    for e in range(a.shape[0]):
        torch.mm(a[e].float(), b[e].float(), out=out[e])
    return out


class _BmmF32(torch.autograd.Function):
    """``_bmm_f32`` with the gradient of JAX's ``preferred_element_type=
    float32`` product: the float32 cotangent times the other operand
    upcast, in float32, rounded to the operand's type (``aten::bmm.dtype``
    has no derivative, and ``out=`` takes none)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32_forward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.transpose(1, 2).float()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.transpose(1, 2).float(), g).to(b.dtype)
        return ga, gb


def _ffn(blocks: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
         wd: torch.Tensor, act: str) -> torch.Tensor:
    """blocks (E_loc, C, d) -> (E_loc, C, d) partial outputs (f-sliced)."""
    g = _bmm_f32(blocks, wg)
    u = _bmm_f32(blocks, wu)
    h = _act(act, g).mul_(u).to(blocks.dtype)
    return _bmm_f32(h, wd).to(blocks.dtype)


def apply_moe(p: Dict, x: torch.Tensor, cfg, impl: str = "auto",
              ep_mode: Optional[str] = None,
              grid: Optional["ExpertGrid"] = None,
              held_pairs: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y, {"moe_lb_loss", "moe_z_loss"}).

    ``impl="auto"`` takes the a2a path when ``grid`` (an ``ExpertGrid``
    holding this layer's shards) is given, else the dense path: the
    port's counterpart of "no active sharding rules".  On the a2a path the
    ranks compute with the shards they hold, so ``p`` must be the layer
    the grid was built from (its fingerprint is checked on every call).
    ``ep_mode`` overrides ``cfg.ep_mode`` for the a2a path; ``None`` reads
    the config.  ``held_pairs``: the dense path's counter of the pairs its
    held experts serve (``cfg.experts_held``).
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}; known: {IMPLS}")
    if impl == "auto":
        impl = "dense" if grid is None else "a2a"
    if impl == "a2a":
        if grid is None:
            raise ValueError("the a2a path runs on a rank grid: pass "
                             "grid=ExpertGrid(...)")
        mode = ep_mode or getattr(cfg, "ep_mode", "replicated")
        if mode not in EP_MODES:
            raise ValueError(f"unknown ep_mode {mode!r}; known: {EP_MODES}")
        return _moe_a2a(p, x, cfg, grid, mode)
    return _moe_dense(p, x, cfg, held_pairs)


# ------------------------------------------------------------- dense path
def _moe_dense(p: Dict, x: torch.Tensor, cfg,
               held_pairs: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict]:
    B, S, d = x.shape
    x = constrain(x, "batch", "seq_full", None)
    y, lb, z = _dense_mix(p, x.reshape(B * S, d), cfg, held_pairs)
    y = constrain(y.reshape(B, S, d).to(x.dtype), "batch", "seq", None)
    return y, {"moe_lb_loss": lb, "moe_z_loss": z}


def _dense_mix(p: Dict, x2: torch.Tensor, cfg,
               held_pairs: Optional[torch.Tensor] = None):
    """x2 (N, d) -> (the gate-weighted sum of every (held) expert's output,
    (N, d) float32, before the cast to the activation type; lb loss; z
    loss).  With held experts, the pairs served are added to
    ``held_pairs`` where given."""
    N, d = x2.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gates, top_idx, pieces = _router(x2, p["router"], E, k)
    lb, z = _form_losses(pieces, E, k)
    w = torch.zeros(N, E, dtype=torch.float32, device=x2.device)
    w.scatter_(1, top_idx, gates)  # (N, E): each row's gates at its experts
    held = getattr(cfg, "experts_held", None)
    if held is not None:
        lo, hi = held
        w = w[:, lo:hi]  # zero where a pair was not routed here
        if held_pairs is not None:
            held_pairs.add_(((top_idx >= lo) & (top_idx < hi)).sum())
    E_h, E_v = w.shape[1], p["w_gate"].shape[0]
    sub = E_v // E_h

    xe = x2.expand(E_v, N, d)
    g = _bmm_f32(xe, p["w_gate"])
    u = _bmm_f32(xe, p["w_up"])
    h = _act(cfg.act, g).mul_(u).to(x2.dtype)
    del g, u
    y_v = _bmm_f32(h, p["w_down"])  # (E_v, N, d) float32
    y_e = y_v if sub == 1 else y_v.view(E_h, sub, N, d).sum(1)

    y = torch.bmm(w[:, None, :], y_e.transpose(0, 1))[:, 0]
    return y, lb, z


# --------------------------------------------------------------- a2a path
def _shard(p: Dict, data: int, model: int, r: int) -> Dict:
    """Rank r's shard of a layer: experts over ``data``, their f_v slices
    over ``model``, the router whole."""
    E_v, _, f_v = p["w_gate"].shape
    di, mi = divmod(r, model)
    e = slice(di * (E_v // data), (di + 1) * (E_v // data))
    f = slice(mi * (f_v // model), (mi + 1) * (f_v // model))
    # clones: a view would keep (and pickle) the whole layer's storage
    return {"router": p["router"].clone(),
            "w_gate": p["w_gate"][e, :, f].clone(),
            "w_up": p["w_up"][e, :, f].clone(),
            "w_down": p["w_down"][e, f, :].clone()}


def _fingerprint(p: Dict) -> Dict[str, int]:
    return {k: T.bits_sum(v) for k, v in sorted(p.items())}


def _rank_fingerprint(ctx, job: int) -> Dict[str, int]:
    return _fingerprint(ctx.jobs[job])


def _rank_hold(ctx, job: int, shard: Dict) -> None:
    ctx.jobs[job] = {k: v.to(ctx.device) for k, v in shard.items()}


def _rank_build(ctx, job: int, data: int, model: int, cfg, seed: int
                ) -> None:
    """Build the layer from ``seed`` on the rank's device and keep its
    shard (a full-width layer is too large to send through the pipes)."""
    gen = torch.Generator(ctx.device).manual_seed(int(seed))
    p = init_moe(gen, cfg, dtype_of(cfg), ctx.device)
    ctx.jobs[job] = _shard(p, data, model, ctx.rank)
    del p
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


class ExpertGrid:
    """A ``(data, model)`` grid of a pool's rank processes holding one MoE
    layer, each rank its shard: rank ``r`` at ``(r // model, r % model)``
    keeps the stored experts ``E_v / data`` of its data index, their
    ``f_v / model`` slice of its model index, and the router whole (what
    the reference's ``in_specs`` give each device).

    The shards come from ``params`` (sliced here and sent to the ranks:
    for small layers) or, with ``cfg`` and ``seed``, each rank builds the
    layer from the seed on its own device (``init_moe``; the same seed
    and device type give the controller the same layer) and keeps its
    shard.  ``stats`` holds each rank's communication in the last call:
    the bytes its ``data``-axis all-to-alls moved (``a2a_bytes``) and its
    ``model``-axis ops.  ``fingerprint`` is the layer that the ranks hold,
    as ``_fingerprint`` gives it (the router from any rank, which all hold
    it whole; the expert weights summed over the ranks' shards), against
    which ``apply_moe`` checks the layer it is given.
    """

    def __init__(self, pool, data: int, model: int,
                 params: Optional[Dict] = None, *, cfg=None,
                 seed: Optional[int] = None):
        if data * model != pool.ranks:
            raise ValueError(f"a ({data}, {model}) grid needs "
                             f"{data * model} ranks, the pool has "
                             f"{pool.ranks}")
        if (params is None) == (seed is None):
            raise ValueError("give the layer's params, or its cfg and seed")
        if params is not None:
            shape = tuple(params["w_gate"].shape)
        else:
            E_v, f_v, _ = virtual_experts(cfg.num_experts, cfg.d_ff)
            shape = (E_v, cfg.d_model, f_v)
        if shape[0] % data or shape[2] % model:
            raise ValueError(f"experts {shape[0]} and width {shape[2]} do "
                             f"not shard over a ({data}, {model}) grid")
        self.pool, self.data, self.model, self.shape = pool, data, model, \
            shape
        self.job = pool.new_job()
        weakref.finalize(self, pool.drop_job, self.job)
        if params is not None:
            pool.map(_rank_hold, [
                (self.job, {k: v.detach().cpu() for k, v in
                            _shard(params, data, model, r).items()})
                for r in range(pool.ranks)])
        else:
            pool.call(_rank_build, self.job, data, model, cfg, seed)
        held = pool.call(_rank_fingerprint, self.job)
        if any(h["router"] != held[0]["router"] for h in held):
            raise RuntimeError("the ranks hold different routers")
        self.fingerprint = {k: (held[0][k] if k == "router" else
                                sum(h[k] for h in held)) for k in held[0]}
        self.stats = []

    def coords(self, r: int) -> Tuple[int, int]:
        return divmod(r, self.model)


def _psum(t: torch.Tensor, comm, tag: int) -> torch.Tensor:
    """Sum ``t`` over ``comm``'s ranks, in float32, in ``t``'s type."""
    if comm.size == 1:
        return t
    return comm.all_reduce(t.float().contiguous(), tag).wait().to(t.dtype)


def _a2a_local(x: torch.Tensor, p: Dict, cfg, comms, sp: bool):
    """One rank's part of the a2a path (``moe_local`` of the reference):
    x (b_loc, s_loc, d), its shard p, its grid communicators."""
    b_loc, s_loc, d = x.shape
    n_loc = b_loc * s_loc
    ndata, nmodel = comms.data.size, comms.model.size
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    E_loc = p["w_gate"].shape[0]  # virtual experts on this data rank
    sub = E_loc * ndata // E
    factor = cfg.moe_capacity_factor
    cap = dispatch_capacity(n_loc * k * sub, ndata, factor)
    plan = TokenA2APlan(ndev=ndata, cap=cap)
    dev = x.device

    x2 = x.reshape(n_loc, d)
    gates, top_idx, pieces = _router(x2, p["router"], E, k)
    # exact global losses: sum the sufficient statistics over every rank,
    # then form them (tokens counted on several ranks cancel in the ratios)
    flat = torch.cat([pieces[0], pieces[1], pieces[2].reshape(1),
                      pieces[3].reshape(1)])
    flat = _psum(flat, comms.world, tag=10)
    lb, z = _form_losses((flat[:E], flat[E:2 * E], flat[2 * E],
                          flat[2 * E + 1]), E, k)

    # expand to virtual sub-expert sends: (n, k, sub) -> flat M
    ev = (top_idx[:, :, None] * sub
          + torch.arange(sub, device=dev)[None, None, :]).reshape(-1)
    gts = gates.reshape(-1).repeat_interleave(sub)
    tok = torch.arange(n_loc, device=dev).repeat_interleave(k * sub)
    dest = ev // E_loc
    ev_local = (ev % E_loc).to(torch.int32)  # 4 bytes an id on the wire
    slot, keep = plan.route(dest)

    rx = plan.dispatch(dest, slot, x2[tok], comms.data, tag=0)
    re = plan.dispatch(dest, slot, ev_local, comms.data, tag=1, fill=-1)
    if sp:
        # each plane dispatched only its own sequence shard; gather the
        # planes' rows so the expert-TP sum adds partials of the same rows
        rx = comms.model.all_gather(rx, tag=2).wait()
        re = comms.model.all_gather(re, tag=3).wait()
    R = re.shape[0]
    valid = re >= 0
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]

    if E_loc == 1:
        part = _psum(_ffn(rx[None], wg, wu, wd, cfg.act), comms.model, 11)
        out_rows = part[0] * valid[:, None].to(part.dtype)
    else:
        cap_e = max(8, int(math.ceil(factor * R / E_loc / 8.0) * 8))
        e_safe = re.clamp(0, E_loc - 1).long()
        oh = torch.zeros(R, E_loc, dtype=torch.int64, device=dev)
        oh.scatter_(1, e_safe[:, None], valid[:, None].long())
        pos = torch.cumsum(oh, dim=0) - oh
        pos = (pos * oh).sum(-1)
        ok = valid & (pos < cap_e)
        pos_c = torch.where(ok, pos, cap_e)
        buf = torch.zeros(E_loc, cap_e + 1, d, dtype=x.dtype, device=dev)
        buf[e_safe, pos_c] = rx  # dropped rows land on the overflow slot
        part = _psum(_ffn(buf[:, :cap_e], wg, wu, wd, cfg.act),
                     comms.model, 11)
        out_rows = part[e_safe, pos_c.clamp(0, cap_e - 1)]
        out_rows = out_rows * ok[:, None].to(out_rows.dtype)

    if sp:
        # every plane holds the outputs of all planes' rows; keep its own
        out_rows = out_rows.reshape(nmodel, ndata * cap, d)[comms.model.rank]

    got = plan.combine(out_rows, dest, slot, comms.data, tag=4)
    got = got.float() * keep[:, None].float() * gts[:, None]
    # segment_sum over tok = repeat(arange(n), k * sub): contiguous runs
    y2 = got.reshape(n_loc, k * sub, d).sum(1)
    return y2.reshape(b_loc, s_loc, d).to(x.dtype), lb, z


def _rank_a2a(ctx, job: int, x: torch.Tensor, cfg, data: int, model: int,
              sp: bool):
    comms = ctx.comm.grid(data, model)
    comms.data.reset_stats()
    comms.model.reset_stats()
    y, lb, z = _a2a_local(x.to(ctx.device), ctx.jobs[job], cfg, comms, sp)
    return (y.cpu(), float(lb), float(z),
            {"data": dict(comms.data.stats), "model": dict(comms.model.stats)})


def rank_blocks(B: int, S: int, data: int, model: int, ep_mode: str):
    """(sp, batch split, block(r)): whether the sp mode runs, over how many
    data ranks the batch splits, and rank r's (batch, sequence) slices of
    x.  The divisibility fallbacks: sp needs the sequence to shard over
    model, and the batch stays whole on every data rank unless it
    shards."""
    sp = ep_mode == "sp" and S % model == 0
    b_split = data if B % data == 0 else 1
    b_loc, s_loc = B // b_split, (S // model if sp else S)

    def block(r: int):
        di, mi = divmod(r, model)
        bi, si = (di if b_split > 1 else 0), (mi if sp else 0)
        return (slice(bi * b_loc, (bi + 1) * b_loc),
                slice(si * s_loc, (si + 1) * s_loc))

    return sp, b_split, block


def _moe_a2a(p: Dict, x: torch.Tensor, cfg, grid: ExpertGrid,
             ep_mode: str) -> Tuple[torch.Tensor, Dict]:
    """The controller's half: hand each rank its slice of x (batch over
    ``data`` when it divides, sequence over ``model`` in ``sp`` mode, as
    the reference's ``in_specs``), run the ranks, put y together."""
    if tuple(p["w_gate"].shape) != grid.shape:
        raise ValueError(f"the grid holds experts of shape {grid.shape}, "
                         f"the layer's are {tuple(p['w_gate'].shape)}")
    if _fingerprint(p) != grid.fingerprint:
        raise ValueError("the grid holds another layer than the one given "
                         "(another seed, or weights changed since the grid "
                         "was built): its ranks would compute with theirs")
    B, S, d = x.shape
    sp, b_split, block = rank_blocks(B, S, grid.data, grid.model, ep_mode)
    ranks = range(grid.pool.ranks)
    res = grid.pool.map(_rank_a2a, [
        (grid.job, x[block(r)].detach().cpu().clone(), cfg, grid.data, grid.model,
         sp) for r in ranks])
    y = torch.empty_like(x)
    for r in ranks:
        di, mi = grid.coords(r)
        # a block held on several ranks (replicated over model, or a batch
        # that stays whole) is taken from its first rank
        if (b_split > 1 or di == 0) and (sp or mi == 0):
            y[block(r)] = res[r][0].to(x.device)
    grid.stats = [r[3] for r in res]
    lb, z = res[0][1], res[0][2]
    return y, {"moe_lb_loss": torch.tensor(lb, device=x.device),
               "moe_z_loss": torch.tensor(z, device=x.device)}
