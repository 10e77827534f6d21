"""The ``moe_dispatch`` scenario of the port: MoE dispatch comm volume as
a roofline (the port of ``repro.bench.moe``).

Not a task-graph scenario — the "graph" is one MoE layer's token dispatch.
The analytic path is pure host arithmetic: the per-rank all-to-all bytes
from the same capacity math the a2a path uses
(``dist.collectives.dispatch_capacity``), scored against the interconnect
roofline ``LINK_BW``.  Its measured counterparts are the bytes that the
ranks' ``all_to_all`` moves in ``models.moe``'s a2a path
(``ExpertGrid.stats``, held equal to it by
``tests/test_torch_moe_a2a.py``), and the *compiled* path:
``lowered_moe_program`` is rank 0's program of the a2a path
(``models.moe._a2a_local``) on a fake ``(data, model)`` process group,
which ``launch.roofline``'s counter runs once, counting the collective
bytes of every ``RankComm`` exchange at dispatch.

The point of the scenario: SP-aware expert parallelism (``ep_mode="sp"``)
cuts per-plane dispatch volume by |model| versus token replication —
``report(spec_sp)["a2a_bytes"] * |model| == report(spec_rep)["a2a_bytes"]``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

from ..launch.roofline import LINK_BW

SCENARIO_NAME = "moe_dispatch"


@dataclass(frozen=True)
class MoEDispatchSpec:
    """One cell of the MoE dispatch measurement space."""

    arch: str = "mixtral-8x7b"
    batch: int = 8
    seq: int = 32
    data: int = 4            # EP group size (the grid's `data` axis)
    model: int = 2           # TP/SP plane count (the grid's `model` axis)
    ep_mode: str = "replicated"
    capacity_factor: float = 8.0
    dtype_bytes: int = 4     # activation dtype (f32 smoke default)

    @property
    def name(self) -> str:
        return f"{SCENARIO_NAME}.{self.arch}.{self.ep_mode}"

    def config(self):
        """The reduced arch config with this spec's MoE knobs applied."""
        from ..configs import get_config, reduced

        return dataclasses.replace(
            reduced(get_config(self.arch)),
            moe_capacity_factor=self.capacity_factor,
            ep_mode=self.ep_mode,
        )


def analytic_a2a_bytes(spec: MoEDispatchSpec,
                       cfg=None) -> Dict[str, float]:
    """Per-(data, model)-rank dispatch+combine all-to-all bytes, from the
    exact capacity math ``models.moe``'s a2a path uses.  Token rows move
    as ``dtype_bytes``-wide activations plus one int32 expert id per row
    on the dispatch leg.  ``cfg`` is the layer's config (its experts,
    width and ``d_model``); by default ``spec.config()``, the reduced
    arch."""
    from ..dist.collectives import dispatch_capacity
    from ..launch.mesh import moe_dispatch_planes
    from ..models.moe import virtual_experts

    cfg = spec.config() if cfg is None else cfg
    _, _, sub = virtual_experts(cfg.num_experts, cfg.d_ff)
    # the a2a path's divisibility fallbacks: an sp request runs as
    # replicated when the sequence does not shard over `model`, and the
    # batch stays whole on every data rank when it does not divide `data`
    eff_mode = spec.ep_mode
    if eff_mode == "sp" and spec.seq % spec.model:
        eff_mode = "replicated"
    planes = moe_dispatch_planes(
        {"data": spec.data, "model": spec.model}, eff_mode)
    # tokens per rank: batch over `data`; seq over `model` when SP-aware,
    # replicated otherwise
    seq_shard = spec.model if eff_mode == "sp" else 1
    b_shard = spec.data if spec.batch % spec.data == 0 else 1
    n_loc = (spec.batch // b_shard) * (spec.seq // seq_shard)
    sends = n_loc * cfg.num_experts_per_tok * sub
    cap = dispatch_capacity(sends, spec.data, spec.capacity_factor)
    d = cfg.d_model
    rows = spec.data * cap
    dispatch = rows * (d * spec.dtype_bytes + 4)  # activations + expert ids
    combine = rows * d * spec.dtype_bytes
    return {
        "cap": float(cap),
        "rows_per_rank": float(rows),
        # 1.0 when the SP reduction is actually in effect (a spec with
        # seq % model != 0 runs — and is modelled — as replicated)
        "sp_effective": float(eff_mode == "sp"),
        "a2a_bytes": float(dispatch + combine),   # per plane, per layer
        "dispatch_planes": float(planes),         # identical a2a copies
        # volume summed over the |model| planes (sp planes move distinct
        # 1/|model| shards; replicated planes move |model| copies)
        "a2a_bytes_all_planes": float((dispatch + combine) * spec.model),
    }


def lowered_moe_program(spec: MoEDispatchSpec):
    """Rank 0's program of one MoE layer's a2a path on a ``(data, model)``
    grid, as a zero-arg callable: the layer is built from seed 0 on the
    CPU and rank 0 keeps its shard and its block of a zero input; a call
    starts a fake process group of ``data * model`` ranks and runs the
    rank's ``_a2a_local`` on it (its exchanges are issued and move
    nothing)."""
    import torch

    from ..dist.ranks import DEFAULT_TIMEOUT_S, RankComm
    from ..launch.dryrun import fake_group
    from ..models import moe as MO
    from ..models.layers import dtype_of

    cfg = spec.config()
    ranks = spec.data * spec.model
    p = MO.init_moe(torch.Generator().manual_seed(0), cfg, dtype_of(cfg),
                    "cpu")
    x = torch.zeros(spec.batch, spec.seq, cfg.d_model)
    sp, _, block = MO.rank_blocks(spec.batch, spec.seq, spec.data,
                                  spec.model, spec.ep_mode)
    shard, xb = MO._shard(p, spec.data, spec.model, 0), x[block(0)].clone()

    def run():
        with fake_group(ranks):
            comms = RankComm(0, ranks, torch.device("cpu"),
                             DEFAULT_TIMEOUT_S).grid(spec.data, spec.model)
            return MO._a2a_local(xb, shard, cfg, comms, sp)

    return run


def moe_dispatch_report(spec: MoEDispatchSpec,
                        compiled: bool = False) -> Dict[str, float]:
    """The scenario's measurements: analytic a2a bytes (always) plus the
    compiled program's collective bytes (rank 0's, counted at dispatch by
    ``launch.roofline``) when ``compiled``."""
    out = dict(analytic_a2a_bytes(spec))
    out["a2a_roofline_s"] = out["a2a_bytes"] / LINK_BW
    if compiled:
        from ..launch.roofline import count_program

        _, a = count_program(lowered_moe_program(spec))
        colls = a["collectives"]
        out["hlo_a2a_bytes"] = float(colls.get("all-to-all", 0.0))
        out["hlo_allgather_bytes"] = float(colls.get("all-gather", 0.0))
        out["hlo_collective_bytes"] = float(colls.get("total", 0.0))
    return out
