"""Pipeline parallelism mapped onto the paper's *sweep* dependence pattern
(the port of ``repro.dist.pipeline``).

A pipeline schedule over S stages and M microbatches is a sweep task graph
(paper Table 2): task ``(t, s)``, clock tick t and stage s, depends on
``(t-1, s-1)`` (the activation arriving from the previous stage) and
``(t-1, s)`` (the stage's own previous microbatch, the in-order
constraint).  ``pp_schedule`` returns that graph; ``pp_forward`` executes
it wavefront by wavefront, so the order is the one a pipelined runtime
realizes, and the logits are ``models.model.forward``'s to the rounding of
the batch split.

Stages slice the stacked homogeneous block stack: stage ``s`` owns layers
``[s L/S, (s+1) L/S)``.  Stage 0 also embeds the tokens; the last stage
feeds the final norm and the unembedding.  The forward is differentiable
(``pp_loss_fn`` under ``torch.autograd``; on the card K5 runs as its
autograd function).  As in the reference, the blocks run without remat.

Under the logical-axis rules of ``dist/sharding.py`` on a mesh with a
``stage`` axis, ``constrain_stage_stack`` places the stage dim of the
stacked blocks on that axis (each stage's weights on its own mesh plane),
and the embeddings and logits take their rules' layouts, as in the
reference; outside rules every stage runs on the one device that holds
the parameters.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import tree as T
from ..core.graph import TaskGraph, make_graph
from .sharding import constrain
from ..models import layers as L
from ..models import model as M


def pp_schedule(num_stages: int, num_micro: int) -> TaskGraph:
    """The pipeline schedule as a sweep task graph: width = stages, height
    = micro + stages - 1 clock ticks (fill, steady state, drain);
    microbatch ``m`` runs on stage ``s`` at tick ``t = m + s``."""
    return make_graph(width=num_stages, height=num_micro + num_stages - 1,
                      pattern="sweep", iterations=1)


def stack_params_by_stage(params: Dict, num_stages: int) -> Dict:
    """The stacked ``(L, ...)`` blocks as ``(stages, L / stages, ...)``
    views; the other entries as they are."""
    if "blocks_scanned" not in params:
        raise ValueError(
            "pipeline parallelism requires a scanned homogeneous block stack")
    blocks = params["blocks_scanned"]
    depth = T.leaves(blocks)[0].shape[0]
    if depth % num_stages:
        raise ValueError(f"{depth} layers not divisible by {num_stages} "
                         f"stages")
    out = {k: v for k, v in params.items() if k != "blocks_scanned"}
    out["blocks_scanned"] = T.tree_map(
        lambda x: x.reshape((num_stages, depth // num_stages) + x.shape[1:]),
        blocks)
    return out


def constrain_stage_stack(pp_params: Dict) -> Dict:
    """Pin the stage-stacked blocks to the ``stage`` mesh axis.

    Under a 4D ``(pod, data, model, stage)`` rules context the leading
    (stage) dim of every stacked block leaf is sharded over ``stage``, so
    each pipeline stage's weights live on its own mesh plane and only the
    activations move stage to stage.  Identity outside a rules context;
    on meshes without a ``stage`` axis the stage dim stays whole.
    """
    if "blocks_scanned" not in pp_params:
        return pp_params
    out = {k: v for k, v in pp_params.items() if k != "blocks_scanned"}
    out["blocks_scanned"] = T.tree_map(
        lambda x: constrain(x, "stage", *([None] * (x.ndim - 1))),
        pp_params["blocks_scanned"])
    return out


def _run_stage(pp_params: Dict, stage: int, h: torch.Tensor, cfg,
               positions: torch.Tensor):
    """-> (h', the stage's MoE aux (lb, z) summed over its layers)."""
    kind = cfg.pattern_for_depth()[0]
    blocks = T.tree_map(lambda x: x[stage], pp_params["blocks_scanned"])
    depth = T.leaves(blocks)[0].shape[0]
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    zl = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(depth):
        h, _, aux = M._block(T.tree_map(lambda x: x[i], blocks), kind, h, cfg,
                             positions)
        if aux is not None:
            lb, zl = lb + aux[0], zl + aux[1]
    return h, (lb, zl)


def _pp_forward_with_aux(pp_params: Dict, cfg, tokens: torch.Tensor,
                         num_stages: int, num_micro: int):
    """Pipelined forward -> (logits, aux).  The MoE aux losses sum over the
    layers and average over the microbatches (router statistics are a
    microbatch's under pipelining, as under gradient accumulation)."""
    B, S = tokens.shape
    if B % num_micro:
        raise ValueError(f"batch {B} not divisible by {num_micro} "
                         f"microbatches")
    pp_params = constrain_stage_stack(pp_params)
    mb = B // num_micro
    dev = T.leaves(pp_params["embed"])[0].device
    positions = torch.arange(S, device=dev)[None, :].expand(mb, S)

    sched = pp_schedule(num_stages, num_micro)
    acts: Dict[Tuple[int, int], torch.Tensor] = {}  # (stage, micro) -> h
    outs = [None] * num_micro
    lb = torch.zeros((), dtype=torch.float32, device=dev)
    zl = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(sched.height):  # the wavefront clock
        for s in range(num_stages):
            m = t - s
            if not 0 <= m < num_micro:
                continue
            if s == 0:
                h = L.apply_embedding(pp_params["embed"],
                                      tokens[m * mb:(m + 1) * mb])
                h = constrain(h, "batch", "seq", None)
            else:
                h = acts.pop((s - 1, m))
            h, (lb_i, zl_i) = _run_stage(pp_params, s, h, cfg, positions)
            lb, zl = lb + lb_i, zl + zl_i
            if s == num_stages - 1:
                outs[m] = h
            else:
                acts[(s, m)] = h

    h = torch.cat(outs, dim=0)
    h = L.seq_full(L.apply_norm(pp_params["final_norm"], h, cfg.norm,
                                cfg.norm_eps))
    head = pp_params["embed"] if cfg.tie_embeddings else pp_params["head"]
    logits = constrain(L.apply_unembed(head, h), "batch", "seq", "vocab_out")
    inv = 1.0 / num_micro
    return logits, {"moe_lb_loss": lb * inv, "moe_z_loss": zl * inv}


def pp_forward(pp_params: Dict, cfg, tokens: torch.Tensor, num_stages: int,
               num_micro: int) -> torch.Tensor:
    """Pipelined forward pass -> logits, ``models.model.forward``'s."""
    logits, _ = _pp_forward_with_aux(pp_params, cfg, tokens, num_stages,
                                     num_micro)
    return logits


def pp_loss_fn(pp_params: Dict, cfg, batch: Dict, num_stages: int,
               num_micro: int):
    """Next-token loss over the pipelined forward -> (total, metrics): the
    objective of ``train_step.loss_fn``, the token loss plus the MoE aux
    terms with the same coefficients."""
    from ..train.train_step import MOE_LB_COEF, MOE_Z_COEF, token_loss

    logits, aux = _pp_forward_with_aux(pp_params, cfg, batch["tokens"],
                                       num_stages, num_micro)
    nll, zloss = token_loss(logits, batch["labels"])
    total = (nll + zloss + MOE_LB_COEF * aux["moe_lb_loss"]
             + MOE_Z_COEF * aux["moe_z_loss"])
    return total, {"loss": nll, "z_loss": zloss,
                   "moe_lb_loss": aux["moe_lb_loss"], "total_loss": total}
