"""The MoE block's a2a path on 4 CPU rank processes against the port's
dense path.

An ``ExpertGrid`` over one pool of 4 gloo ranks, as ``(data, model)`` =
(2, 2) and (4, 1), in both ``ep_mode``s, at capacity factor 8 (no drops):
the output must match the dense path within ``5e-4 * max(scale, 1)`` and
the load-balance loss within 1e-3, the tolerances of the reference's own
a2a tests (``tests/test_distributed.py``), and the bytes each rank's
``data``-axis all-to-alls moved must equal ``analytic_a2a_bytes``.  The
divisibility fallbacks (a sequence that does not shard over ``model``, a
batch that does not shard over ``data``), a grid of one expert a rank,
a grid whose ranks build their shards from a seed and a grid given
another layer than the one it holds are covered too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bench.moe import (MoEDispatchSpec,  # noqa: E402
                                   analytic_a2a_bytes)
from repro_torch.dist.ranks import get_pool  # noqa: E402
from repro_torch.models import moe as TMO  # noqa: E402

RANKS = 4
GRIDS = [(2, 2), (4, 1)]
MODES = ["replicated", "sp"]
LB_TOL = 1e-3  # the reference's tolerance on the lb loss


def out_tol(y_dense: torch.Tensor) -> float:
    """The reference's tolerance: 5e-4 of the output's scale (at least 1)."""
    return 5e-4 * max(float(y_dense.abs().max()), 1.0)


@pytest.fixture(scope="module")
def pool():
    return get_pool(RANKS, torch.device("cpu"))


def config(arch: str, **kw):
    return dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)),
                               moe_capacity_factor=8.0, **kw)


def layer(cfg, seed: int = 0):
    return TMO.init_moe(torch.Generator().manual_seed(seed), cfg,
                        torch.float32, "cpu")


def activations(B, S, d, seed=1):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(B, S, d).astype(np.float32))


def check(p, x, cfg, grid, mode):
    y_d, m_d = TMO.apply_moe(p, x, cfg, impl="dense")
    y, m = TMO.apply_moe(p, x, cfg, ep_mode=mode, grid=grid)
    assert y.shape == x.shape and y.dtype == x.dtype
    err = float((y - y_d).abs().max())
    assert err < out_tol(y_d), err
    assert abs(float(m["moe_lb_loss"]) - float(m_d["moe_lb_loss"])) < LB_TOL
    assert abs(float(m["moe_z_loss"]) - float(m_d["moe_z_loss"])) < LB_TOL
    return y


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("data,model", GRIDS)
def test_a2a_matches_dense_and_moves_the_analytic_bytes(pool, arch, mode,
                                                        data, model):
    cfg = config(arch)
    p = layer(cfg)
    B, S = 8, 32
    grid = TMO.ExpertGrid(pool, data, model, p)
    check(p, activations(B, S, cfg.d_model), cfg, grid, mode)
    want = analytic_a2a_bytes(MoEDispatchSpec(
        arch=arch, batch=B, seq=S, data=data, model=model, ep_mode=mode))
    assert [s["data"]["a2a_bytes"] for s in grid.stats] == \
        [want["a2a_bytes"]] * RANKS
    # three all-to-alls a rank: rows and ids out, rows back
    assert all(s["data"]["ops"] == 3 for s in grid.stats)
    gathers = 2 if mode == "sp" else 0
    sums = 1 if model > 1 else 0  # the expert-TP sum
    assert all(s["model"]["ops"] == gathers + sums for s in grid.stats)


def test_sp_and_replicated_agree(pool):
    cfg = config("mixtral-8x7b")
    assert cfg.ep_mode == "sp"
    p = layer(cfg)
    x = activations(8, 16, cfg.d_model, seed=4)
    grid = TMO.ExpertGrid(pool, 2, 2, p)
    y_sp = check(p, x, cfg, grid, "sp")
    y_rep = check(p, x, cfg, grid, "replicated")
    assert float((y_sp - y_rep).abs().max()) < out_tol(y_rep)
    y_cfg, _ = TMO.apply_moe(p, x, cfg, grid=grid)  # auto, cfg's ep_mode
    assert torch.equal(y_cfg, y_sp)


@pytest.mark.parametrize("B,S", [(8, 15), (6, 16)])
def test_divisibility_fallbacks(pool, B, S):
    """S = 15 does not shard over model = 2: sp runs as replicated; B = 6
    does not shard over data = 4: every data rank routes the whole batch.
    Both still match dense and move the analytic bytes."""
    cfg = config("mixtral-8x7b")
    p = layer(cfg)
    data, model = (2, 2) if S % 2 else (4, 1)
    grid = TMO.ExpertGrid(pool, data, model, p)
    check(p, activations(B, S, cfg.d_model), cfg, grid, "sp")
    want = analytic_a2a_bytes(MoEDispatchSpec(
        batch=B, seq=S, data=data, model=model, ep_mode="sp"))
    assert [s["data"]["a2a_bytes"] for s in grid.stats] == \
        [want["a2a_bytes"]] * RANKS


@pytest.mark.parametrize("mode", MODES)
def test_one_expert_a_rank(pool, mode):
    """Two experts of width 100 (no sub-expert split: 100 % 8 != 0) over
    data = 2: the path without the per-expert capacity buffer."""
    cfg = config("mixtral-8x7b", num_experts=2, d_ff=100)
    p = layer(cfg)
    assert tuple(p["w_gate"].shape) == (2, 128, 100)
    grid = TMO.ExpertGrid(pool, 2, 2, p)
    check(p, activations(4, 16, cfg.d_model), cfg, grid, mode)


def test_ranks_build_their_shards_from_the_seed(pool):
    """The ranks build the layer from a seed on their own device and keep
    their shards: the controller's layer from the same seed is the one
    they hold."""
    cfg = config("arctic-480b")
    grid = TMO.ExpertGrid(pool, 2, 2, cfg=cfg, seed=11)
    p = layer(cfg, seed=11)
    check(p, activations(4, 8, cfg.d_model, seed=3), cfg, grid, "sp")


def test_grid_refuses_a_layer_it_does_not_hold(pool):
    """The ranks compute with the shards they hold: a layer from another
    seed, or the grid's own layer changed in place after the grid was
    built, is refused, not answered with the held layer's output."""
    cfg = config("mixtral-8x7b")
    x = activations(2, 8, cfg.d_model)
    grid = TMO.ExpertGrid(pool, 2, 2, cfg=cfg, seed=11)
    with pytest.raises(ValueError, match="holds another layer"):
        TMO.apply_moe(layer(cfg, seed=12), x, cfg, grid=grid)
    p = layer(cfg)
    grid = TMO.ExpertGrid(pool, 2, 2, p)
    TMO.apply_moe(p, x, cfg, grid=grid)
    for name in ("router", "w_down"):
        q = {k: v.clone() for k, v in p.items()}
        q[name].view(-1)[-1] += 1.0
        with pytest.raises(ValueError, match="holds another layer"):
            TMO.apply_moe(q, x, cfg, grid=grid)
    p["w_up"][0, 0, 0] *= 2.0
    with pytest.raises(ValueError, match="holds another layer"):
        TMO.apply_moe(p, x, cfg, grid=grid)


def test_grid_rejects_what_it_cannot_hold(pool):
    cfg = config("mixtral-8x7b")
    p = layer(cfg)
    with pytest.raises(ValueError, match="needs 6 ranks"):
        TMO.ExpertGrid(pool, 3, 2, p)
    with pytest.raises(ValueError, match="do not shard"):
        TMO.ExpertGrid(pool, 1, 4, dict(p, w_gate=p["w_gate"][:, :, :30]))
    grid = TMO.ExpertGrid(pool, 4, 1, p)
    other = layer(config("arctic-480b", d_ff=128))
    with pytest.raises(ValueError, match="holds experts of shape"):
        TMO.apply_moe(other, activations(1, 4, cfg.d_model), cfg,
                      grid=grid, impl="a2a")
    with pytest.raises(ValueError, match="unknown ep_mode"):
        TMO.apply_moe(p, activations(1, 4, cfg.d_model), cfg, grid=grid,
                      ep_mode="tp")
