"""The port's pipeline parallelism against the reference, on the CPU.

Ports ``tests/test_pipeline_pp.py`` and the pipeline half of
``tests/test_dist_smoke.py``: the schedule is the sweep graph; the
pipelined forward of reduced yi-6b at 4 layers (float32), from the
reference's weights carried across by ``params_from_jax``, equals the
reference's ``pp_forward`` and the port's own ``forward`` within the
reference test's rtol = atol = 1e-4 at (stages, micro) in {(2, 4), (4, 8),
(2, 2)}; ``pp_loss_fn``'s gradient reaches every stage, and equals the
reference's ``jax.grad`` within 1e-4 of each leaf's largest magnitude
(``tests/test_torch_train.py``'s gradient tolerance: float32 on both
sides, sums in another order).  A reduced MoE model checks the aux terms.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.dist import pipeline as RPP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.dist import pipeline as PP  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4  # rtol and atol of the logits, the reference test's
GRAD_TOL = 1e-4  # of a leaf's largest gradient magnitude


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (its models are tiny; under
    several test workers more threads only spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(arch: str, layers: int):
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config(arch)),
                             num_layers=layers)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(arch)),
                             num_layers=layers)
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    np_params = jax.tree.map(np.asarray, params)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                                       rc.vocab_size))
    return rc, tc, params, params_from_jax(np_params, tc, device="cpu"), toks


@pytest.fixture(scope="module")
def setup():
    return both("yi-6b", 4)


def test_schedule_is_sweep_graph():
    g = PP.pp_schedule(num_stages=4, num_micro=6)
    assert g.pattern == "sweep"
    assert g.width == 4 and g.height == 9  # M + S - 1 ticks
    # stage s depends on itself and its left neighbour: the wavefront
    assert g.deps(3, 2) == [1, 2]
    assert g.deps(1, 0) == [0]
    ref = RPP.pp_schedule(4, 6)
    assert [g.deps(t, s) for t in range(9) for s in range(4)] == \
        [ref.deps(t, s) for t in range(9) for s in range(4)]


def test_pp_schedule_shapes_and_wavefront():
    g = PP.pp_schedule(num_stages=3, num_micro=5)
    assert g.pattern == "sweep"
    assert g.width == 3 and g.height == 7
    # microbatch m hits stage s at tick t = m + s; deps are the arriving
    # activation (t-1, s-1) and the stage's previous microbatch (t-1, s)
    assert g.deps(2, 1) == [0, 1]
    assert g.deps(1, 0) == [0]
    assert g.deps(0, 0) == []


def test_stack_params_rejects_indivisible_depth_and_a_list_stack():
    params = {"blocks_scanned": {"w": torch.zeros(4, 2)}}
    stacked = PP.stack_params_by_stage(params, num_stages=2)
    assert stacked["blocks_scanned"]["w"].shape == (2, 2, 2)
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        PP.stack_params_by_stage(params, num_stages=3)
    with pytest.raises(ValueError, match="scanned homogeneous block stack"):
        PP.stack_params_by_stage({"blocks": [{}]}, num_stages=1)


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 8), (2, 2)])
def test_pp_forward_matches_reference(setup, stages, micro):
    rc, tc, rparams, tparams, toks = setup
    want = np.asarray(jax.jit(RPP.pp_forward, static_argnums=(1, 3, 4))(
        RPP.stack_params_by_stage(rparams, num_stages=stages), rc,
        jnp.asarray(toks), stages, micro), np.float32)
    with torch.no_grad():
        got = PP.pp_forward(PP.stack_params_by_stage(tparams, stages), tc,
                            torch.from_numpy(toks), stages, micro)
        plain, _ = M.forward(tparams, tc, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="not divisible by 3 micro"):
        PP.pp_forward(PP.stack_params_by_stage(tparams, stages), tc,
                      torch.from_numpy(toks), stages, 3)


def grads_against_reference(rc, tc, rparams, tparams, toks, stages, micro):
    batch = {"tokens": toks, "labels": toks}
    rpp = RPP.stack_params_by_stage(rparams, num_stages=stages)
    (r_total, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        lambda p: RPP.pp_loss_fn(p, rc, batch, stages, micro),
        has_aux=True))(rpp)
    tpp = T.tree_map(lambda t: t.detach().requires_grad_(True),
                     PP.stack_params_by_stage(tparams, stages))
    total, metrics = PP.pp_loss_fn(
        tpp, tc, {k: torch.from_numpy(v) for k, v in batch.items()}, stages,
        micro)
    grads = torch.autograd.grad(total, T.leaves(tpp))
    keys = [k for k, _ in T.flatten(tpp)]
    for key, g, w in zip(keys, grads, jax.tree.leaves(r_grads)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=GRAD_TOL * max(float(np.abs(w).max()),
                                                      1e-6), err_msg=key)
    for k, v in r_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    return dict(zip(keys, grads)), metrics


def test_pp_gradients_flow(setup):
    rc, tc, rparams, tparams, toks = setup
    grads, _ = grads_against_reference(rc, tc, rparams, tparams, toks, 2, 4)
    total = sum(float(g.abs().sum()) for g in grads.values())
    assert np.isfinite(total) and total > 0
    # every stage's blocks received gradient
    for key, g in grads.items():
        if key.startswith("['blocks_scanned']"):
            assert g.shape[0] == 2, key
            assert all(float(g[s].abs().sum()) > 0 for s in range(2)), key


def test_pp_loss_moe_aux_terms_match_reference():
    """A reduced Mixtral (MoE blocks): the aux losses summed over the
    layers and averaged over the microbatches, as the reference's."""
    rc, tc, rparams, tparams, toks = both("mixtral-8x7b", 2)
    _, metrics = grads_against_reference(rc, tc, rparams, tparams, toks, 2, 2)
    assert float(metrics["moe_lb_loss"].detach()) > 0
