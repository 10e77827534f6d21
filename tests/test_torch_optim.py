"""The port's AdamW, schedules and error-feedback compression, on the CPU:
the cases of ``tests/test_optim.py`` on the port, and each function held
to the reference on the same numpy-seeded inputs.

Tolerances: the numpy AdamW cross-check is the reference test's (rtol
2e-5, atol 2e-6); the schedules and ``ef_compress`` are float32
elementwise arithmetic in the same order as the reference's, held within
``F32_TOL`` (XLA on the CPU may contract a product and a sum into an FMA).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.dist import compression as rcomp  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import schedule as rsched  # noqa: E402

from repro_torch.dist.compression import (ef_compress,  # noqa: E402
                                          ef_compress_tree)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import schedule  # noqa: E402

F32_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its models are tiny, and the
    suite runs several workers on the CPU at once, where each process's
    threads spin against the others' (six concurrent runs of
    ``tests/test_torch_trainer.py`` took over 900 s at 8 threads each, 17 s
    at 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_adamw(params, grads, steps, cfg):
    """Plain-numpy AdamW (float32, no clip) for cross-checking."""
    mu = {k: np.zeros_like(v) for k, v in params.items()}
    nu = {k: np.zeros_like(v) for k, v in params.items()}
    p = {k: v.copy() for k, v in params.items()}
    for t in range(1, steps + 1):
        for k in p:
            g = grads[k]
            mu[k] = cfg.b1 * mu[k] + (1 - cfg.b1) * g
            nu[k] = cfg.b2 * nu[k] + (1 - cfg.b2) * g * g
            mh = mu[k] / (1 - cfg.b1 ** t)
            vh = nu[k] / (1 - cfg.b2 ** t)
            upd = mh / (np.sqrt(vh) + cfg.eps)
            if p[k].ndim >= 2:
                upd = upd + cfg.weight_decay * p[k]
            p[k] = p[k] - cfg.lr * upd
    return p


def _tensors(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_adamw_matches_numpy_reference():
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32)}
    grads = {"w": rs.randn(4, 3).astype(np.float32) * 0.1,
             "b": rs.randn(3).astype(np.float32) * 0.1}
    cfg = adamw.AdamWConfig(lr=1e-2, clip_norm=1e9, weight_decay=0.1)
    tp, tg = _tensors(params), _tensors(grads)
    state = adamw.init(tp, cfg)
    for _ in range(5):
        tp, state, _ = adamw.update(tg, state, tp, cfg)
    ref = _numpy_adamw(params, grads, 5, cfg)
    for k in ref:
        np.testing.assert_allclose(tp[k].numpy(), ref[k], rtol=2e-5,
                                   atol=2e-6)


def test_decay_mask_excludes_vectors():
    mask = adamw.decay_mask({"w": torch.ones(4, 4), "scale": torch.ones(4)})
    assert mask["w"] and not mask["scale"]


def test_grad_clipping():
    params = {"w": torch.zeros(10, 10)}
    grads = {"w": torch.full((10, 10), 100.0)}
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    state = adamw.init(params, cfg)
    _, _, metrics = adamw.update(grads, state, params, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(1000.0, rel=1e-3)


def test_bf16_state_dtype():
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    cfg = adamw.AdamWConfig(state_dtype="bfloat16", master_weights=False)
    state = adamw.init(params, cfg)
    assert state.mu["w"].dtype == torch.bfloat16 and state.master is None
    new_p, _, _ = adamw.update({"w": torch.ones(4, 4)}, state, params, cfg)
    assert new_p["w"].dtype == torch.bfloat16


def test_master_weights_kept_fp32():
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    cfg = adamw.AdamWConfig()
    state = adamw.init(params, cfg)
    assert state.master["w"].dtype == torch.float32
    _, new_s, _ = adamw.update({"w": torch.full((4, 4), 1e-3)}, state,
                               params, cfg)
    # the master accumulates below bf16 resolution
    assert new_s.master["w"].dtype == torch.float32
    assert not torch.equal(new_s.master["w"],
                           new_s.master["w"].bfloat16().float())


def test_error_feedback_compression_bound():
    """Compressed gradient + residual reconstructs the input exactly."""
    g = torch.from_numpy(np.random.RandomState(1).randn(64, 64)
                         .astype(np.float32))
    comp, new_res = ef_compress(g, torch.zeros_like(g))
    np.testing.assert_allclose((comp + new_res).numpy(), g.numpy(),
                               rtol=1e-6, atol=1e-6)
    # quantization error bounded by scale / 2 per element
    scale = float(g.abs().max()) / 127.0
    assert float(new_res.abs().max()) <= scale * 0.51 + 1e-7


def test_error_feedback_converges_on_constant_gradient():
    """With a constant gradient, the EF-compressed sum approaches the true
    sum."""
    g = torch.from_numpy(np.random.RandomState(2).randn(32)
                         .astype(np.float32))
    res, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        comp, res = ef_compress(g, res)
        total = total + comp
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(),
                               atol=float(g.abs().max()) / 127.0)


# -------------------------------------------------- against the reference
@pytest.mark.parametrize("steps", [(0, 1, 5, 99, 100, 101, 550, 1000, 1200)])
def test_schedules_match_reference(steps):
    for s in steps:
        for warm, total in ((100, 1000), (0, 10), (5, 5)):
            got = schedule.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                         3e-4, warm, total)
            want = rsched.warmup_cosine(jnp.int32(s), 3e-4, warm, total)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL,
                                       atol=0)
        assert float(schedule.constant(s, 1e-3)) == float(
            rsched.constant(s, 1e-3))


def test_ef_compress_matches_reference():
    rs = np.random.RandomState(3)
    g = (rs.randn(16, 8) * 3).astype(np.float32)
    r = (rs.randn(16, 8) * 0.01).astype(np.float32)
    c_r, res_r = rcomp.ef_compress(jnp.asarray(g), jnp.asarray(r))
    c_t, res_t = ef_compress(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_r), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(res_t.numpy(), np.asarray(res_r),
                               rtol=F32_TOL, atol=F32_TOL)
    zero = torch.zeros(4)
    c0, r0 = ef_compress(zero, zero)  # a zero scale is taken as 1
    assert torch.equal(c0, zero) and torch.equal(r0, zero)
    tree = {"a": torch.from_numpy(g), "b": [torch.from_numpy(r)]}
    comp, res = ef_compress_tree(tree, {"a": torch.zeros(16, 8),
                                        "b": [torch.zeros(16, 8)]})
    assert sorted(comp) == ["a", "b"] and len(res["b"]) == 1


@pytest.mark.parametrize("knobs", [
    {}, {"compression": "int8_ef"}, {"state_dtype": "bfloat16",
                                     "master_weights": False}])
def test_update_matches_reference(knobs):
    """Three steps of ``update`` on a bf16 and a float32 leaf, with clipping
    active, against the reference's, for each knob."""
    rs = np.random.RandomState(4)
    p32 = {"w": rs.randn(6, 5).astype(np.float32),
           "b": rs.randn(5).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * 2).astype(np.float32)
              for k, v in p32.items()} for _ in range(3)]
    kw = dict(lr=1e-2, clip_norm=0.5, **knobs)
    rcfg_, tcfg_ = radamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rp = {"w": jnp.asarray(p32["w"]).astype(jnp.bfloat16),
          "b": jnp.asarray(p32["b"])}
    tp = {"w": torch.from_numpy(p32["w"]).bfloat16(),
          "b": torch.from_numpy(p32["b"])}
    rs_, ts_ = radamw.init(rp, rcfg_), adamw.init(tp, tcfg_)
    assert (rs_.master is None) == (ts_.master is None)
    for g in grads:
        rp, rs_, rm = radamw.update({k: jnp.asarray(v) for k, v in g.items()},
                                    rs_, rp, rcfg_)
        tp, ts_, tm = adamw.update(_tensors(g), ts_, tp, tcfg_)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
    for k in p32:
        got, want = tp[k].float().numpy(), np.asarray(rp[k], np.float32)
        # the bf16 leaf: one bf16 ulp
        np.testing.assert_allclose(got, want, rtol=2 ** -7 if k == "w"
                                   else 1e-5, atol=1e-6)
        np.testing.assert_allclose(ts_.mu[k].float().numpy(),
                                   np.asarray(rs_.mu[k], np.float32),
                                   rtol=1e-2 if knobs.get("state_dtype")
                                   else 1e-5, atol=1e-6)
    if ts_.ef_residual is not None:
        np.testing.assert_allclose(ts_.ef_residual["w"].numpy(),
                                   np.asarray(rs_.ef_residual["w"]),
                                   rtol=1e-4, atol=1e-5)
    assert int(ts_.step) == 3


def test_in_place_update_equals_functional():
    rs = np.random.RandomState(5)
    p = {"w": torch.from_numpy(rs.randn(6, 5).astype(np.float32)).bfloat16(),
         "b": torch.from_numpy(rs.randn(5).astype(np.float32))}
    g = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(1))
         for k, v in p.items()}
    cfg = dataclasses.replace(adamw.AdamWConfig(), compression="int8_ef")
    s1, s2 = adamw.init(p, cfg), adamw.init(p, cfg)
    p2 = {k: v.clone() for k, v in p.items()}
    p1, s1, m1 = adamw.update(g, s1, p, cfg)
    m2 = adamw.update_(g, s2, p2, cfg)
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])
    for k in p:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1.master[k], s2.master[k])
        assert torch.equal(s1.nu[k], s2.nu[k])
        assert torch.equal(s1.ef_residual[k], s2.ef_residual[k])
    assert int(s2.step) == 1
    with pytest.raises(ValueError, match="compression"):
        adamw.init(p, adamw.AdamWConfig(compression="fp8"))
