"""The port's MoE block against the reference, on the CPU: Mixtral 8x7B
(MoE in every layer, sliding window) and Arctic 480B (MoE with a dense
MLP in parallel).

Each at ``reduced(...)`` (2 stacked MoE layers, 4 experts top-2 stored as
16 virtual experts, float32) gets the reference's weights through
``params_from_jax``; inputs are made with numpy from a seed.  The router,
the dense ``apply_moe`` with both losses, a block, the no-cache forward,
prefill-then-decode and the engine must agree with the reference within
``TOL`` (float32 on both sides, sums in another order) with equal top
indices and tokens; the token all-to-all's routing and capacity and the
``moe_dispatch`` scenario's bytes are exact host arithmetic, equal to the
reference's; and the port's serve demo prints the reference demo's lines
on the reference's weights.
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.bench import moe as rbm  # noqa: E402
from repro.dist import collectives as RCC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMO  # noqa: E402
from repro.models.cache import init_caches as rinit_caches  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bench import moe as tbm  # noqa: E402
from repro_torch.dist import collectives as TCC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMO  # noqa: E402
from repro_torch.models.cache import init_caches, stack_caches  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4  # float32 against float32, sums in another order
# bf16 weights and activations, the products and the weighted sum in
# float32 against float64, before the cast to bf16, relative to the
# output's scale: the float32 sums' error, and a product near a bf16
# rounding boundary of ``h`` that rounds the other way (up to 8.4e-6 over
# eight seeds); a product rounded to bf16 gives 3.5e-3 or more
F32_TOL = 1e-4
MOE = ["mixtral-8x7b", "arctic-480b"]
REQS = [([1, 2, 3], 6), ([7, 8, 9], 5), ([9], 4)]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=MOE)
def moe(request):
    """(reference cfg, reference params, port cfg, port params)."""
    rc = rcfg.reduced(rcfg.get_config(request.param))
    tc = tcfg.reduced(tcfg.get_config(request.param))
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return rc, params, tc, tp


def layer(params, i=0):
    """Layer i of a stacked tree (reference numpy or port tensors)."""
    if isinstance(params, dict):
        return {k: layer(v, i) for k, v in params.items()}
    return params[i]


def tokens(B, S, seed):
    return np.random.RandomState(seed).randint(0, 512, (B, S)).astype(
        np.int32)


def activations(B, S, d, seed):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


# ------------------------------------------------------ configs, layout
def test_config_and_layout(moe):
    rc, rp, tc, tp = moe
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    assert TM.scanned(tc) and set(tc.pattern_for_depth()) == {"moe"}
    blocks = tp["blocks_scanned"]
    m = blocks["moe"]
    assert m["router"].dtype == torch.float32
    assert tuple(m["router"].shape) == (2, 128, 4)
    assert tuple(m["w_gate"].shape) == tuple(m["w_up"].shape) == \
        (2, 16, 128, 64)
    assert tuple(m["w_down"].shape) == (2, 16, 64, 128)
    assert ("mlp" in blocks) == bool(tc.dense_residual_ff)
    if tc.dense_residual_ff:
        assert tuple(blocks["mlp"]["wi_gate"].shape) == (2, 128, 128)


@pytest.mark.parametrize("name,want", [("mixtral-8x7b", (16, 7168, 2)),
                                       ("arctic-480b", (128, 4864, 1))])
def test_virtual_experts_at_full_width(name, want):
    cfg = tcfg.get_config(name)
    got = TMO.virtual_experts(cfg.num_experts, cfg.d_ff)
    assert got == want == RMO.virtual_experts(cfg.num_experts, cfg.d_ff)
    for E, f in ((4, 256), (2, 100), (8, 14336), (3, 96), (16, 10)):
        assert TMO.virtual_experts(E, f) == RMO.virtual_experts(E, f)


def test_init_moe_shapes_and_types_on_meta():
    cfg = tcfg.get_config("mixtral-8x7b")
    p = TMO.init_moe(None, cfg, torch.bfloat16, "meta", layers=20)
    assert p["router"].dtype == torch.float32
    assert tuple(p["w_gate"].shape) == (20, 16, 4096, 7168)
    assert tuple(p["w_down"].shape) == (20, 16, 7168, 4096)
    assert p["w_up"].dtype == torch.bfloat16


# ------------------------------------------------------------ the router
def test_router_matches_reference(moe):
    rc, rp, tc, tp = moe
    x = activations(1, 40, rc.d_model, seed=3)[0]
    wr = np.asarray(layer(rp["blocks_scanned"])["moe"]["router"])
    g_r, i_r, pieces_r = RMO._router(jnp.asarray(x), jnp.asarray(wr), 4, 2)
    g_t, i_t, pieces_t = TMO._router(t(x), t(wr), 4, 2)
    assert np.array_equal(i_t.numpy(), np.asarray(i_r))  # top indices
    close(g_t, g_r)
    for got, want in zip(pieces_t, pieces_r):  # load, importance, n, z_sum
        close(got, want)
    for got, want in zip(TMO._form_losses(pieces_t, 4, 2),
                         RMO._form_losses(pieces_r, 4, 2)):
        close(got, want)


# ---------------------------------------------------------- dense path
def test_apply_moe_dense_matches_reference(moe):
    rc, rp, tc, tp = moe
    x = activations(2, 16, rc.d_model, seed=5)
    y_r, m_r = RMO.apply_moe(layer(rp["blocks_scanned"])["moe"], jnp.asarray(x), rc,
                             impl="dense")
    y_t, m_t = TMO.apply_moe(layer(tp["blocks_scanned"])["moe"], t(x), tc)
    assert y_t.shape == (2, 16, rc.d_model) and y_t.dtype == torch.float32
    close(y_t, y_r)
    assert sorted(m_t) == sorted(m_r) == ["moe_lb_loss", "moe_z_loss"]
    for k in m_r:
        close(m_t[k], m_r[k])


def moe_f64(p, x, cfg):
    """The reference's dense path in float64 from the same bf16 values:
    the gate, up and down products and the weighted sum unrounded, ``h``
    rounded to bf16 (``preferred_element_type=float32``), the output
    before its cast to bf16, (N, d); routing by the port's router (held
    to the reference's above)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    N, d = x.shape[0] * x.shape[1], x.shape[2]
    x2 = x.reshape(N, d)
    gates, idx, _ = TMO._router(x2, p["router"], E, k)
    xd = x2.double()
    g = torch.einsum("nd,vdf->vnf", xd, p["w_gate"].double())
    u = torch.einsum("nd,vdf->vnf", xd, p["w_up"].double())
    h = (torch.nn.functional.silu(g) * u).to(torch.bfloat16).double()
    y_v = torch.einsum("vnf,vfd->vnd", h, p["w_down"].double())
    y_e = y_v.view(E, -1, N, d).sum(1)
    w = torch.zeros(N, E, dtype=torch.float64).scatter_(1, idx,
                                                         gates.double())
    return torch.einsum("end,ne->nd", y_e, w)


def rounding_product(which: int):
    """``_bmm_f32`` with its ``which``-th call of a dense layer (0 the gate
    product, 1 the up product, 2 the down product) rounded to bf16: the
    fault that the bound below must catch."""
    exact, calls = TMO._bmm_f32, []

    def bmm(a, b):
        out = exact(a, b)
        calls.append(None)
        return (out.to(torch.bfloat16).float() if len(calls) - 1 == which
                else out)
    return bmm


def test_apply_moe_bf16_keeps_the_products_in_float32(monkeypatch):
    """bf16 weights and activations (the served type): the products and
    the weighted sum in float32, only ``h`` rounded (on the CPU one expert
    at a time).  JAX on the CPU has no bf16 x bf16 = f32 product, so the
    reference's semantics are emulated in float64.  The float32 sum
    before the cast to bf16 within ``F32_TOL`` of the output's scale; the
    same path with any one product rounded to bf16 outside it."""
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config("mixtral-8x7b")),
                              dtype="bfloat16")
    p = TMO.init_moe(torch.Generator().manual_seed(2), cfg, torch.bfloat16,
                     "cpu")
    x = torch.from_numpy(activations(2, 8, cfg.d_model, seed=6)).to(
        torch.bfloat16)
    y, m = TMO.apply_moe(p, x, cfg)
    assert y.dtype == torch.bfloat16
    want = moe_f64(p, x, cfg)
    scale = float(want.abs().max())
    y32, _, _ = TMO._dense_mix(p, x.reshape(-1, cfg.d_model), cfg)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.to(torch.bfloat16).reshape(x.shape), y)
    err = float((y32.double() - want).abs().max())
    assert err <= F32_TOL * scale, err / scale
    for which in range(3):
        monkeypatch.setattr(TMO, "_bmm_f32", rounding_product(which))
        bad, _, _ = TMO._dense_mix(p, x.reshape(-1, cfg.d_model), cfg)
        err = float((bad.double() - want).abs().max())
        assert err > 10 * F32_TOL * scale, (which, err / scale)


def test_apply_moe_bf16_on_meta_takes_the_cards_product():
    """The path a card runs (``bmm`` with a float32 output) on the meta
    device: shapes and types only."""
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config("arctic-480b")),
                              dtype="bfloat16")
    p = TMO.init_moe(None, cfg, torch.bfloat16, "meta")
    x = torch.empty(2, 5, cfg.d_model, dtype=torch.bfloat16, device="meta")
    assert TMO._bmm_f32(x.reshape(1, 10, -1), p["w_gate"][:1]).dtype == \
        torch.float32
    y, m = TMO.apply_moe(p, x, cfg)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert m["moe_lb_loss"].device.type == "meta"


def test_apply_moe_rejects_what_it_cannot_run(moe):
    rc, rp, tc, tp = moe
    x = t(activations(1, 4, rc.d_model, seed=0))
    p = layer(tp["blocks_scanned"])["moe"]
    with pytest.raises(ValueError, match="unknown MoE impl"):
        TMO.apply_moe(p, x, tc, impl="dropless")
    with pytest.raises(ValueError, match="rank grid"):
        TMO.apply_moe(p, x, tc, impl="a2a")


def test_block_matches_reference(moe):
    """Attention with ``cfg.window``, the MoE FFN after ``norm2`` and (Arctic)
    the dense MLP added to its output before the residual."""
    rc, rp, tc, tp = moe
    x = activations(2, 12, rc.d_model, seed=7)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    x_r, _, aux = RM.apply_block(layer(rp["blocks_scanned"]), "moe",
                                 jnp.asarray(x), rc, jnp.asarray(pos))
    x_t, new = TM.apply_block(layer(tp["blocks_scanned"]), "moe", t(x), tc,
                              t(pos))
    assert new is None
    close(x_t, x_r)
    assert float(aux[0]) > 0  # the reference's lb loss, which forward drops


# -------------------------------------------------------------- the model
def test_forward_no_cache_matches_reference(moe):
    rc, rp, tc, tp = moe
    toks = tokens(2, 24, seed=1)
    lg_r, _, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks))
    lg_t, caches = TM.forward(tp, tc, torch.from_numpy(toks))
    assert caches is None and lg_t.shape == (2, 24, 512)
    close(lg_t, lg_r)


def test_prefill_then_decode_matches_reference(moe):
    """B=2 prefill of 9 tokens, then 4 decode steps fed the reference's
    greedy tokens: Mixtral's ring caches (max_len 96 past its reduced
    window of 64), Arctic's full caches (no window)."""
    rc, rp, tc, tp = moe
    S, max_len = 9, 96
    toks = tokens(2, S, seed=S)
    rcaches = rinit_caches(rc, 2, max_len)
    tcaches = stack_caches(init_caches(tc, 2, max_len, device="cpu"))
    want_kind = "ring" if tc.window and tc.window < max_len else "full"
    assert tcaches.kind == rcaches[0].kind == want_kind
    lg_r, rcaches, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks),
                                  caches=rcaches, last_token_only=True)
    lg_t, tcaches = TM.forward(tp, tc, torch.from_numpy(toks),
                               caches=tcaches, last_token_only=True)
    close(lg_t, lg_r)
    for step in range(4):
        nxt = np.array(jnp.argmax(lg_r[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(nxt[:, 0], lg_t[:, -1].argmax(-1).numpy())
        lg_r, rcaches, _ = RM.forward(rp, rc, tokens=jnp.asarray(nxt),
                                      caches=rcaches, pos=S + step,
                                      last_token_only=True)
        lg_t, tcaches = TM.forward(tp, tc, torch.from_numpy(nxt),
                                   caches=tcaches, pos=S + step,
                                   last_token_only=True)
        close(lg_t, lg_r)
    for i, rl in enumerate(rcaches):
        close(tcaches.layer(i).k, rl.k)
        close(tcaches.layer(i).v, rl.v)


@pytest.mark.parametrize("mode", ["chunked", "host"])
def test_engine_matches_the_reference_engine(moe, mode):
    rc, rp, tc, tp = moe
    got, want = [], []
    for cls, cfg, params, out in ((RefEngine, rc, rp, want),
                                  (ServeEngine, tc, tp, got)):
        eng = cls(cfg, params, batch_slots=2, max_len=96, chunk_size=4,
                  decode_mode=mode)
        rids = [eng.submit(np.array(p), max_new_tokens=m) for p, m in REQS]
        res = eng.run()
        out.append(([[int(t) for t in res[r]] for r in rids], eng.stats))
    assert got == want
    assert [len(t) for t in got[0][0]] == [m for _, m in REQS]


# -------------------------------------------------- the token all-to-all
@pytest.mark.parametrize("sends,ndev,factor", [
    (64, 4, 1.25), (64, 4, 8.0), (7, 2, 1.25), (512, 8, 1.0),
    (1, 16, 1.25), (1000, 3, 2.5)])
def test_dispatch_capacity_matches_reference(sends, ndev, factor):
    assert TCC.dispatch_capacity(sends, ndev, factor) == \
        RCC.dispatch_capacity(sends, ndev, factor)


@pytest.mark.parametrize("ndev,M,seed", [(4, 64, 0), (2, 48, 1), (8, 256, 2),
                                         (4, 9, 3)])
def test_route_matches_reference_bitwise(ndev, M, seed):
    """Skewed destinations at capacity factor 1.25, so that sends past a
    destination's capacity are dropped in send order."""
    rng = np.random.RandomState(seed)
    p = np.geomspace(8, 1, ndev)
    dest = rng.choice(ndev, size=M, p=p / p.sum()).astype(np.int32)
    cap = TCC.dispatch_capacity(M, ndev, 1.25)
    assert cap == RCC.dispatch_capacity(M, ndev, 1.25)
    slot_r, keep_r = RCC.TokenA2APlan("data", ndev, cap).route(
        jnp.asarray(dest))
    slot_t, keep_t = TCC.TokenA2APlan(ndev, cap).route(t(dest))
    assert np.array_equal(slot_t.numpy(), np.asarray(slot_r))
    assert np.array_equal(keep_t.numpy(), np.asarray(keep_r))
    if M >= 64:
        assert not keep_t.all()  # some sends dropped


# ------------------------------------------------ the moe_dispatch bytes
SPECS = [dict(), dict(ep_mode="sp"), dict(data=2, model=4),
         dict(data=2, model=4, ep_mode="sp"), dict(data=2, model=2),
         dict(data=4, model=1, ep_mode="sp"),
         dict(seq=30, model=4, data=2, ep_mode="sp"),  # sp falls back
         dict(batch=6, data=4), dict(capacity_factor=1.25),
         dict(arch="arctic-480b", ep_mode="sp", dtype_bytes=2)]


@pytest.mark.parametrize("kw", SPECS)
def test_analytic_a2a_bytes_equal_the_reference(kw):
    want = rbm.analytic_a2a_bytes(rbm.MoEDispatchSpec(**kw))
    got = tbm.analytic_a2a_bytes(tbm.MoEDispatchSpec(**kw))
    assert got == want
    rep = tbm.moe_dispatch_report(tbm.MoEDispatchSpec(**kw))
    assert rep["a2a_roofline_s"] == got["a2a_bytes"] / tbm.LINK_BW
    assert tbm.MoEDispatchSpec(**kw).name == rbm.MoEDispatchSpec(**kw).name


def test_compiled_report_names_the_slice_that_brings_it():
    """The sharding slice brought the compiled report: rank 0's program
    counted at dispatch, its all-to-all bytes the analytic count."""
    rep = tbm.moe_dispatch_report(tbm.MoEDispatchSpec(), compiled=True)
    assert rep["hlo_a2a_bytes"] == rep["a2a_bytes"]
    assert rep["hlo_collective_bytes"] >= rep["hlo_a2a_bytes"]


@pytest.mark.parametrize("smoke", [True, False])
def test_family_rows_equal_the_reference_family(smoke):
    """Names, bytes, cap, planes and the ratio equal; the microseconds
    differ by the link constant only."""
    from benchmarks.bench_moe_dispatch import run as ref_run
    from benchmarks.common import BenchContext as RefContext
    from repro.launch.roofline import LINK_BW as REF_LINK_BW
    from repro_torch.bench.families.bench_moe_dispatch import run
    from repro_torch.bench.families.common import BenchContext

    want = ref_run(RefContext(smoke=smoke))
    got = run(BenchContext(smoke=smoke))
    assert [(r.name, r.derived) for r in got] == \
        [(r.name, r.derived) for r in want]
    for g, w in zip(got, want):
        assert g.us_per_call == pytest.approx(
            w.us_per_call * REF_LINK_BW / tbm.LINK_BW, rel=1e-12)


# ---------------------------------------------------------- the demo
def _demo(path: Path, **kw) -> list:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(**kw)
    return buf.getvalue().splitlines()


def test_demo_prints_the_reference_demos_lines():
    """``examples/torch_serve_demo.py --device cpu`` on the reference's
    weights (``PRNGKey(0)``) prints ``examples/serve_demo.py``'s lines."""
    want = _demo(ROOT / "examples" / "serve_demo.py")
    rc = rcfg.reduced(rcfg.get_config("mixtral-8x7b"))
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tc = tcfg.reduced(tcfg.get_config("mixtral-8x7b"))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    got = _demo(ROOT / "examples" / "torch_serve_demo.py",
                argv=["--device", "cpu"], params=tp)
    assert len(want) == 8 and got == want
