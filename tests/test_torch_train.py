"""The port's train step against the reference, on the CPU, for all ten
configurations at ``reduced(...)`` (2-4 layers, float32).

Both packages start from the reference's ``init_state`` (carried across by
``train_state_from_jax``) and see the same numpy-seeded batches, tokens or
(for the two frontend configs) embeddings.  The reference runs its
``compute_grads`` and AdamW under one ``jax.jit`` a grad_accum (1 and 2)
for ``STEPS`` steps, keeping the first step's gradients.  Held to it:

- ``compute_grads``: every gradient leaf within ``GRAD_TOL`` of its
  largest magnitude (float32 on both sides, sums in another order);
- ``adamw.update`` at its own lr given the reference's gradients (the
  reference's update of the same step, inside its jit): params within
  ``ADAM_TOL``, moments within ``GRAD_TOL``;
- the losses and grad norms of ``STEPS`` steps of ``make_train_step``
  within ``LOSS_TOL`` relative.  Params after a step are not compared:
  at step 1 AdamW moves a parameter by about lr sign(g), so a gradient near
  0 may flip the sign of its step between two correct implementations;
  the next losses carry that at the lr's scale, far below ``LOSS_TOL``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import train_step as RTS  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

B, S, STEPS = 2, 16, 3
GRAD_TOL = 1e-4  # of a leaf's largest gradient magnitude
ADAM_TOL = 1e-6  # absolute, on parameters of O(1) moved by lr = 3e-4
LOSS_TOL = 1e-5  # relative, on the loss and the grad norm


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


def batch(cfg, step: int) -> dict:
    rs = np.random.RandomState(100 + step)
    if cfg.frontend:
        return {"embeds": rs.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "labels": rs.randint(0, cfg.vocab_size, (B, S))
                .astype(np.int32)}
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_cfgs(accum: int):
    kw = dict(total_steps=10, warmup_steps=2, grad_accum=accum)
    return RTS.TrainConfig(**kw), TTS.TrainConfig(**kw)


def reference_run(rc, accum: int) -> dict:
    rt, _ = train_cfgs(accum)
    state, _ = RTS.init_state(jax.random.PRNGKey(0), rc, rt)
    start = jax.tree.map(np.asarray, state)

    @jax.jit
    def step(state, b):
        grads, metrics = RTS.compute_grads(state.params, b, rc, rt)
        lr = RTS.warmup_cosine(state.step, rt.base_lr, rt.warmup_steps,
                               rt.total_steps)
        params, opt, om = radamw.update(grads, state.opt, state.params,
                                        rt.adamw, lr=lr)
        metrics.update(om)
        # AdamW at its own lr (the schedule's is 0 at step 0)
        at_lr = radamw.update(grads, state.opt, state.params, rt.adamw)
        return RTS.TrainState(step=state.step + 1, params=params,
                              opt=opt), metrics, grads, at_lr

    metrics, first = [], None
    for i in range(STEPS):
        state, m, g, at_lr = step(state, batch(rc, i))
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or jax.tree.map(np.asarray, (g, at_lr))
    return {"start": start, "metrics": metrics, "grads0": first[0],
            "adamw0": first[1]}


@pytest.fixture(scope="module", params=rcfg.ALL_ARCHS)
def run(request):
    """(reference cfg, port cfg, {accum: reference run})."""
    rc = rcfg.reduced(rcfg.get_config(request.param))
    tc = tcfg.reduced(tcfg.get_config(request.param))
    return rc, tc, {a: reference_run(rc, a) for a in (1, 2)}


def port_state(tc, ref: dict, accum: int):
    return train_state_from_jax(ref["start"], tc, train_cfgs(accum)[1],
                                device="cpu")


def close_leaves(got, want, tol, scaled=True):
    keys = [k for k, _ in T.flatten(got)]
    for key, g, w in zip(keys, T.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        atol = tol * max(float(np.abs(w).max()), 1e-6) if scaled else tol
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("accum", [1, 2])
def test_compute_grads_match_reference(run, accum):
    rc, tc, refs = run
    ref = refs[accum]
    _, tt = train_cfgs(accum)
    st = port_state(tc, ref, accum)
    grads, metrics = TTS.compute_grads(
        st.params, TTS.to_device(batch(tc, 0), "cpu"), tc, tt)
    assert [k for k, _ in T.flatten(grads)] == [
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(ref["grads0"])[0]]
    close_leaves(grads, ref["grads0"], GRAD_TOL)
    for k in TTS.METRICS:
        np.testing.assert_allclose(float(metrics[k]), ref["metrics"][0][k],
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)


def test_adamw_update_matches_reference(run):
    rc, tc, refs = run
    ref = refs[1]
    _, tt = train_cfgs(1)
    rp, ropt, rm = ref["adamw0"]
    st = port_state(tc, ref, 1)
    tgrads = T.unflatten(st.params, [torch.from_numpy(np.array(g)) for g in
                                     jax.tree.leaves(ref["grads0"])])
    tp, topt, tm = tadamw.update(tgrads, st.opt, st.params, tt.adamw)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=LOSS_TOL)
    assert int(topt.step) == int(ropt.step) == 1
    close_leaves(tp, rp, ADAM_TOL, scaled=False)
    close_leaves(topt.mu, ropt.mu, GRAD_TOL)
    close_leaves(topt.nu, ropt.nu, GRAD_TOL)
    assert (topt.master is None) == (ropt.master is None)


@pytest.mark.parametrize("accum", [1, 2])
def test_three_step_losses_match_reference(run, accum):
    rc, tc, refs = run
    ref = refs[accum]
    _, tt = train_cfgs(accum)
    st = port_state(tc, ref, accum)
    step = TTS.make_train_step(tc, tt)
    for i in range(STEPS):
        st, m = step(st, batch(tc, i))
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), ref["metrics"][i][k],
                                       rtol=LOSS_TOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert int(st.step) == int(st.opt.step) == STEPS


def test_functional_step_equals_in_place_step():
    """``train_step`` (new tensors) and ``make_train_step`` (in place) give
    the same state and metrics, bit for bit, with bf16 params (float32
    master weights) and int8 error-feedback compression."""
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config("qwen1.5-0.5b")),
                              dtype="bfloat16")
    tt = TTS.TrainConfig(total_steps=10, warmup_steps=1, adamw=dataclasses
                         .replace(tadamw.AdamWConfig(), compression="int8_ef"))
    a = TTS.init_state(cfg, tt, 0, device="cpu")
    b = TTS.init_state(cfg, tt, 0, device="cpu")
    assert a.opt.master is not None and a.opt.ef_residual is not None
    step = TTS.make_train_step(cfg, tt)
    for i in range(2):
        bt = TTS.to_device(batch(cfg, i), "cpu")
        a, ma = TTS.train_step(a, bt, cfg, tt)
        b, mb = step(b, bt)
        for k in ma:
            assert float(ma[k]) == float(mb[k]), k
    for x, y in zip(T.leaves(a), T.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(b.step) == 2 and b.params["embed"]["table"].dtype == \
        torch.bfloat16


# ------------------------------------------ gradients through K5 and K6
def test_kernel_autograd_functions_backward_through_the_plain_graph(
        monkeypatch):
    """K5's and K6's autograd functions (the path a CUDA tensor that needs
    a gradient takes), run here with the launch replaced by the plain
    version: the gradients are the plain graph's, bit for bit, and not
    zero (the graph is not cut)."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import ssd as tssd

    launched = []

    def fake(plain):
        def launch(*args):
            launched.append(plain.__name__)
            with torch.no_grad():
                return plain(*args)
        return launch

    monkeypatch.setattr(tfa, "_launch", fake(tfa.flash_attention_plain))
    monkeypatch.setattr(tssd, "_launch", lambda *a: fake(
        tssd.ssd_chunked_plain)(*a[:5], None, a[5]))
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).requires_grad_(True)

    q, k, v = rand(2, 40, 4, 80), rand(2, 40, 2, 80), rand(2, 40, 2, 80)
    w = torch.randn(2, 40, 4, 80, generator=gen)
    out = tfa._FlashAttention.apply(q, k, v, False, None, 0, None)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad(
        (tfa.flash_attention_plain(q, k, v, causal=False) * w).sum(),
        (q, k, v))
    for g, h in zip(got, want):
        assert torch.equal(g, h) and g.abs().sum() > 0

    x, Bm, Cm = rand(1, 32, 4, 8), rand(1, 32, 1, 4), rand(1, 32, 1, 4)
    dt = torch.rand(1, 32, 4, generator=gen).requires_grad_(True)
    A = (-torch.rand(4, generator=gen)).requires_grad_(True)
    wy = torch.randn(1, 32, 4, 8, generator=gen)
    ins = (x, dt, A, Bm, Cm)
    y, h = tssd._SSDChunked.apply(*ins, 16)
    got = torch.autograd.grad((y * wy).sum() + h.square().sum(), ins)
    y2, h2 = tssd.ssd_chunked_plain(*ins, None, 16)
    want = torch.autograd.grad((y2 * wy).sum() + h2.square().sum(), ins)
    for g, h in zip(got, want):
        assert torch.equal(g, h) and g.abs().sum() > 0
    # only the state's gradient: y's is None
    (gx,) = torch.autograd.grad(tssd._SSDChunked.apply(*ins, 16)[1].sum(),
                                (x,))
    assert gx.abs().sum() > 0
    assert launched == ["flash_attention_plain"] + ["ssd_chunked_plain"] * 2


def test_remat_modes_give_the_same_grads():
    """``remat`` "none", "full" and "selective" give the same gradients bit
    for bit; "full" recomputes every matmul of a block in the backward
    pass, "selective" none of the unbatched ones (their outputs saved)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default,
                               torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    base = tcfg.reduced(tcfg.get_config("minitron-8b"))
    tt = TTS.TrainConfig()
    st = TTS.init_state(base, tt, 0, device="cpu")
    b = TTS.to_device(batch(base, 0), "cpu")
    grads, counts = {}, {}
    for remat in ("none", "full", "selective"):
        cfg = dataclasses.replace(base, remat=remat)
        with CountMM() as c:
            grads[remat], _ = TTS.compute_grads(st.params, b, cfg, tt)
        counts[remat] = c.n
    for remat in ("full", "selective"):
        for x, y in zip(T.leaves(grads[remat]), T.leaves(grads["none"])):
            assert torch.equal(x, y), remat
    assert counts["selective"] == counts["none"] < counts["full"]


def test_plain_ssd_gradients_stay_finite_where_the_decay_overflows():
    """K6's backward is its plain version's graph.  At Mamba-2's widths
    cum_i - cum_j above a chunk's diagonal passes float32's exp range
    (dt up to 0.1 and A down to -16 over 128 steps: ~200); masked before
    the exp, those entries give 0 and no NaN gradient, and the forward is
    what it was."""
    from repro_torch.kernels import ssd as tssd

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 128, 2, 8, generator=gen).requires_grad_(True)
    dt = torch.full((1, 128, 2), 0.1).requires_grad_(True)
    A = torch.tensor([-16.0, -8.0]).requires_grad_(True)
    Bm = torch.randn(1, 128, 1, 4, generator=gen).requires_grad_(True)
    Cm = torch.randn(1, 128, 1, 4, generator=gen).requires_grad_(True)
    ins = (x, dt, A, Bm, Cm)
    y, h = tssd.ssd_chunked_plain(*ins, None, 128)
    grads = torch.autograd.grad(y.sum() + h.sum(), ins)
    assert all(bool(g.isfinite().all()) and g.abs().sum() > 0 for g in grads)
    cum = torch.cumsum(dt[0, :, 0] * A[0], 0)
    assert float((cum[:, None] - cum[None, :]).max()) > 88.0  # exp overflows


def test_bf16_expert_products_are_differentiable():
    """The MoE dense path keeps its bf16 expert products in float32
    (``_bmm_f32``); under autograd their gradients are JAX's for
    ``preferred_element_type=float32``: the float32 cotangent times the
    other operand in float32, rounded to bf16 (held to a float64
    emulation within one bf16 ulp), and a bf16 reduced Mixtral step
    runs."""
    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 8, generator=gen).bfloat16().requires_grad_(True)
    b = torch.randn(3, 8, 4, generator=gen).bfloat16().requires_grad_(True)
    g = torch.randn(3, 5, 4, generator=gen)
    y = moe._bmm_f32(a, b)
    assert y.dtype == torch.float32
    ga, gb = torch.autograd.grad(y, (a, b), g)
    a64, b64 = a.detach().double(), b.detach().double()
    want_a = (g.double() @ b64.transpose(1, 2)).to(torch.bfloat16)
    want_b = (a64.transpose(1, 2) @ g.double()).to(torch.bfloat16)
    for got, want in ((ga, want_a), (gb, want_b)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=2 ** -7, atol=1e-6)
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config("mixtral-8x7b")),
                              dtype="bfloat16")
    tt = TTS.TrainConfig(warmup_steps=0, total_steps=10)
    st = TTS.init_state(cfg, tt, 0, device="cpu")
    st, m = TTS.make_train_step(cfg, tt)(st, batch(cfg, 0))
    assert np.isfinite(float(m["loss"])) and float(m["moe_lb_loss"]) > 0
    assert float(m["grad_norm"]) > 0
