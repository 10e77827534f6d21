"""The port's SSD (K6's plain version), Mamba-2 block and model against the
reference package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  K6's
plain version is held to the reference's Pallas kernel run in interpret
mode at the reference's own kernel-test tolerance (rtol = atol = 2e-3,
``tests/test_kernels.py``), and to its float32 oracles at 1e-4; the
reduced Mamba-2 block and model, with the reference's weights carried
across by ``params_from_jax``, give its logits within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.cache import init_caches as rinit_caches  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd as tssd  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.cache import (LayerCache, init_caches,  # noqa: E402
                                      stack_caches)
from repro_torch.models.convert import params_from_jax  # noqa: E402

SSD_CASES = [  # B, S, H, P, G, N, chunk: tests/test_kernels.py, then 1 and 37
    (2, 128, 4, 16, 2, 8, 32),
    (1, 256, 8, 32, 1, 16, 64),
    (2, 64, 2, 64, 2, 32, 64),
    (1, 9, 2, 8, 1, 4, 1),
    (2, 74, 4, 16, 2, 8, 37),
]
KERNEL_TOL = 2e-3   # the reference's own Pallas kernel-test tolerance
ORACLE_TOL = 1e-4   # float32 against float32, sums in another order
MODEL = "mamba2-2.7b"


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


def ssd_inputs(B, S, H, P, G, N, seed=0):
    r = np.random.RandomState(seed)
    x = (r.randn(B, S, H, P) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(r.randn(B, S, H))).astype(np.float32)  # softplus
    A = (-np.exp(r.randn(H) * 0.5)).astype(np.float32)
    Bm = (r.randn(B, S, G, N) * 0.5).astype(np.float32)
    Cm = (r.randn(B, S, G, N) * 0.5).astype(np.float32)
    D = r.randn(H).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def spy(monkeypatch, module, name):
    """Wrap ``module.name`` so each call records ``(args, result)``."""
    real, calls = getattr(module, name), []

    def wrapped(*args, **kw):
        calls.append((args, real(*args, **kw)))
        return calls[-1][1]

    monkeypatch.setattr(module, name, wrapped)
    return calls


# ---------------------------------------------------------------- configs
def test_config_copy_equals_reference():
    names = ["mixtral-8x7b", "arctic-480b", MODEL, "recurrentgemma-2b",
             "yi-6b", "qwen1.5-0.5b", "qwen2-72b", "minitron-8b",
             "qwen2-vl-2b", "hubert-xlarge"]
    for name in names:
        ref, port = rcfg.get_config(name), tcfg.get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(tcfg.reduced(port)) == \
            dataclasses.asdict(rcfg.reduced(ref))
        assert port.pattern_for_depth() == ref.pattern_for_depth()
        assert port.params_dense == ref.params_dense
    assert tcfg.config_names() == sorted(names + tcfg.PORT_ARCHS)
    assert tcfg.ALL_ARCHS == names == rcfg.ALL_ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("qwen2-vl-7b")


# -------------------------------------------------------------- SSD (K6)
@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_matches_reference_kernel_interpret(case, monkeypatch):
    B, S, H, P, G, N, chunk = case
    j, t = both(ssd_inputs(B, S, H, P, G, N))
    y_r, h_r = rops.ssd(*j, chunk=chunk, impl="interpret")
    y_p, h_p = tssd.ssd_chunked_plain(*t, chunk=chunk)
    close(y_p, y_r, KERNEL_TOL)
    close(h_p, h_r, KERNEL_TOL)
    # the wrapper takes the plain version for CPU tensors, uncounted: held
    # by a spy, since two calls of the plain version on a multithreaded
    # CPU BLAS may split their reductions differently
    calls = spy(monkeypatch, tssd, "ssd_chunked_plain")
    n = tssd.ssd_chunked.launches
    out = tssd.ssd_chunked(*t, chunk=chunk)
    assert tssd.ssd_chunked.launches == n
    assert len(calls) == 1 and out is calls[0][1]
    assert all(a is b for a, b in zip(calls[0][0], t))


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_matches_chunked_oracle(case):
    B, S, H, P, G, N, chunk = case
    j, t = both(ssd_inputs(B, S, H, P, G, N, seed=1))
    y_r, h_r = rref.ssd_chunked_ref(*j, chunk=chunk, return_state=True)
    y_p, h_p = tssd.ssd_chunked_plain(*t, chunk=chunk)
    close(y_p, y_r, ORACLE_TOL)
    close(h_p, h_r, ORACLE_TOL)
    y_o, h_o = tref.ssd_chunked_ref(*t, chunk=chunk, return_state=True)
    close(y_o, y_r, ORACLE_TOL)
    close(h_o, h_r, ORACLE_TOL)


@pytest.mark.parametrize("case", SSD_CASES[:3])
def test_sequential_oracle_matches_reference(case):
    B, S, H, P, G, N, _ = case
    j, t = both(ssd_inputs(B, S, H, P, G, N, seed=2))
    h0 = np.random.RandomState(3).randn(B, H, P, N).astype(np.float32)
    y_r, h_r = rref.ssd_ref(*j, h0=jnp.asarray(h0), return_state=True)
    y_t, h_t = tref.ssd_ref(*t, h0=torch.from_numpy(h0), return_state=True)
    close(y_t, y_r, ORACLE_TOL)
    close(h_t, h_r, ORACLE_TOL)


def test_bf16_edge_rounds_like_reference_kernel():
    """y is rounded to x's type before D x is added (``ssd.py:134-137``):
    within one bf16 ulp of the reference kernel in interpret mode."""
    x, dt, A, Bm, Cm, D = ssd_inputs(1, 64, 4, 16, 2, 8, seed=4)
    jx, jb, jc = (jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm))
    y_r, h_r = rops.ssd(jx, jnp.asarray(dt), jnp.asarray(A), jb, jc,
                        jnp.asarray(D), chunk=32, impl="interpret")
    tx, tb, tc = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    y_p, h_p = tssd.ssd_chunked_plain(tx, torch.from_numpy(dt),
                                      torch.from_numpy(A), tb, tc,
                                      torch.from_numpy(D), chunk=32)
    assert y_p.dtype == torch.bfloat16 and h_p.dtype == torch.float32
    y_r = np.asarray(y_r, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(y_r), 1e-30))) - 7)
    assert np.all(np.abs(y_p.float().numpy() - y_r) <= ulp + 1e-6)
    close(h_p, h_r, KERNEL_TOL)


def test_ragged_padding_keeps_final_state_exact():
    """ops.ssd pads S up to a chunk multiple with dt = 0 (as
    ``test_kernels.py::test_ssd_ragged_padding``)."""
    j, t = both(ssd_inputs(1, 100, 2, 8, 1, 4, seed=3)[:5])
    y_p, h_p = tops.ssd(*t, chunk=32)
    y_s, h_s = tref.ssd_ref(*t, return_state=True)
    close(y_p, y_s, 2e-4)
    close(h_p, h_s, 2e-4)
    y_r, h_r = rops.ssd(*j, chunk=32, impl="ref")
    close(y_p, y_r, ORACLE_TOL)
    close(h_p, h_r, ORACLE_TOL)
    for impl in ("plain", "ref"):
        y_i, h_i = tops.ssd(*t, chunk=32, impl=impl)
        close(y_i, y_p, ORACLE_TOL)
        close(h_i, h_p, ORACLE_TOL)


DECODE_CASES = [  # B, S, H, P, G, N, with D: the first as the reference's
    (2, 16, 2, 8, 1, 4, False),
    (2, 16, 4, 8, 2, 6, True),
    (3, 8, 6, 4, 3, 16, True),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_step_matches_scan(case):
    """One token at a time from the carried state equals the full scan (as
    ``test_kernels.py::test_ssd_decode_step_matches_scan``), with the
    state updated in place and returned; groups above 1 and the D skip
    too."""
    *shape, with_d = case
    B, S, H, P, G, N = shape
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a)
                           for a in ssd_inputs(*shape, seed=5))
    D = D if with_d else None
    y_full, h_full = tref.ssd_ref(x, dt, A, Bm, Cm, D, return_state=True)
    h = torch.zeros(B, H, P, N)
    ys = []
    for s in range(S):
        sl = slice(s, s + 1)
        y_t, h_t = tops.ssd_decode_step(x[:, sl], dt[:, sl], A, Bm[:, sl],
                                        Cm[:, sl], h, D)
        assert h_t is h
        ys.append(y_t)
    close(torch.cat(ys, dim=1), y_full, 2e-4)
    close(h, h_full, 2e-4)
    j = [jnp.asarray(a.numpy()) for a in (x, dt, A, Bm, Cm)]
    y_r, h_r = rops.ssd_decode_step(*(a[:, :1] for a in j[:2]), j[2],
                                    *(a[:, :1] for a in j[3:]),
                                    jnp.zeros((B, H, P, N)),
                                    None if D is None else jnp.asarray(D))
    y_t, h_t = tops.ssd_decode_step(x[:, :1], dt[:, :1], A, Bm[:, :1],
                                    Cm[:, :1], torch.zeros(B, H, P, N), D)
    close(y_t, y_r, ORACLE_TOL)
    close(h_t, h_r, ORACLE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_d", [False, True])
def test_decode_step_updates_the_state_in_place(dtype, with_d):
    """``ops.ssd_decode_step`` writes the new state into the tensor it was
    given and returns that tensor, with ``ssd_ref``'s values bit for bit
    (x, B and C in float32 or bf16, the state float32)."""
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a)
                           for a in ssd_inputs(3, 1, 4, 8, 2, 16, seed=8))
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    D = D if with_d else None
    h0 = torch.from_numpy(np.random.RandomState(9).randn(3, 4, 8, 16)
                          .astype(np.float32))
    h = h0.clone()
    ptr = h.data_ptr()
    y_want, h_want = tref.ssd_ref(x, dt, A, Bm, Cm, D, h0=h0,
                                  return_state=True)
    y, h_out = tops.ssd_decode_step(x, dt, A, Bm, Cm, h, D)
    assert h_out is h and h.data_ptr() == ptr
    assert y.dtype == dtype and torch.equal(y, y_want)
    assert torch.equal(h, h_want) and not torch.equal(h, h0)


def test_decode_step_rejects_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a)
                           for a in ssd_inputs(2, 1, 4, 8, 1, 4))
    h = torch.zeros(2, 4, 8, 4)
    with pytest.raises(ValueError, match="the state must be"):
        tops.ssd_decode_step(x, dt, A, Bm, Cm, h[:1])
    with pytest.raises(ValueError, match="must be float32"):
        tops.ssd_decode_step(x, dt, A, Bm, Cm, h.double())
    with pytest.raises(ValueError, match="multiple of groups"):
        tops.ssd_decode_step(x, dt, A, Bm.expand(-1, -1, 3, -1),
                             Cm.expand(-1, -1, 3, -1), h)
    with pytest.raises(ValueError, match="x must be"):
        tops.ssd_decode_step(x.expand(-1, 2, -1, -1), dt, A, Bm, Cm, h)
    with pytest.raises(ValueError, match="all three alike"):
        tops.ssd_decode_step(x.bfloat16(), dt, A, Bm, Cm, h)
    with pytest.raises(ValueError, match="all three alike"):
        tops.ssd_decode_step(x, dt, A, Bm, Cm.bfloat16(), h)


def copy_as_before(monkeypatch):
    """The decode step as it was before it updated in place: ``ssd_ref``'s
    new state, copied into the cache by ``_write``."""
    monkeypatch.setattr(
        tops, "ssd_decode_step",
        lambda x, dt, A, Bm, Cm, h, D=None: tref.ssd_ref(
            x, dt, A, Bm, Cm, D, h0=h, return_state=True))
    monkeypatch.setattr(TM, "_same_memory", lambda a, b: False)


def mamba_states(caches, cfg):
    layers = (caches.layer(i) for i in range(cfg.num_layers)) \
        if isinstance(caches, LayerCache) else caches
    return [c.state for c in layers if c.state is not None]


@pytest.mark.parametrize("name", ["granite-4.0-h-small", MODEL])
def test_decode_leaves_each_mamba_state_in_place(name, monkeypatch):
    """A prefill then three decode steps through ``model.forward``: each
    Mamba layer's cache keeps its state tensor, updated in place and not
    copied onto itself (Granite's cut: a list of caches; Mamba-2's: a
    scanned stack), and the logits and states equal those of the step as
    it was, whose new state ``_write`` copied into the cache."""
    cfg = tcfg.reduced(tcfg.get_config(name))
    params = TM.init_model(cfg, 0, "cpu")
    toks = torch.from_numpy(tokens(2, 6, seed=3, vocab=cfg.vocab_size)).long()

    def run():
        caches = init_caches(cfg, 2, 32, device="cpu")
        if TM.scanned(cfg):
            caches = stack_caches(caches)
        lg, caches = TM.forward(params, cfg, toks, caches=caches,
                                last_token_only=True)
        ptrs = [t.data_ptr() for t in mamba_states(caches, cfg)]
        out = []
        for step in range(3):
            before = [t.clone() for t in mamba_states(caches, cfg)]
            nxt = lg[:, -1].argmax(-1)[:, None]
            lg, caches = TM.forward(params, cfg, nxt, caches=caches,
                                    pos=6 + step, last_token_only=True)
            states = mamba_states(caches, cfg)
            assert [t.data_ptr() for t in states] == ptrs
            assert all(not torch.equal(t, b) for t, b in zip(states, before))
            out.append((lg.clone(), [t.clone() for t in states]))
        return out

    skipped = []
    same = TM._same_memory
    monkeypatch.setattr(TM, "_same_memory",
                        lambda a, b: skipped.append(same(a, b)) or same(a, b))
    got = run()
    n_ssm = sum(k in ("ssd", "ssd_moe") for k in cfg.pattern_for_depth())
    # the prefill's states are new tensors; each decode step's are the
    # cache's own
    assert sum(skipped) == 3 * n_ssm > 0
    monkeypatch.undo()
    copy_as_before(monkeypatch)
    want = run()
    for (lg, states), (lg_w, states_w) in zip(got, want):
        assert torch.equal(lg, lg_w)
        assert all(torch.equal(a, b) for a, b in zip(states, states_w))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a)
                           for a in ssd_inputs(1, 256, 2, 8, 1, 4))
    with pytest.raises(ValueError, match="chunk must be in 1..128"):
        tssd.ssd_chunked(x, dt, A, Bm, Cm, chunk=256)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tssd.ssd_chunked(x[:, :100], dt[:, :100], A, Bm[:, :100],
                         Cm[:, :100], chunk=64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tssd.ssd_chunked(x.double(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="dt and A must be float32"):
        tssd.ssd_chunked(x, dt.to(torch.bfloat16), A, Bm, Cm)
    with pytest.raises(ValueError, match="multiple of groups"):
        tssd.ssd_chunked(x, dt, A, Bm.expand(-1, -1, 3, -1),
                         Cm.expand(-1, -1, 3, -1))
    with pytest.raises(ValueError, match="no SSD kernel for device meta"):
        tssd.ssd_chunked(*(a.to("meta") for a in (x, dt, A, Bm, Cm)))
    with pytest.raises(ValueError, match="unknown impl"):
        tops.ssd(x, dt, A, Bm, Cm, impl="interpret")
    # chunk = min(chunk, S): a 37-token sequence is one chunk of 37
    y, h = tops.ssd(x[:, :37], dt[:, :37], A, Bm[:, :37], Cm[:, :37])
    assert y.shape == (1, 37, 2, 8) and h.shape == (1, 2, 8, 4)


# ------------------------------------- K6's bf16 kernel, emulated on the CPU
# the card's K6 shapes (chip_smoke.py's SSD_CASES, then SSD_SERVE: the
# full-width Mamba-2 2.7B prefill of 37, 128, 384, 1024 and 1536 tokens),
# all in bf16
CARD_CASES = SSD_CASES + [(1, S, 80, 64, 1, 128, min(S, 128))
                          for S in (37, 128, 384, 1024, 1536)]
CARD_TOL = 1e-4  # |y - y_plain| <= CARD_TOL (1 + |y_plain|) + a bf16 ulp


def warp_scan_cumsum(la):
    """Inclusive cumsum over dim -2 (a chunk of Q <= 128 rows) in the
    order of ``ssd_sm90.cuh::chunk_cumsum``: 32 lanes sum four rows each in
    order, a Hillis-Steele scan adds the lanes' totals, and each row adds
    the total of the lanes before its own (every add rounded to float32)."""
    Q = la.shape[-2]
    pad = la.new_zeros(la.shape[:-2] + (128 - Q, la.shape[-1]))
    v = torch.cat([la, pad], -2).unflatten(-2, (32, 4))
    runs = [v[..., 0, :]]
    for k in range(1, 4):
        runs.append(runs[-1] + v[..., k, :])
    v = torch.stack(runs, -2)
    t = v[..., 3, :]
    off = 1
    while off < 32:
        t = t + torch.nn.functional.pad(t, (0, 0, off, 0))[..., :32, :]
        off *= 2
    before = torch.nn.functional.pad(t, (0, 0, 1, 0))[..., :32, :]
    return (before[..., None, :] + v).flatten(-3, -2)[..., :Q, :]


def as_terms(v, terms):
    """A float32 operand as the tensor cores take it: ``terms`` = 2 sums
    bf16(v) and bf16(v - bf16(v)), 1 takes bf16(v) alone, None leaves v."""
    if terms is None:
        return v
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float() if terms == 2 else hi


def tensor_core_k6(x, dt, A, Bm, Cm, chunk, terms=(2, 2, 2)):
    """The arithmetic of ``ssd_sm90.cuh`` in plain torch -> (y float32,
    final state): cum by the warp scan; (a) local states x^T (B w) with
    w = exp(cum_last - cum) dt; (b) h_in[c + 1] = exp(cum_last) h_in[c] +
    local[c]; (c) y = (C h_in^T) exp(cum_i) + (C B^T exp(cum_i - cum_j)
    dt_j [j <= i]) x.  Products of bf16 values are exact in float32; the
    float32 operands, ``terms`` for (the scores, h_in, x w), go as two bf16
    terms, one, or (None) as they are."""
    t_s, t_h, t_w = terms
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, Q = S // chunk, chunk
    xf = x.float().reshape(Bsz, nc, Q, H, P)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    Bf = Bm.float().repeat_interleave(H // G, 2).reshape(Bsz, nc, Q, H, N)
    Cf = Cm.float().repeat_interleave(H // G, 2).reshape(Bsz, nc, Q, H, N)
    cum = warp_scan_cumsum(dtf * A.float())                  # (B, nc, Q, H)
    last = cum[:, :, -1]
    w = torch.exp(last[:, :, None] - cum) * dtf
    local = torch.einsum("bcjhp,bcjhn->bchpn",
                         as_terms(xf * w[..., None], t_w), Bf)
    decay = torch.exp(last)
    h = torch.zeros(Bsz, H, P, N)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + local[:, c]
    h_in = torch.stack(h_in, 1)                              # (B, nc, H, P, N)
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    cumh = cum.transpose(2, 3)                               # (B, nc, H, Q)
    seg = torch.where(tri, cumh[..., :, None] - cumh[..., None, :], 0.0)
    s = torch.einsum("bcihn,bcjhn->bchij", Cf, Bf)
    s = torch.where(tri, s * torch.exp(seg)
                    * dtf.transpose(2, 3)[..., None, :], 0.0)
    intra = torch.einsum("bchij,bcjhp->bcihp", as_terms(s, t_s), xf)
    inter = torch.einsum("bcihn,bchpn->bcihp", Cf, as_terms(h_in, t_h))
    y = inter * torch.exp(cum)[..., None] + intra
    return y.reshape(Bsz, S, H, P), h


def bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2 ** -126)))
                      - 7)


def bf16_inputs(B, S, H, P, G, N, seed=0):
    x, dt, A, Bm, Cm, _ = (torch.from_numpy(a)
                           for a in ssd_inputs(B, S, H, P, G, N, seed))
    return (x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16),
            Cm.to(torch.bfloat16))


def meets_card_tolerance(got, want):
    """(y ok, state ok): a bf16 y within CARD_TOL (1 + |y_plain|) plus one
    bf16 ulp, the float32 state within CARD_TOL (1 + |h_plain|)."""
    (y, h), (y_p, h_p) = got, want
    ref = y_p.float()
    y_ok = ((y.to(torch.bfloat16).float() - ref).abs()
            <= CARD_TOL * (1 + ref.abs()) + bf16_ulp(ref)).all()
    h_ok = ((h - h_p).abs() <= CARD_TOL * (1 + h_p.abs())).all()
    return bool(y_ok), bool(h_ok)


# each float32 operand as one bf16 term, the other two as two
ONE_TERM = {"scores": (1, 2, 2), "h_in": (2, 1, 2), "x w": (2, 2, 1)}


@pytest.mark.parametrize("case", CARD_CASES + ["ragged"])
def test_tensor_core_arithmetic_meets_the_card_tolerance(case, monkeypatch):
    """Every float32 operand as two bf16 terms keeps y and the state within
    the card's tolerance of ``ssd_chunked_plain`` on the same bf16 inputs,
    at every card shape and at a ragged S = 100 through ``ops.ssd``; and
    each of the three splits is needed: with that operand as one bf16 term
    y or the state misses the tolerance at some shape (``test_each_split_
    is_needed``)."""
    if case == "ragged":  # ops.ssd pads S = 100 to chunks of 32
        args = bf16_inputs(1, 100, 4, 16, 2, 8, seed=7)
        want = tops.ssd(*args, chunk=32, impl="plain")
        monkeypatch.setattr(tssd, "ssd_chunked_plain",
                            lambda *a, chunk, **_: tensor_core_k6(*a[:5],
                                                                  chunk))
        got = tops.ssd(*args, chunk=32, impl="plain")
        assert got[0].shape == (1, 100, 4, 16)
    else:
        *shape, chunk = case
        args = bf16_inputs(*shape)
        want = tssd.ssd_chunked_plain(*args, chunk=chunk)
        got = tensor_core_k6(*args, chunk)
    assert meets_card_tolerance(got, want) == (True, True)


def test_each_split_is_needed():
    """One bf16 term for the scores, for h_in or for x w misses the card's
    tolerance (y or the state) at some card shape, where two terms meet it
    (above)."""
    for name, terms in ONE_TERM.items():
        misses = []
        for case in CARD_CASES[:5]:
            *shape, chunk = case
            args = bf16_inputs(*shape)
            ok = meets_card_tolerance(
                tensor_core_k6(*args, chunk, terms),
                tssd.ssd_chunked_plain(*args, chunk=chunk))
            if not all(ok):
                misses.append(case)
        assert misses, f"{name} as one bf16 term meets the tolerance"


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunk_parallel_passes_match_plain_and_reference(case):
    """Passes (a)-(c) in float32 (no bf16 rounding; the warp scan's cumsum,
    the chunk states, the state pass) give ``ssd_chunked_plain``'s y and
    final state within 1e-4, and the reference's Pallas kernel's in
    interpret mode within 1e-4 too."""
    B, S, H, P, G, N, chunk = case
    j, t = both(ssd_inputs(B, S, H, P, G, N, seed=8)[:5])
    y, h = tensor_core_k6(*t, chunk, terms=(None, None, None))
    y_p, h_p = tssd.ssd_chunked_plain(*t, chunk=chunk)
    close(y, y_p, ORACLE_TOL)
    close(h, h_p, ORACLE_TOL)
    y_r, h_r = rops.ssd(*j, chunk=chunk, impl="interpret")
    close(y, y_r, ORACLE_TOL)
    close(h, h_r, ORACLE_TOL)


def test_warp_scan_cumsum_is_an_inclusive_cumsum():
    la = torch.from_numpy(np.random.RandomState(9).randn(3, 128, 2)
                          .astype(np.float32))
    for Q in (1, 37, 128):
        close(warp_scan_cumsum(la[:, :Q]), torch.cumsum(la[:, :Q], 1), 1e-5)


# ------------------------------------------------------ block and model
@pytest.fixture(scope="module")
def reduced_pair():
    """The reduced Mamba-2 (2 layers, d_model 128, float32): the
    reference's weights, and the same weights carried into the port."""
    rc = rcfg.reduced(rcfg.get_config(MODEL))
    tc = tcfg.reduced(tcfg.get_config(MODEL))
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tree = jax.tree.map(np.asarray, params)
    return (dataclasses.replace(rc, kernel_impl="interpret"), params, tc,
            params_from_jax(tree, tc, device="cpu"))


def tokens(B, S, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def block_params(params, i=0):
    return jax.tree.map(lambda a: a[i], params["blocks_scanned"]["ssd"])


def test_ssd_block_matches_reference(reduced_pair):
    rc, rp, tc, tp = reduced_pair
    rblock = block_params(rp)
    tblock = TM.layer_params(tp, tc)[0]["ssd"]
    x = (np.random.RandomState(6).randn(2, 37, rc.d_model) * 0.5).astype(
        np.float32)
    out_r, _ = RS.apply_ssd_block(rblock, jnp.asarray(x), rc,
                                  kernel_impl="interpret")
    out_t, new = TS.apply_ssd_block(tblock, torch.from_numpy(x), tc)
    assert new is None
    close(out_t, out_r, ORACLE_TOL)
    # prefill into a cache, then a decode step from it
    rcache = rinit_caches(rc, 2, 64)[0]
    out_r, rnew = RS.apply_ssd_block(rblock, jnp.asarray(x), rc, cache=rcache,
                                     kernel_impl="interpret")
    tcache = init_caches(tc, 2, 64, device="cpu")[0]
    out_t, tnew = TS.apply_ssd_block(tblock, torch.from_numpy(x), tc,
                                     cache=tcache)
    close(out_t, out_r, ORACLE_TOL)
    for f in ("conv_x", "conv_bc", "state"):
        close(tnew[f], getattr(rnew, f), ORACLE_TOL)
    TM._write(tcache, tnew)
    x1 = x[:, :1] * 0.7
    out_r, rnew = RS.apply_ssd_block(rblock, jnp.asarray(x1), rc, cache=rnew)
    out_t, tnew = TS.apply_ssd_block(tblock, torch.from_numpy(x1), tc,
                                     cache=tcache)
    close(out_t, out_r, ORACLE_TOL)
    for f in ("conv_x", "conv_bc", "state"):
        close(tnew[f], getattr(rnew, f), ORACLE_TOL)


def test_forward_no_cache_matches_reference(reduced_pair):
    rc, rp, tc, tp = reduced_pair
    toks = tokens(2, 40)
    lg_r, _, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks))
    lg_t, caches = TM.forward(tp, tc, torch.from_numpy(toks))
    assert caches is None and lg_t.shape == (2, 40, 512)
    close(lg_t, lg_r, ORACLE_TOL)
    lg_r, _, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks),
                            last_token_only=True)
    lg_t, _ = TM.forward(tp, tc, torch.from_numpy(toks), last_token_only=True)
    close(lg_t, lg_r, ORACLE_TOL)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("S", [2, 5, 37])
def test_prefill_then_decode_matches_reference(reduced_pair, stacked, S):
    """Prefill into a cache, then 4 decode steps; logits and caches within
    1e-4 of the reference.  S = 2 pins the reference's conv tails of a
    prompt shorter than the conv window: the one tail row lands in the
    cache's leading row (the reference's scan writes it with
    ``dynamic_update_index_in_dim``), and the port does the same."""
    rc, rp, tc, tp = reduced_pair
    toks = tokens(2, S, seed=S)
    rcaches = rinit_caches(rc, 2, 64)
    lg_r, rcaches, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks),
                                  caches=rcaches, last_token_only=True)
    tcaches = init_caches(tc, 2, 64, device="cpu")
    if stacked:
        tcaches = stack_caches(tcaches)
    lg_t, tcaches = TM.forward(tp, tc, torch.from_numpy(toks), caches=tcaches,
                               last_token_only=True)
    close(lg_t, lg_r, ORACLE_TOL)
    rc_decode = dataclasses.replace(rc, kernel_impl="auto")
    for step in range(4):
        nxt = np.asarray(jnp.argmax(lg_r[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(nxt, lg_t[:, -1].argmax(-1).numpy()[:, None])
        lg_r, rcaches, _ = RM.forward(rp, rc_decode, tokens=jnp.asarray(nxt),
                                      caches=rcaches, pos=S + step,
                                      last_token_only=True)
        lg_t, tcaches = TM.forward(tp, tc, torch.from_numpy(nxt),
                                   caches=tcaches, pos=S + step,
                                   last_token_only=True)
        close(lg_t, lg_r, ORACLE_TOL)
    per_layer = ([tcaches.layer(i) for i in range(tc.num_layers)]
                 if stacked else tcaches)
    for rl, tl in zip(rcaches, per_layer):
        for f in ("conv_x", "conv_bc", "state"):
            close(getattr(tl, f), getattr(rl, f), ORACLE_TOL)


def test_short_prompt_conv_tail_lands_in_leading_rows(reduced_pair):
    rc, rp, tc, tp = reduced_pair
    toks = tokens(1, 2, seed=9)
    _, rcaches, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks),
                               caches=rinit_caches(rc, 1, 64))
    _, tcaches = TM.forward(tp, tc, torch.from_numpy(toks),
                            caches=init_caches(tc, 1, 64, device="cpu"))
    for rl, tl in zip(rcaches, tcaches):
        conv = np.asarray(rl.conv_x)
        assert np.abs(conv[0, 0]).sum() > 0 and not conv[0, 1:].any()
        close(tl.conv_x, conv, ORACLE_TOL)


# ------------------------------------------------- init and conversion
def test_init_model_matches_reference_layout():
    tc = tcfg.reduced(tcfg.get_config(MODEL))
    rc = rcfg.reduced(rcfg.get_config(MODEL))
    rp, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tp = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    flat_r = {"/".join(str(k.key) for k in path): leaf for path, leaf
              in jax.tree_util.tree_flatten_with_path(rp)[0]}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    flat_t = dict(flat(tp))
    assert set(flat_t) == set(flat_r)
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_r[k].shape, k
    blk = tp["blocks_scanned"]["ssd"]
    dt0 = torch.nn.functional.softplus(blk["dt_bias"])
    assert dt0.min() >= 1e-3 * 0.999 and dt0.max() <= 0.1 * 1.001
    a0 = torch.exp(blk["A_log"])
    assert a0.min() >= 1.0 and a0.max() <= 16.0
    assert blk["wz"].abs().max() <= 2.0 / np.sqrt(tc.d_model) + 1e-6
    again = TM.init_model(tc, 0, device="cpu")
    assert torch.equal(again["blocks_scanned"]["ssd"]["wo"], blk["wo"])


def test_bf16_weights_carry_across_bitwise():
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config(MODEL)),
                             dtype="bfloat16")
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(MODEL)),
                             dtype="bfloat16")
    rp, _ = split_leaves(RM.init_model(jax.random.PRNGKey(1), rc))
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tc, device="cpu")
    got = tp["blocks_scanned"]["ssd"]["wx"]
    want = np.asarray(rp["blocks_scanned"]["ssd"]["wx"], np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_params_from_jax_rejects_a_foreign_tree(reduced_pair):
    rc, rp, tc, _ = reduced_pair
    tree = jax.tree.map(np.asarray, rp)
    bad = dict(tree, head={"table": tree["embed"]["table"]})
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, tc, device="cpu")
    wide = dataclasses.replace(tc, d_model=64)
    with pytest.raises(ValueError, match="expects"):
        params_from_jax(tree, wide, device="cpu")


def test_other_block_kinds_name_their_slice():
    """Every block kind of the reference builds (``moe`` since the MoE
    slice, here in a heterogeneous stack with its cache), and so does a
    modality frontend (inputs as embeddings) since the training slice; a
    block kind the reference lacks is refused by name."""
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config(MODEL)),
                              block_pattern=("attn", "moe"), num_experts=4,
                              num_experts_per_tok=2)
    params = TM.init_model(cfg, 0, device="cpu")
    assert [sorted(b) for b in params["blocks"]] == [
        ["attn", "mlp", "norm1", "norm2"], ["attn", "moe", "norm1", "norm2"]]
    assert [c.kind for c in init_caches(cfg, 1, 8, device="cpu")] == \
        ["full", "full"]
    logits, _ = TM.forward(params, cfg, torch.zeros(1, 3, dtype=torch.long))
    assert logits.shape == (1, 3, cfg.vocab_size)
    vlm = dataclasses.replace(cfg, block_pattern=("attn",),
                              frontend="vision")
    logits, _ = TM.forward(TM.init_model(vlm, 0, device="cpu"), vlm,
                           embeds=torch.zeros(1, 3, vlm.d_model))
    assert logits.shape == (1, 3, vlm.vocab_size)
    odd = dataclasses.replace(cfg, block_pattern=("attn", "xattn"))
    with pytest.raises(NotImplementedError, match="'xattn' is not ported"):
        TM.init_model(odd, 0, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = tcfg.reduced(tcfg.get_config(MODEL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_model(tc, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, tc)
    assert TM.init_model(tc, 0, device="cpu")["embed"]["table"].is_cpu


def test_layer_cache_views_write_through():
    tc = tcfg.reduced(tcfg.get_config(MODEL))
    stacked = stack_caches(init_caches(tc, 2, 8, device="cpu"))
    assert isinstance(stacked, LayerCache)
    assert stacked.state.shape == (tc.num_layers, 2, 16, 16, 16)
    stacked.layer(1).state[0].fill_(3.0)
    assert float(stacked.state[1, 0].min()) == 3.0
    assert float(stacked.state[0].abs().max()) == 0.0
    assert stacked.kind == "ssm"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_rounding_cascade_dwarfs_f32_drift(dtype, monkeypatch):
    """Why a bf16 forward cannot hold K6 tightly to its plain version: a
    64-layer Mamba-2 (d_model 256) whose SSD output is changed by 1e-6
    relative before it is rounded to the model dtype.  In float32 the last
    logits move by a few 1e-6 (relative L2); in bf16 the change flips about
    one y element in 10^4 by one ulp, and the bf16 rounding of every later
    projection and residual carries that to ~5e-2."""
    base = tcfg.reduced(tcfg.get_config(MODEL))
    cfg = dataclasses.replace(base, num_layers=64, d_model=256, ssm_state=64,
                              ssm_headdim=32, ssm_chunk=64, dtype=dtype,
                              vocab_size=2048, kernel_impl="plain")
    params = TM.init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(1, 300, vocab=2048).astype(np.int64))
    clean, _ = TM.forward(params, cfg, toks, last_token_only=True)
    plain, gen = tssd.ssd_chunked_plain, torch.Generator().manual_seed(1)

    def nudged(x, dt, A, Bm, Cm, D=None, chunk=128):
        y, h = plain(x.float(), dt, A, Bm.float(), Cm.float(), None, chunk)
        y = y * (1 + 1e-6 * torch.randn(y.shape, generator=gen))
        return tssd._with_skip(y.to(x.dtype), x, D), h

    monkeypatch.setattr(tssd, "ssd_chunked_plain", nudged)
    moved, _ = TM.forward(params, cfg, toks, last_token_only=True)
    rel = ((moved.float() - clean.float()).norm() / clean.float().norm())
    if dtype == "float32":
        assert rel < 1e-4
    else:
        assert rel > 1e-2
