"""The port's dense attention configurations against the reference, on the
CPU: Yi-6B (GQA, RoPE theta 5e6), Minitron-8B (GQA, the non-gated GELU
MLP with biases) and Qwen2-72B (GQA, QKV bias, RoPE theta 1e6).

Each at ``reduced(...)`` (2 stacked attention layers, float32) gets the
reference's weights through ``params_from_jax``; inputs are made with
numpy from a seed.  The no-cache forward and a B=2 prefill followed by
decode steps must agree with the reference within ``TOL`` (float32 on
both sides, sums in another order), and the port's engine must give the
reference engine's tokens and ``stats``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.cache import init_caches as rinit_caches  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.cache import init_caches, stack_caches  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = 1e-4  # float32 against float32, sums in another order
DENSE = ["yi-6b", "minitron-8b", "qwen2-72b"]
REQS = [([1, 2, 3], 6), ([7, 8, 9], 5), ([9], 4)]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    """(reference cfg, reference params, port cfg, port params)."""
    rc = rcfg.reduced(rcfg.get_config(request.param))
    tc = tcfg.reduced(tcfg.get_config(request.param))
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return rc, params, tc, tp


def tokens(B, S, seed):
    return np.random.RandomState(seed).randint(0, 512, (B, S)).astype(
        np.int32)


def test_config_and_layout(dense):
    rc, rp, tc, tp = dense
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    assert TM.scanned(tc) and set(tc.pattern_for_depth()) == {"attn"}
    mlp = tp["blocks_scanned"]["mlp"]
    assert sorted(mlp) == (["wi_gate", "wi_up", "wo"] if tc.mlp_gated
                           else ["bi", "bo", "wi", "wo"])
    assert ("bq" in tp["blocks_scanned"]["attn"]) == tc.qkv_bias
    assert tp["blocks_scanned"]["attn"]["wk"].shape[2] == tc.num_kv_heads


def test_forward_no_cache_matches_reference(dense):
    rc, rp, tc, tp = dense
    toks = tokens(2, 24, seed=1)
    lg_r, _, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks))
    lg_t, caches = TM.forward(tp, tc, torch.from_numpy(toks))
    assert caches is None and lg_t.shape == (2, 24, 512)
    close(lg_t, lg_r)


def test_prefill_then_decode_matches_reference(dense):
    """B=2 prefill of 9 tokens into full caches (max_len 32, scalar
    cursor), then 4 decode steps fed the reference's greedy tokens."""
    rc, rp, tc, tp = dense
    S = 9
    toks = tokens(2, S, seed=S)
    rcaches = rinit_caches(rc, 2, 32)
    tcaches = stack_caches(init_caches(tc, 2, 32, device="cpu"))
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


def test_engine_matches_the_reference_engine(dense):
    rc, rp, tc, tp = dense
    got, want = [], []
    for cls, cfg, params, out in ((RefEngine, rc, rp, want),
                                  (ServeEngine, tc, tp, got)):
        eng = cls(cfg, params, batch_slots=2, max_len=32, chunk_size=4)
        rids = [eng.submit(np.array(p), max_new_tokens=m) for p, m in REQS]
        res = eng.run()
        out.append(([[int(t) for t in res[r]] for r in rids], eng.stats))
    assert got == want
    assert [len(t) for t in got[0][0]] == [m for _, m in REQS]
