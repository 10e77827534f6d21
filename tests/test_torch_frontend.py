"""The two configurations with a modality frontend against the reference,
on the CPU: Qwen2-VL-2B's text backbone (GQA 6, QKV bias, M-RoPE with
coincident streams, tied embeddings) and the encoder-only HuBERT X-Large
(non-causal attention at head size 80, LayerNorm, GELU MLP with biases).

Each at ``reduced(...)`` (2 layers, float32) gets the reference's weights
through ``params_from_jax``; inputs are numpy-seeded embeddings (B, S, d)
in place of tokens, as the data pipeline emits them.  The forward on
embeddings, with the MoE aux sums, must agree with
``repro.models.model.forward`` within ``TOL`` (float32 on both sides,
sums in another order); Qwen2-VL also on tokens, served as text.  K5's
plain version at D=80 (HuBERT's heads), causal and not, is held to the
reference's Pallas kernel in interpret mode at the reference's kernel-test
tolerance (``F32_TOL``), and a reduced HuBERT with ``head_dim=80`` to the
reference's forward.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = 1e-4  # float32 against float32, sums in another order
F32_TOL = 2e-5  # the reference's kernel-test tolerance in float32
FRONTENDS = ["qwen2-vl-2b", "hubert-xlarge"]


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


def pair(name: str, **changes):
    """(reference cfg, reference params, port cfg, port params)."""
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config(name)), **changes)
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config(name)), **changes)
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return rc, params, tc, tp


@pytest.fixture(scope="module", params=FRONTENDS)
def frontend(request):
    return pair(request.param)


def embeds(B, S, d, seed):
    return np.random.RandomState(seed).standard_normal((B, S, d)).astype(
        np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_config_copies_and_layout(frontend):
    rc, rp, tc, tp = frontend
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    full = tcfg.get_config(rc.name.replace("-smoke", ""))
    assert dataclasses.asdict(full) == dataclasses.asdict(
        rcfg.get_config(full.name))
    assert full.frontend in ("vision", "audio")
    attn = tp["blocks_scanned"]["attn"]
    assert attn["wk"].shape[2] == tc.num_kv_heads
    assert ("bq" in attn) == tc.qkv_bias
    assert ("head" in tp) == (not tc.tie_embeddings)


def test_forward_on_embeds_matches_reference(frontend):
    rc, rp, tc, tp = frontend
    e = embeds(2, 24, tc.d_model, seed=1)
    lg_r, _, aux_r = RM.forward(rp, rc, embeds=jnp.asarray(e))
    lg_t, caches, aux_t = TM.forward(tp, tc, embeds=torch.from_numpy(e),
                                     return_aux=True)
    assert caches is None and lg_t.shape == (2, 24, tc.vocab_size)
    close(lg_t, lg_r)
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert float(aux_t[k]) == float(aux_r[k]) == 0.0


def test_forward_needs_tokens_or_embeds(frontend):
    rc, rp, tc, tp = frontend
    with pytest.raises(ValueError, match="tokens or embeds"):
        TM.forward(tp, tc)
    with pytest.raises(ValueError, match="tokens or embeds"):
        TM.forward(tp, tc, torch.zeros(1, 2, dtype=torch.long),
                   embeds=torch.zeros(1, 2, tc.d_model))


def test_bf16_forward_casts_the_embeddings():
    """A bf16 model takes float32 embeddings and computes in bf16, as the
    reference casts them to ``cfg.dtype``."""
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config("hubert-xlarge")),
                             dtype="bfloat16")
    params = TM.init_model(tc, 0, device="cpu")
    lg, _ = TM.forward(params, tc, embeds=torch.ones(1, 4, tc.d_model))
    assert lg.dtype == torch.bfloat16 and torch.isfinite(lg.float()).all()


def test_qwen2_vl_served_as_text():
    """On tokens Qwen2-VL is a text model (M-RoPE with coincident position
    streams is 1-D RoPE): the forward matches the reference and the engine
    serves it; HuBERT, encoder-only, is refused by the engine."""
    rc, rp, tc, tp = pair("qwen2-vl-2b")
    toks = np.random.RandomState(2).randint(0, 512, (2, 20)).astype(np.int32)
    lg_r, _, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks))
    lg_t, _ = TM.forward(tp, tc, torch.from_numpy(toks))
    close(lg_t, lg_r)
    eng = ServeEngine(tc, tp, batch_slots=2, max_len=32, chunk_size=4)
    rid = eng.submit(np.array([5, 6, 7]), max_new_tokens=4)
    want = torch.argmax(TM.forward(tp, tc, torch.tensor([[5, 6, 7]]))[0][0, -1])
    assert eng.run()[rid][0] == int(want)
    hc = tcfg.reduced(tcfg.get_config("hubert-xlarge"))
    with pytest.raises(AssertionError, match="encoder-only"):
        ServeEngine(hc, TM.init_model(hc, 0, device="cpu"))


# --------------------------------------------------------- K5 at D = 80
@pytest.mark.parametrize("causal", [True, False])
def test_plain_at_head_size_80_matches_reference_kernel(causal):
    rs = np.random.RandomState(3)
    q, k, v = (rs.standard_normal((2, 128, 4, 80)).astype(np.float32)
               for _ in range(3))
    want = rops.attention(*(jnp.asarray(a) for a in (q, k, v)),
                          causal=causal, impl="interpret", block_q=64,
                          block_k=64)
    got = tfa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal)
    close(got, want, F32_TOL)
    assert 80 in tfa.HEAD_DIMS


def test_reduced_hubert_at_head_size_80_matches_reference():
    rc, rp, tc, tp = pair("hubert-xlarge", head_dim=80)
    assert tp["blocks_scanned"]["attn"]["wq"].shape[-1] == 80
    e = embeds(2, 32, tc.d_model, seed=4)
    lg_r, _, _ = RM.forward(rp, rc, embeds=jnp.asarray(e))
    lg_t, _ = TM.forward(tp, tc, embeds=torch.from_numpy(e))
    close(lg_t, lg_r)
