"""The port's attention, MLP and RG-LRU layers, the hybrid and dense models
and the serving engine against the reference package, on the CPU.

The reduced RecurrentGemma-2B (6 layers: rglru, rglru, local_attn twice;
window 32; float32) and reduced Qwen1.5-0.5B (2 attention layers, QKV
bias, stacked) get the reference's weights through ``params_from_jax``;
inputs are made with numpy from a seed.  Layers, blocks and logits must
agree within 1e-4 (float32 on both sides, sums in another order: the
port's log-depth RG-LRU scan, its K5 plain version against the Pallas
kernel in interpret mode); the engines must give the same tokens and
``stats``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import rglru as RG  # noqa: E402
from repro.models.cache import LayerCache as RCache  # noqa: E402
from repro.models.cache import init_caches as rinit_caches  # noqa: E402
from repro.models.cache import write_prompt as rwrite_prompt  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rglru as TG  # noqa: E402
from repro_torch.models.cache import LayerCache  # noqa: E402
from repro_torch.models.cache import init_caches, reset_slot  # noqa: E402
from repro_torch.models.cache import stack_caches  # noqa: E402
from repro_torch.models.cache import write_prompt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = 1e-4  # float32 against float32, sums in another order
GEMMA, QWEN = "recurrentgemma-2b", "qwen1.5-0.5b"


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


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def pair(name, seed=0):
    """(reference cfg, reference params, port cfg, port params), the
    reference's Pallas kernels in interpret mode."""
    rc = rcfg.reduced(rcfg.get_config(name))
    tc = tcfg.reduced(tcfg.get_config(name))
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(seed), rc))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return dataclasses.replace(rc, kernel_impl="interpret"), params, tc, tp


@pytest.fixture(scope="module")
def gemma():
    return pair(GEMMA)


@pytest.fixture(scope="module")
def qwen():
    return pair(QWEN)


def tokens(B, S, seed=0, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


def acts(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------- layers
def test_rope_matches_reference():
    x = acts((2, 11, 3, 32), 1)
    pos = np.stack([np.arange(11) + 5, np.arange(11) + 90]).astype(np.int32)
    for theta in (10000.0, 1e6):
        want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        close(got, want, 1e-5)


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("gelu", False)])
def test_mlp_matches_reference(act, gated):
    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config(QWEN)), act=act,
                             mlp_gated=gated)
    p = RL.init_mlp(jax.random.PRNGKey(2), rc)
    p = jax.tree.map(lambda l: l.value, p, is_leaf=RL.is_leaf)
    if not gated:  # nonzero biases
        p = dict(p, bi=p["bi"] + 0.1, bo=p["bo"] - 0.2)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = acts((2, 7, rc.d_model), 3)
    close(TL.apply_mlp(tp, torch.from_numpy(x), rc),
          RL.apply_mlp(p, jnp.asarray(x), rc))


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    close(TL._act("gelu", x), jax.nn.gelu(jnp.asarray(x.numpy())), 1e-6)
    assert (TL._act("gelu", x) - torch.nn.functional.gelu(x)).abs().max() \
        > 1e-5


def test_linear_scan_matches_a_loop():
    r = np.random.RandomState(4)
    a = torch.from_numpy(r.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.from_numpy(r.randn(2, 37, 5).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    close(TG.linear_scan(a, b), torch.stack(want, dim=1), 1e-5)


def gemma_layer(params, kind):
    cfg = rcfg.reduced(rcfg.get_config(GEMMA))
    i = cfg.pattern_for_depth().index(kind)
    return i, params["blocks"][i]


def test_rglru_block_prefill_and_decode_match_reference(gemma):
    rc, rp, tc, tp = gemma
    i, rblock = gemma_layer(rp, "rglru")
    tblock = tp["blocks"][i]
    x = acts((2, 37, rc.d_model), 6)
    out_r, _ = RG.apply_rglru_block(rblock["rec"], jnp.asarray(x), rc)
    out_t, new = TG.apply_rglru_block(tblock["rec"], torch.from_numpy(x), tc)
    assert new is None
    close(out_t, out_r)
    rcache = rinit_caches(rc, 2, 64)[i]
    out_r, rnew = RG.apply_rglru_block(rblock["rec"], jnp.asarray(x), rc,
                                       cache=rcache)
    tcache = init_caches(tc, 2, 64, device="cpu")[i]
    out_t, tnew = TG.apply_rglru_block(tblock["rec"], torch.from_numpy(x), tc,
                                       cache=tcache)
    close(out_t, out_r)
    for f in ("conv", "h"):
        close(tnew[f], getattr(rnew, f))
    TM._write(tcache, tnew, scan=False)
    x1 = x[:, :1] * 0.7
    for _ in range(3):
        out_r, rnew = RG.apply_rglru_block(rblock["rec"], jnp.asarray(x1), rc,
                                           cache=rnew)
        out_t, tnew = TG.apply_rglru_block(tblock["rec"], torch.from_numpy(x1),
                                           tc, cache=tcache)
        close(out_t, out_r)
        for f in ("conv", "h"):
            close(tnew[f], getattr(rnew, f))
        TM._write(tcache, tnew, scan=False)
        x1 = x1 * 1.3


def test_rglru_init_matches_reference_distributions():
    tc = tcfg.reduced(tcfg.get_config(GEMMA))
    tp = TM.init_model(tc, torch.Generator().manual_seed(0), device="cpu")
    i = tc.pattern_for_depth().index("rglru")
    rec = tp["blocks"][i]["rec"]
    a_c = torch.exp(-8.0 * torch.nn.functional.softplus(rec["lam"]))
    assert a_c.min() >= 0.9 ** 2 * 0.999 and a_c.max() <= 0.999 ** 2 * 1.001
    for k in ("lam", "b_a", "b_i"):
        assert rec[k].dtype == torch.float32
    assert not rec["b_a"].any() and not rec["b_i"].any()


# ----------------------------------------------------- attention branches
def attn_block(params, cfg, kind):
    i = cfg.pattern_for_depth().index(kind)
    if "blocks" in params:
        return params["blocks"][i]["attn"]
    return jax.tree.map(lambda a: a[i], params["blocks_scanned"]["attn"])


def to_port_cache(rcache):
    """A reference LayerCache as the port's (copies, so in place is safe)."""
    fields = {f: torch.from_numpy(np.array(getattr(rcache, f)))
              for f in ("k", "v", "pos", "start")
              if getattr(rcache, f) is not None}
    if "pos" in fields:
        fields["pos"] = fields["pos"].long()
    if "start" in fields:
        fields["start"] = fields["start"].long()
    return LayerCache(kind=rcache.kind, **fields)


def filled_cache(kind, B, rows, cfg, per_slot, seed, start=None, pos=None):
    r = np.random.RandomState(seed)
    shape = (B, rows, cfg.num_kv_heads, cfg.head_dim)
    if pos is None:
        pos = (np.array([rows + 3, 7, 1][:B], np.int32) if per_slot
               else np.int32(11))
    return RCache(kind=kind, k=jnp.asarray(r.randn(*shape).astype(np.float32)),
                  v=jnp.asarray(r.randn(*shape).astype(np.float32)),
                  pos=jnp.asarray(pos),
                  start=None if start is None else jnp.asarray(start))


CACHED = [  # (cache kind, S, per-slot cursors)
    ("full", 1, True), ("full", 5, False), ("ring", 19, False),
    ("ring", 1, False), ("ring", 1, True),
]
BRANCHES = [(None, 19, False, False)] + [
    c + (start,) for c in CACHED for start in (False, True)]


@pytest.mark.parametrize("branch", BRANCHES)
def test_attention_branches_match_reference(gemma, branch):
    """Every cache branch of ``apply_attention`` (no cache, then each cached
    one without and with per-slot ``start`` offsets): output, K/V rows and
    the advanced cursor.  The per-slot full cache is given a cursor past
    its rows for one slot, whose write is dropped (``mode="drop"``)."""
    kind, S, per_slot, with_start = branch
    rc, rp, tc, tp = gemma
    rblock = attn_block(rp, rc, "local_attn")
    tblock = attn_block(tp, tc, "local_attn")
    B, rows, W = 3, 40, rc.local_window
    x = acts((B, S, rc.d_model), 8)
    pos0 = 11 if not per_slot else None
    positions = (np.arange(S)[None, :] + (pos0 or 0)).repeat(B, 0)
    if per_slot:
        positions = np.array([[rows + 3], [7], [1]], np.int32)
    start = np.array([2, 0, 5], np.int32) if with_start else None
    rcache = None
    if kind is not None:
        n = rows if kind == "full" else W
        rcache = filled_cache(kind, B, n, rc, per_slot, 9, start,
                              pos=0 if (kind == "ring" and S > 1) else None)
    tcache = None if rcache is None else to_port_cache(rcache)
    out_r, rnew = RL.apply_attention(rblock, jnp.asarray(x), rc,
                                     jnp.asarray(positions), window=W,
                                     cache=rcache, kernel_impl="interpret")
    out_t = TL.apply_attention(tblock, torch.from_numpy(x), tc,
                               torch.from_numpy(positions), window=W,
                               cache=tcache)
    close(out_t, out_r)
    if kind is not None:
        for f in ("k", "v", "pos"):
            close(getattr(tcache, f), getattr(rnew, f), 1e-6)


def test_per_slot_full_cache_rejects_a_prefill(gemma):
    rc, rp, tc, tp = gemma
    cache = init_caches(dataclasses.replace(tc, local_window=None), 2, 16,
                        per_slot_pos=True, device="cpu")[2]
    assert cache.kind == "full"
    with pytest.raises(ValueError, match="single-token decode only"):
        TL.apply_attention(attn_block(tp, tc, "local_attn"),
                           torch.zeros(2, 3, tc.d_model), tc,
                           torch.zeros(2, 3, dtype=torch.long), cache=cache)


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("name", [GEMMA, QWEN])
def test_forward_no_cache_matches_reference(name, gemma, qwen):
    rc, rp, tc, tp = gemma if name == GEMMA else qwen
    toks = tokens(2, 40, seed=1)
    lg_r, _, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks))
    lg_t, caches = TM.forward(tp, tc, torch.from_numpy(toks))
    assert caches is None and lg_t.shape == (2, 40, 512)
    close(lg_t, lg_r)
    lg_r, _, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks),
                            last_token_only=True)
    lg_t, _ = TM.forward(tp, tc, torch.from_numpy(toks), last_token_only=True)
    close(lg_t, lg_r)


def layer_views(caches, cfg):
    if isinstance(caches, LayerCache):
        return [caches.layer(i) for i in range(cfg.num_layers)]
    return caches


def compare_caches(tcaches, rcaches, cfg):
    for rl, tl in zip(rcaches, layer_views(tcaches, cfg)):
        assert rl.kind == tl.kind
        for f in ("k", "v", "pos", "conv", "h"):
            if getattr(rl, f) is not None:
                close(getattr(tl, f), getattr(rl, f))


@pytest.mark.parametrize("max_len,S", [(96, 2), (96, 37), (96, 70),
                                       (32, 2), (32, 20)])
def test_admit_then_decode_matches_reference(gemma, max_len, S):
    """Each row prefilled alone at B=1 and admitted with ``write_prompt``
    into a 2-slot cache with per-slot cursors, then 4 decode steps, as the
    engine runs it: ring caches (max_len 96 > window 32) and full caches
    (max_len 32).  A 2-token prompt leaves one RG-LRU conv tail row, which
    the reference's ``write_prompt`` broadcasts over the three rows; the
    port's cache holds the same."""
    rc, rp, tc, tp = gemma
    toks = tokens(2, S, seed=S + max_len)
    rcaches = rinit_caches(rc, 2, max_len, per_slot_pos=True)
    tcaches = init_caches(tc, 2, max_len, per_slot_pos=True, device="cpu")
    kinds = {c.kind for c in tcaches}
    assert kinds == ({"ring", "rglru"} if max_len > 32 else {"full", "rglru"})
    for b in range(2):
        lg_r, pf, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks[b:b + 1]),
                                 caches=rinit_caches(rc, 1, max_len),
                                 last_token_only=True)
        rcaches = rwrite_prompt(rcaches, b, pf)
        lg_t, tpf = TM.forward(tp, tc, torch.from_numpy(toks[b:b + 1]),
                               caches=init_caches(tc, 1, max_len,
                                                  device="cpu"),
                               last_token_only=True)
        write_prompt(tcaches, b, tpf)
        close(lg_t, lg_r)
    compare_caches(tcaches, rcaches, tc)
    if S == 2:
        conv = np.asarray(rcaches[0].conv)
        assert np.array_equal(conv[:, 0], conv[:, 2])
    rc_dec = dataclasses.replace(rc, kernel_impl="auto")
    nxt = np.asarray(jnp.argmax(lg_r[:, -1], -1), np.int32)
    nxt = np.stack([nxt[0], nxt[0] + 1])[:, None] % 512
    pos = np.array([S, S], np.int32)
    for _ in range(4):
        lg_r, rcaches, _ = RM.forward(rp, rc_dec, tokens=jnp.asarray(nxt),
                                      caches=rcaches, pos=jnp.asarray(pos),
                                      last_token_only=True)
        lg_t, tcaches = TM.forward(tp, tc, torch.from_numpy(nxt),
                                   caches=tcaches,
                                   pos=torch.from_numpy(pos).long(),
                                   last_token_only=True)
        close(lg_t, lg_r)
        nxt = np.asarray(jnp.argmax(lg_r[:, -1], -1), np.int32)[:, None]
        pos = pos + 1
    compare_caches(tcaches, rcaches, tc)


@pytest.mark.parametrize("name,max_len,S", [(GEMMA, 96, 37), (GEMMA, 32, 20),
                                            (QWEN, 32, 9)])
def test_prefill_then_decode_scalar_cursors(name, gemma, qwen, max_len, S):
    """B=2 prefill into caches with scalar cursors, then 4 decode steps,
    for the list (gemma) and stacked (qwen) layouts."""
    rc, rp, tc, tp = gemma if name == GEMMA else qwen
    toks = tokens(2, S, seed=S)
    rcaches = rinit_caches(rc, 2, max_len)
    tcaches = init_caches(tc, 2, max_len, device="cpu")
    if TM.scanned(tc):
        tcaches = stack_caches(tcaches)
    lg_r, rcaches, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks),
                                  caches=rcaches, last_token_only=True)
    lg_t, tcaches = TM.forward(tp, tc, torch.from_numpy(toks),
                               caches=tcaches, last_token_only=True)
    close(lg_t, lg_r)
    rc_dec = dataclasses.replace(rc, kernel_impl="auto")
    for step in range(4):
        nxt = np.asarray(jnp.argmax(lg_r[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(nxt[:, 0], lg_t[:, -1].argmax(-1).numpy())
        lg_r, rcaches, _ = RM.forward(rp, rc_dec, tokens=jnp.asarray(nxt),
                                      caches=rcaches, pos=S + step,
                                      last_token_only=True)
        lg_t, tcaches = TM.forward(tp, tc, torch.from_numpy(nxt),
                                   caches=tcaches, pos=S + step,
                                   last_token_only=True)
        close(lg_t, lg_r)
    compare_caches(tcaches, rcaches, tc)


def test_two_token_prompt_conv_tail_fills_every_row(gemma):
    """``rglru.py:90`` slices ``u[:, S-(K-1):]``: for S = 2 and K = 4 that
    is ``u[:, -1:]``, one row, and the reference's ``write_prompt``
    (``.at[slot].set``) broadcasts it over all three rows of the slot.  The
    port's prefill into an unrolled stack's fresh caches holds the same
    rows, and admission copies them."""
    rc, rp, tc, tp = gemma
    toks = tokens(1, 2, seed=21)
    _, pf, _ = RM.forward(rp, rc, tokens=jnp.asarray(toks),
                          caches=rinit_caches(rc, 1, 96))
    admitted = rwrite_prompt(rinit_caches(rc, 2, 96, per_slot_pos=True), 1,
                             pf)
    _, tpf = TM.forward(tp, tc, torch.from_numpy(toks),
                        caches=init_caches(tc, 1, 96, device="cpu"))
    slots = write_prompt(init_caches(tc, 2, 96, per_slot_pos=True,
                                     device="cpu"), 1, tpf)
    for i, kind in enumerate(tc.pattern_for_depth()):
        if kind != "rglru":
            continue
        assert np.asarray(pf[i].conv).shape[1] == 1  # one tail row
        conv = tpf[i].conv[0]
        assert torch.equal(conv[0], conv[2]) and torch.equal(conv[1],
                                                             conv[2])
        close(conv, np.asarray(admitted[i].conv)[1])
        assert torch.equal(slots[i].conv[1], conv)
        assert not slots[i].conv[0].any()


def test_ring_prefill_runs_k5_once_a_local_attn_layer(gemma, monkeypatch):
    """The ring-cache prefill with no ``start`` reaches the K5 wrapper (a
    static offset 0), once a ``local_attn`` layer; a one-token prompt and
    decode steps do not."""
    _, _, tc, tp = gemma
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    caches = init_caches(tc, 1, 96, device="cpu")
    TM.forward(tp, tc, torch.from_numpy(tokens(1, 37)), caches=caches)
    n_local = tc.pattern_for_depth().count("local_attn")
    assert len(calls) == n_local == 2
    assert all(k["q_offset"] == 0 and k["window"] == 32 for k in calls)
    TM.forward(tp, tc, torch.from_numpy(tokens(1, 1)), caches=caches, pos=37)
    TM.forward(tp, tc, torch.from_numpy(tokens(1, 1)),
               caches=init_caches(tc, 1, 96, device="cpu"))
    assert len(calls) == n_local


# ------------------------------------------------- init and conversion
def test_params_from_jax_carries_the_list_layout(gemma):
    rc, rp, tc, tp = gemma
    assert "blocks" in tp and len(tp["blocks"]) == tc.num_layers
    i = tc.pattern_for_depth().index("rglru")
    for k in ("lam", "b_a", "w_a", "conv"):
        np.testing.assert_array_equal(tp["blocks"][i]["rec"][k].numpy(),
                                      np.asarray(rp["blocks"][i]["rec"][k]))
    tree = jax.tree.map(np.asarray, rp)
    with pytest.raises(ValueError, match="list of 6"):
        params_from_jax(dict(tree, blocks=tree["blocks"][:5]), tc,
                        device="cpu")
    flat = TM.init_model(tc, 0, device="meta")
    assert [sorted(b) for b in flat["blocks"]] == \
        [sorted(b) for b in rp["blocks"]]


def test_qwen_carries_biases_and_the_stacked_layout(qwen):
    rc, rp, tc, tp = qwen
    assert TM.scanned(tc) and "blocks_scanned" in tp
    attn = tp["blocks_scanned"]["attn"]
    for k in ("bq", "bk", "bv"):
        assert attn[k].shape[0] == tc.num_layers
    np.testing.assert_array_equal(
        attn["wq"].numpy(), np.asarray(rp["blocks_scanned"]["attn"]["wq"]))


# ---------------------------------------------------------------- caches
def test_cache_kinds_and_stacking(gemma):
    _, _, tc, _ = gemma
    ring = init_caches(tc, 2, 96, per_slot_pos=True, device="cpu")
    assert [c.kind for c in ring] == ["rglru", "rglru", "ring"] * 2
    assert ring[2].k.shape == (2, 32, 1, 32) and ring[2].pos.shape == (2,)
    full = init_caches(tc, 2, 32, device="cpu")
    assert full[2].kind == "full" and full[2].pos.ndim == 0
    with pytest.raises(ValueError, match="heterogeneous"):
        stack_caches(ring)
    with pytest.raises(ValueError, match="per-slot cursors"):
        write_prompt(full, 0, init_caches(tc, 1, 32, device="cpu"))


@pytest.mark.parametrize("stacked", [True, False])
def test_reset_slot_zeroes_one_slot_and_its_cursors(qwen, gemma, stacked):
    _, _, tc, _ = qwen if stacked else gemma
    caches = init_caches(tc, 2, 64, per_slot_pos=True, device="cpu")
    for c in caches:
        for t in c.tensors() + ([c.pos] if c.pos is not None else []):
            t.fill_(1)
    if stacked:
        caches = stack_caches(caches)
    reset_slot(caches, 0)
    for c in layer_views(caches, tc):
        for t in c.tensors() + ([c.pos] if c.pos is not None else []):
            assert not t[0].any() and bool((t[1] == 1).all())


# ---------------------------------------------------------------- engine
REQS = [([1, 2, 3], 7), ([4, 5], 3), ([6], 5), ([7, 8, 9, 1], 4)]
STREAM = REQS + [(list(np.random.RandomState(37).randint(0, 512, 37)), 5),
                 (list(np.random.RandomState(70).randint(0, 512, 70)), 6)]


def drain(engine_cls, cfg, params, mode, reqs=STREAM, max_len=96):
    eng = engine_cls(cfg, params, batch_slots=2, max_len=max_len,
                     chunk_size=4, decode_mode=mode)
    rids = [eng.submit(np.array(p), max_new_tokens=m) for p, m in reqs]
    out = eng.run()
    return [[int(t) for t in out[r]] for r in rids], eng.stats


@pytest.mark.parametrize("mode", ["chunked", "host"])
def test_engine_matches_the_reference_engine(gemma, mode):
    """The ``tests/test_serve.py`` stream plus 37- and 70-token prompts on
    ring caches (max_len 96): the same tokens and all five stats."""
    rc, rp, tc, tp = gemma
    want, want_stats = drain(RefEngine, dataclasses.replace(
        rc, kernel_impl="auto"), rp, mode)
    got, got_stats = drain(ServeEngine, tc, tp, mode)
    assert got == want
    assert got_stats == want_stats
    assert [len(t) for t in got] == [m for _, m in STREAM]


def test_engine_keeps_a_list_and_cursors_on_the_device(gemma):
    _, _, tc, tp = gemma
    eng = ServeEngine(tc, tp, batch_slots=2, max_len=96, chunk_size=4)
    assert isinstance(eng.caches, list)
    eng.submit(np.arange(1, 38), max_new_tokens=9)
    eng.step()
    ring = eng.caches[2]
    # the cursor of the admitted slot advanced in place past the prompt
    # and the chunk's steps, and the dead slot stepped along from 0
    assert ring.pos.tolist() == [37 + 4, 4]
    eng.run()  # completion resets the slot's cursor
    assert ring.pos[0] == 0


def test_qwen_engine_matches_the_reference_engine(qwen):
    """Full caches, stacked (max_len 64).  The 50-token request fills its
    slot's 64 rows while the other slot still decodes, so its slot steps
    on dead past the last row, and those writes are dropped."""
    rc, rp, tc, tp = qwen
    reqs = [(list(range(1, 51)), 14), ([5, 6, 7], 20)] + REQS
    want, want_stats = drain(RefEngine, dataclasses.replace(
        rc, kernel_impl="auto"), rp, "chunked", reqs=reqs, max_len=64)
    got, got_stats = drain(ServeEngine, tc, tp, "chunked", reqs=reqs,
                           max_len=64)
    assert got == want and got_stats == want_stats
