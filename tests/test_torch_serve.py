"""The port's ServeEngine against the reference's, on the CPU.

The reduced Mamba-2 (float32) with the reference's weights carried across
by ``params_from_jax`` serves the ``tests/test_serve.py`` request stream,
plus a 37-token prompt whose prefill spans several chunks with padding,
through both engines: the token lists and all five ``stats`` counters
must be equal, in both decode modes.  The engine's own properties
(chunked == host, admission matches alone, leak-free slot reuse, submit
validation, the host-sync bound) are ported from ``tests/test_serve.py``,
and so is its left-padded ``prefill`` (reduced Qwen1.5-0.5B, full and
ring caches), held also to the reference's ``prefill(pad=...)``.  The
decode step the engine captures on the card runs here on the meta device,
which refuses any read of a value on the host.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.cache import init_caches as rinit_caches  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro.serve.engine import prefill as rprefill  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.models.cache import (init_caches, reset_slot,  # noqa: E402
                                      stack_caches)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine, prefill, serve_step  # noqa: E402

MODEL = "mamba2-2.7b"
REQS = [([1, 2, 3], 7), ([4, 5], 3), ([6], 5), ([7, 8, 9, 1], 4)]
LONG = (list(np.random.RandomState(37).randint(0, 512, 37)), 5)
STREAM = REQS + [LONG]


def carried(name):
    """(reference cfg, reference params, port cfg, port params)."""
    rc = rcfg.reduced(rcfg.get_config(name))
    tc = tcfg.reduced(tcfg.get_config(name))
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return rc, params, tc, tp


@pytest.fixture(scope="module")
def mamba():
    return carried(MODEL)


@pytest.fixture(scope="module")
def qwen():
    return carried("qwen1.5-0.5b")


def _drain(engine_cls, cfg, params, mode, reqs=STREAM, chunk_size=4,
           eos=None):
    eng = engine_cls(cfg, params, batch_slots=2, max_len=64,
                     chunk_size=chunk_size, decode_mode=mode)
    rids = [eng.submit(np.array(p), max_new_tokens=m, eos_id=eos)
            for p, m in reqs]
    out = eng.run()
    return [out[r] for r in rids], eng.stats


@pytest.fixture(scope="module")
def reference_runs(mamba):
    rc, rp, _, _ = mamba
    return {mode: _drain(RefEngine, rc, rp, mode)
            for mode in ("chunked", "host")}


@pytest.mark.parametrize("mode", ["chunked", "host"])
def test_tokens_and_stats_equal_the_reference_engine(mamba, reference_runs,
                                                     mode):
    _, _, tc, tp = mamba
    want_tokens, want_stats = reference_runs[mode]
    got_tokens, got_stats = _drain(ServeEngine, tc, tp, mode)
    assert got_tokens == [[int(t) for t in r] for r in want_tokens]
    assert got_stats == want_stats
    assert [len(t) for t in got_tokens] == [m for _, m in STREAM]


def test_eos_early_stop_equals_the_reference_engine(mamba, reference_runs):
    """eos_id truncates at its first occurrence in both modes, with the
    reference's tokens and stats (the chunk's dead steps are not counted)."""
    rc, rp, tc, tp = mamba
    seq = reference_runs["chunked"][0][0]
    k, eos = next((i, t) for i, t in enumerate(seq)
                  if 0 < i < len(seq) - 1 and t not in seq[:i])
    reqs = [([1, 2, 3], 7)]
    for mode in ("chunked", "host"):
        want, want_stats = _drain(RefEngine, rc, rp, mode, reqs=reqs, eos=eos)
        got, got_stats = _drain(ServeEngine, tc, tp, mode, reqs=reqs, eos=eos)
        assert got[0] == [int(t) for t in seq[:k + 1]] == want[0], mode
        assert got_stats == want_stats, mode


def test_chunked_matches_host_mixed_budgets(mamba):
    _, _, tc, tp = mamba
    chunked, s_chunk = _drain(ServeEngine, tc, tp, "chunked")
    host, s_host = _drain(ServeEngine, tc, tp, "host")
    assert chunked == host
    assert s_chunk["tokens_generated"] == s_host["tokens_generated"]
    assert s_chunk["host_syncs"] < s_host["host_syncs"]


def test_admission_matches_alone(mamba):
    _, _, tc, tp = mamba
    together, _ = _drain(ServeEngine, tc, tp, "chunked")
    for (p, m), got in zip(STREAM, together):
        alone, _ = _drain(ServeEngine, tc, tp, "chunked", reqs=[(p, m)])
        assert got == alone[0], (p, m)


def test_slot_reuse_leak_free(mamba):
    _, _, tc, tp = mamba
    target = ([9, 1, 9], 6)
    fresh, _ = _drain(ServeEngine, tc, tp, "chunked", reqs=[target])
    eng = ServeEngine(tc, tp, batch_slots=2, max_len=64, chunk_size=4)
    for p, m in STREAM:  # churn every slot through several lifecycles
        eng.submit(np.array(p), max_new_tokens=m)
    eng.run()
    rid = eng.submit(np.array(target[0]), max_new_tokens=target[1])
    assert eng.run()[rid] == fresh[0]


def test_host_sync_bound_structural(mamba):
    _, _, tc, tp = mamba
    tokens, chunk = 13, 4
    out, stats = _drain(ServeEngine, tc, tp, "chunked",
                        reqs=[([1, 2], tokens)], chunk_size=chunk)
    assert len(out[0]) == tokens
    assert stats["host_syncs"] <= math.ceil(tokens / chunk) + 1
    assert stats["chunk_launches"] == math.ceil((tokens - 1) / chunk)
    _, stats_h = _drain(ServeEngine, tc, tp, "host", reqs=[([1, 2], tokens)])
    assert stats_h["host_syncs"] == tokens  # prefill + (tokens-1) steps


def test_submit_validation(mamba):
    _, _, tc, tp = mamba
    eng = ServeEngine(tc, tp, batch_slots=2, max_len=64)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(np.arange(60), max_new_tokens=16)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(np.array([], np.int32))
    with pytest.raises(ValueError, match="decode_mode"):
        ServeEngine(tc, tp, decode_mode="turbo")
    assert eng.device.type == "cpu" and eng.caches.state.is_cpu
    assert eng.program is None  # eager: the CPU has no graphs


@pytest.mark.parametrize("mode", ["chunked", "host"])
def test_graphs_on_the_cpu_raise(mamba, mode):
    _, _, tc, tp = mamba
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        ServeEngine(tc, tp, batch_slots=2, max_len=64, decode_mode=mode,
                    graphs=True)


def meta_params(cfg):
    return TM.init_model(cfg, 0, device="meta")


@pytest.mark.parametrize("name", [MODEL, "recurrentgemma-2b",
                                  "qwen1.5-0.5b"])
@pytest.mark.parametrize("mode", ["chunked", "host"])
def test_decode_step_reads_no_device_value_on_the_host(name, mode):
    """The step the engine captures runs on the meta device, where any
    read of a tensor's value on the host (``.item()``, a boolean mask's
    size, ``nonzero``) raises: so the step holds no host sync, which a
    CUDA graph capture would refuse."""
    tc = tcfg.reduced(tcfg.get_config(name))
    eng = ServeEngine(tc, meta_params(tc), batch_slots=2, max_len=48,
                      decode_mode=mode)
    assert eng.device.type == "meta" and eng.program is None
    for _ in range(2):
        eng._decode()
    with pytest.raises(RuntimeError, match="meta"):  # the probe itself
        int(eng.cur[0, 0])


# --------------------------------------------------- left-padded prefill
PADDED = [np.array([1, 2, 3, 4, 5]), np.array([7, 8]), np.array([9, 9, 9])]


def padded_wave(prompts):
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int32)
    pad = np.array([plen - len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks, pad


@pytest.mark.parametrize("window", [None, 8])
def test_padded_prefill_matches_unpadded(qwen, window):
    """The port's twin of ``tests/test_serve.py``'s left-padding test: a
    left-padded batch prefill plus 3 decode steps gives each row the
    tokens of its own unpadded prefill (full caches, and ring caches with
    ``window`` 8 below ``max_len`` 32), pad rows masked by per-slot
    ``start`` offsets; and the padded prefill's tokens equal the
    reference's ``prefill(pad=...)`` on the same weights."""
    rc, rp, tc, tp = qwen
    if window is not None:
        rc = dataclasses.replace(rc, window=window)
        tc = dataclasses.replace(tc, window=window)
    toks, pad = padded_wave(PADDED)
    plen = toks.shape[1]
    caches = init_caches(tc, 3, 32, device="cpu")
    if TM.scanned(tc):
        caches = stack_caches(caches)
    k_before = caches.k.data_ptr()
    nxt, caches = prefill(tp, torch.from_numpy(toks).long(), caches, pos=0,
                          cfg=tc, pad=pad)
    assert caches.k.data_ptr() == k_before  # in place, K/V not reallocated
    assert caches.kind == ("full" if window is None else "ring")
    assert caches.start.tolist() == [list(pad)] * tc.num_layers
    want, _ = rprefill(rp, jax.numpy.asarray(toks), rinit_caches(rc, 3, 32),
                       pos=0, cfg=rc, pad=pad)
    assert nxt[:, 0].tolist() == np.asarray(want)[:, 0].tolist()
    wave = [[int(nxt[i, 0])] for i in range(3)]
    cur, pos = nxt, plen
    for _ in range(3):
        cur, caches = serve_step(tp, cur, caches,
                                 torch.from_numpy(pos - pad).long(), cfg=tc)
        pos += 1
        for i in range(3):
            wave[i].append(int(cur[i, 0]))
    for i, p in enumerate(PADDED):
        c1 = stack_caches(init_caches(tc, 1, 32, device="cpu"))
        n1, c1 = prefill(tp, torch.from_numpy(p)[None].long(), c1, pos=0,
                         cfg=tc)
        alone, cur1, pos1 = [int(n1[0, 0])], n1, len(p)
        for _ in range(3):
            cur1, c1 = serve_step(tp, cur1, c1, pos1, cfg=tc)
            pos1 += 1
            alone.append(int(cur1[0, 0]))
        assert wave[i] == alone, (window, i)


def test_with_start_on_a_layer_list():
    """An unrolled list gets ``start`` on its attention layers, one (B,)
    tensor each; recurrent layers keep none."""
    from repro_torch.serve.engine import _with_start

    gc = tcfg.reduced(tcfg.get_config("recurrentgemma-2b"))
    caches = init_caches(gc, 2, 96, device="cpu")
    _with_start(caches, torch.tensor([3, 0]))
    for c, kind in zip(caches, gc.pattern_for_depth()):
        if kind == "local_attn":
            assert c.kind == "ring" and c.start.tolist() == [3, 0]
        else:
            assert c.start is None


@pytest.mark.parametrize("stacked", [True, False])
def test_reset_slot_zeroes_one_slot(stacked):
    tc = tcfg.reduced(tcfg.get_config(MODEL))
    caches = init_caches(tc, 2, 64, per_slot_pos=True, device="cpu")
    for c in caches:
        for t in c.tensors():
            t.fill_(1)
    if stacked:
        caches = stack_caches(caches)
    reset_slot(caches, 0)
    layers = ([caches.layer(i) for i in range(tc.num_layers)] if stacked
              else caches)
    for c in layers:
        for t in c.tensors():
            assert not t[0].any() and bool((t[1] == 1).all())
