"""The port's ServeEngine against the reference's, on the CPU.

The reduced Mamba-2 (float32) with the reference's weights carried across
by ``params_from_jax`` serves the ``tests/test_serve.py`` request stream,
plus a 37-token prompt whose prefill spans several chunks with padding,
through both engines: the token lists and all five ``stats`` counters
must be equal, in both decode modes.  The engine's own properties
(chunked == host, admission matches alone, leak-free slot reuse, submit
validation, the host-sync bound) are ported from ``tests/test_serve.py``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import split_leaves  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.models.cache import (init_caches, reset_slot,  # noqa: E402
                                      stack_caches)
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

MODEL = "mamba2-2.7b"
REQS = [([1, 2, 3], 7), ([4, 5], 3), ([6], 5), ([7, 8, 9, 1], 4)]
LONG = (list(np.random.RandomState(37).randint(0, 512, 37)), 5)
STREAM = REQS + [LONG]


@pytest.fixture(scope="module")
def mamba():
    rc = rcfg.reduced(rcfg.get_config(MODEL))
    tc = tcfg.reduced(tcfg.get_config(MODEL))
    params, _ = split_leaves(RM.init_model(jax.random.PRNGKey(0), rc))
    tp = params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return rc, params, tc, tp


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
