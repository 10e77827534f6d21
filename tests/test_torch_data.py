"""The port's copy of the data pipeline, on the CPU: the cases of
``tests/test_data.py`` on the copy, and every batch bitwise equal to the
reference's (tokens and embeddings modes, several seeds and steps, host
sharding, the prefetcher)."""
import dataclasses
import inspect

import numpy as np
import pytest

from repro.data import pipeline as rpipe

from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_batch

torch = pytest.importorskip("torch")


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


def test_deterministic_by_step():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=4, seed=3)
    a, b = make_batch(cfg, 7), make_batch(cfg, 7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], make_batch(cfg, 8)["tokens"])


def test_shapes_and_ranges():
    b = make_batch(DataConfig(vocab_size=500, seq_len=32, global_batch=8), 0)
    assert b["tokens"].shape == (8, 32) and b["labels"].shape == (8, 32)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 500
    # labels are the next tokens
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_ngram_structure_learnable():
    cfg = DataConfig(vocab_size=1000, seq_len=256, global_batch=4,
                     ngram_p=0.5, ngram_lag=2)
    t = make_batch(cfg, 0)["tokens"]
    assert (t[:, 2:] == t[:, :-2]).mean() > 0.3  # ~ngram_p plus collisions


def test_embeds_mode_for_frontend_stubs():
    b = make_batch(DataConfig(vocab_size=504, seq_len=16, global_batch=2,
                              embed_dim=128), 0)
    assert b["embeds"].shape == (2, 16, 128) and b["labels"].shape == (2, 16)
    assert b["embeds"].dtype == np.float32


def test_host_sharding_disjoint():
    a = make_batch(DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                              num_hosts=2, host_id=0), 0)
    b = make_batch(DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                              num_hosts=2, host_id=1), 0)
    assert a["tokens"].shape == (4, 8)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_prefetcher_orders_batches():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2)
    pf = Prefetcher(cfg, start_step=5, depth=2)
    try:
        for expect in (5, 6, 7):
            step, batch = next(pf)
            assert step == expect
            np.testing.assert_array_equal(batch["tokens"],
                                          make_batch(cfg, step)["tokens"])
    finally:
        pf.close()


# -------------------------------------------------- against the reference
CONFIGS = [
    dict(vocab_size=1000, seq_len=64, global_batch=4, seed=3),
    dict(vocab_size=151936, seq_len=128, global_batch=2, seed=0),
    dict(vocab_size=504, seq_len=32, global_batch=4, embed_dim=96, seed=5),
    dict(vocab_size=100, seq_len=8, global_batch=8, num_hosts=2, host_id=1),
    dict(vocab_size=300, seq_len=40, global_batch=3, ngram_p=0.9,
         ngram_lag=3, seed=11),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_batches_bitwise_with_reference(kw):
    tc, rc = tpipe.DataConfig(**kw), rpipe.DataConfig(**kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(rc)
    for step in (0, 1, 7, 1000):
        got, want = tpipe.make_batch(tc, step), rpipe.make_batch(rc, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == \
                want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), (k, step)


def test_copy_has_the_reference_fields_and_code():
    assert [f.name for f in dataclasses.fields(tpipe.DataConfig)] == \
        [f.name for f in dataclasses.fields(rpipe.DataConfig)]
    for name in ("_rng", "make_batch"):
        assert inspect.getsource(getattr(tpipe, name)) == \
            inspect.getsource(getattr(rpipe, name))


def test_prefetcher_matches_reference_stream():
    kw = dict(vocab_size=504, seq_len=16, global_batch=2, embed_dim=32)
    pf = tpipe.Prefetcher(tpipe.DataConfig(**kw), start_step=3)
    try:
        for _ in range(3):
            step, batch = next(pf)
            want = rpipe.make_batch(rpipe.DataConfig(**kw), step)
            assert batch["embeds"].tobytes() == want["embeds"].tobytes()
    finally:
        pf.close()
