"""The port's checkpoints, on the CPU: the cases of
``tests/test_checkpoint.py`` (round trip, latest step, a torn write
ignored, the asynchronous writer, a structure mismatch raising), the
reference's format (a checkpoint of the reference restores into the port
and the other way round, for a train state of the same config), and
``restore``'s device argument."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as rcfg  # noqa: E402
from repro.checkpoint import checkpoint as rckpt  # noqa: E402
from repro.train import train_step as RTS  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402


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


@pytest.fixture
def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones(2, dtype=torch.bfloat16) * 1.5,
                   "step": torch.tensor(7, dtype=torch.int32)},
        "layers": [torch.full((2, 2), -3.0), torch.zeros(1, dtype=torch.int64)],
    }


def same(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_identity(tree, tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 5, tree, async_write=False)
    assert ckpt.latest_step(d) == 5
    same(ckpt.restore(d, 5, tree, device="cpu"), tree)


def test_latest_step_picks_max(tree, tmp_path):
    d = str(tmp_path)
    for s in (10, 30, 20):
        ckpt.save(d, s, tree, async_write=False)
    assert ckpt.latest_step(d) == 30
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_uncommitted_checkpoint_ignored(tree, tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, tree, async_write=False)
    os.makedirs(os.path.join(d, "step_99"))  # a torn write: no manifest
    os.makedirs(os.path.join(d, ".tmp_step_98_0"))
    assert ckpt.latest_step(d) == 1


def test_async_write_joins(tree, tmp_path):
    d = str(tmp_path)
    t = ckpt.save(d, 2, tree, async_write=True)
    tree["a"].add_(1)  # the leaves were copied before save returned
    t.join()
    assert ckpt.latest_step(d) == 2
    restored = ckpt.restore(d, 2, tree, device="cpu")
    assert torch.equal(restored["a"], tree["a"] - 1)


def test_structure_mismatch_raises(tree, tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 3, tree, async_write=False)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(d, 3, {"different": torch.zeros(3)}, device="cpu")
    wrong = dict(tree, a=torch.zeros(4, 3))
    with pytest.raises(ValueError, match="float32"):
        ckpt.restore(d, 3, wrong, device="cpu")


def test_format_is_the_reference_one(tree, tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 4, tree, async_write=False)
    with open(os.path.join(d, "step_4", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["keys"] == ["['a']", "['layers'][0]", "['layers'][1]",
                                "['nested']['b']", "['nested']['step']"]
    assert manifest["dtypes"][3] == "bfloat16" and manifest["num_hosts"] == 1
    data = np.load(os.path.join(d, "step_4", "host0.npz"))
    assert data["a3"].dtype == np.uint16  # bf16 as its bits
    # the reference reads it into its own tree of the same structure (one
    # without int64, which JAX keeps as int32)
    del tree["layers"][1]
    ckpt.save(d, 5, tree, async_write=False)
    like = {"a": jnp.zeros((3, 4)), "layers": [jnp.zeros((2, 2))],
            "nested": {"b": jnp.zeros(2, jnp.bfloat16),
                       "step": jnp.int32(0)}}
    got = rckpt.restore(d, 5, like)
    np.testing.assert_array_equal(np.asarray(got["nested"]["b"], np.float32),
                                  [1.5, 1.5])
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].numpy())


def test_train_state_crosses_both_ways(tmp_path):
    """A reference train state of a reduced bf16 config, saved by the
    reference, restores into the port's state of the same config (the same
    keys in the same order), equal to ``train_state_from_jax``; saved back
    by the port, the reference restores it bit for bit."""
    import dataclasses

    rc = dataclasses.replace(rcfg.reduced(rcfg.get_config("yi-6b")),
                             dtype="bfloat16")
    tc = dataclasses.replace(tcfg.reduced(tcfg.get_config("yi-6b")),
                             dtype="bfloat16")
    state = jax.jit(lambda k: RTS.init_state(k, rc, RTS.TrainConfig())[0])(
        jax.random.PRNGKey(1))
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    rckpt.save(a, 3, state, async_write=False)
    like = TTS.init_state(tc, TTS.TrainConfig(), 0, device="cpu")
    got = ckpt.restore(a, 3, like, device="cpu")
    same(got, train_state_from_jax(jax.tree.map(np.asarray, state), tc,
                                   TTS.TrainConfig(), device="cpu"))
    assert got.opt.master["embed"]["table"].dtype == torch.float32
    ckpt.save(b, 3, got, async_write=False)
    back = rckpt.restore(b, 3, state)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert x.dtype == y.dtype
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_restore_needs_a_card_unless_asked_for_the_cpu(tree, tmp_path,
                                                       monkeypatch):
    d = str(tmp_path)
    ckpt.save(d, 1, tree, async_write=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(d, 1, tree)
    assert ckpt.restore(d, 1, tree, device="cpu")["a"].is_cpu
