"""The port's fault-tolerant loop, on the CPU, at the reference test's
sizes (``tests/test_trainer.py``: reduced qwen1.5-0.5b, 16 tokens, batch
4): failure injection with a bit-exact resume, the straggler watchdog,
SIGTERM (checkpoint, then exit), an in-flight save joined when the loop
raises, and the data-parallel step refused without a pool of ranks."""
import os
import signal

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.trainer import LoopConfig, Trainer  # noqa: E402


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


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen1.5-0.5b"))
    tcfg = TS.TrainConfig(base_lr=1e-3, warmup_steps=2, total_steps=40)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    return cfg, tcfg, dcfg


def loop(d, steps=12, **kw):
    return LoopConfig(num_steps=steps, ckpt_dir=d, ckpt_every=4,
                      log_every=0, **kw)


def test_failure_injection_and_bitexact_resume(setup, tmp_path):
    cfg, tcfg, dcfg = setup
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ref = Trainer(cfg, tcfg, dcfg, loop(d1), device="cpu")
    ref.run(0)
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}
    assert ref_losses[11] < ref_losses[0]  # it learns the n-gram structure

    # dies at step 7, after the step-4 checkpoint
    crashed = Trainer(cfg, tcfg, dcfg, loop(d2), device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        crashed.run(0, fail_at=7)
    assert ckpt.latest_step(d2) == 4

    # the restart resumes from step 4 and reproduces the losses exactly
    resumed = Trainer(cfg, tcfg, dcfg, loop(d2), device="cpu")
    state = resumed.run(0)
    assert resumed.metrics_log[0]["step"] == 4
    for m in resumed.metrics_log:
        assert m["loss"] == ref_losses[m["step"]], m["step"]
    assert int(state.step) == 12 and ckpt.latest_step(d2) == 12


def test_straggler_watchdog(setup, tmp_path):
    cfg, tcfg, dcfg = setup
    lc = LoopConfig(num_steps=6, ckpt_dir=str(tmp_path), ckpt_every=100,
                    log_every=0, straggler_factor=0.0)  # every step flags
    tr = Trainer(cfg, tcfg, dcfg, lc, device="cpu")
    tr.run(0)
    assert [e["step"] for e in tr.straggler_events] == [3, 4, 5]
    assert {"step", "time_s", "ema_s"} <= set(tr.straggler_events[0])
    calm = Trainer(cfg, tcfg, dcfg, LoopConfig(
        num_steps=3, ckpt_dir=str(tmp_path / "c"), log_every=0,
        straggler_factor=1e9), device="cpu")
    calm.run(0)
    assert calm.straggler_events == []


def test_sigterm_checkpoints_then_exits(setup, tmp_path):
    cfg, tcfg, dcfg = setup
    inner = TS.make_train_step(cfg, tcfg)

    def step_fn(state, batch):
        if int(state.step) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(state, batch)

    before = signal.getsignal(signal.SIGTERM)
    tr = Trainer(cfg, tcfg, dcfg, loop(str(tmp_path)), step_fn=step_fn,
                 device="cpu")
    state = tr.run(0)
    assert int(state.step) == 3 and len(tr.metrics_log) == 3
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_in_flight_save_is_joined_when_the_loop_raises(setup, tmp_path):
    cfg, tcfg, dcfg = setup
    d = str(tmp_path)
    tr = Trainer(cfg, tcfg, dcfg, loop(d), device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.run(0, fail_at=4)  # the step-4 save is still being written
    assert tr._pending_ckpt is None
    assert ckpt.latest_step(d) == 4
    assert not [n for n in os.listdir(d) if n.startswith(".tmp")]


def test_grad_sync_names_the_data_parallel_slice(setup, tmp_path):
    """The data-parallel step runs on a pool's rank processes (the data
    axis): asked for without one, the trainer names what it needs
    (``tests/test_torch_dist_step.py`` runs it)."""
    cfg, tcfg, dcfg = setup
    with pytest.raises(ValueError, match="grad_sync needs a pool of rank "
                       "processes"):
        Trainer(cfg, tcfg, dcfg, loop(str(tmp_path)),
                grad_sync="compressed_psum", device="cpu")


def test_trainer_needs_a_card_unless_asked_for_the_cpu(setup, tmp_path,
                                                       monkeypatch):
    cfg, tcfg, dcfg = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, tcfg, dcfg, loop(str(tmp_path)))


def test_quickstart_example_trains_and_resumes_on_the_cpu(capsys, tmp_path):
    """``examples/torch_quickstart.py`` (the port of the reference's
    quickstart): the loss falls, and the second trainer resumes at the
    last step of the first."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    first, second = mod.main(["--steps", "24", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path)])
    losses = [m["loss"] for m in first.metrics_log]
    assert len(losses) == 24 and losses[-1] < losses[0]
    assert [m["step"] for m in second.metrics_log] == list(range(24, 34))
    out = capsys.readouterr().out
    assert "resumed at step 24 and ran to 34" in out
