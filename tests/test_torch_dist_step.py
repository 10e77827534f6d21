"""The port's data-parallel train step and compressed all-reduce on 4 CPU
rank processes, against the reference.

The reference's tests (``tests/test_dist_step.py``, ``test_dist_smoke.py``
and ``test_distributed.py::test_dp_train_step_8dev``) are ported here at
their sizes: reduced qwen1.5-0.5b, 16 tokens, a global batch of 8 (2 rows a
rank).  Both packages start from the reference's ``init_state`` (carried
across by ``train_state_from_jax``) and see the same ``make_batch`` data.
The tolerances:

- losses: the reference tests' own, ``psum`` within 1e-4 (absolute) of the
  single-device step, both packages' (the reduction split moves float32
  sums by ulps), ``compressed_psum`` within 2e-2;
- parameters after three steps with ``psum``: within 1e-5 of both
  single-device steps' (the reference's bound);
- ``compressed_psum`` is a function of how the batch splits over the
  ranks, so the port's compressed run is held to the reference's run on
  the same split (4 ranks against its 4 devices, an axis of one rank
  against its 1-device mesh): the update (parameters minus the start)
  within UPDATE_RTOL relative L2 and the grad norms within GNORM_RTOL, as
  for ``psum``.  AdamW normalizes the update, so a sync that scales the
  gradients moves only the grad norm, and one that drops ranks moves the
  update: three wrong syncs must fail this check;
- ``compressed_psum`` itself: bitwise with a numpy rendering of its
  formula, and within ``0.51 * scale * N`` of the exact sum.

The reference's step on 4 host devices runs once in a child process (JAX's
device count is fixed at start), and the port's 4-rank step is held to it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as rmake_batch  # noqa: E402
from repro.dist.compression import compressed_psum as rcompressed  # noqa
from repro.train import dist_step as RDS  # noqa: E402
from repro.train import train_step as RTS  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.dist.compression import QMAX, compressed_psum  # noqa: E402
from repro_torch.dist.ranks import get_pool  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.train import dist_step as DS  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.trainer import LoopConfig, Trainer  # noqa: E402

RANKS, STEPS = 4, 3
LOSS_TOL = {False: 1e-4, True: 2e-2}  # absolute, by compress
PARAM_TOL = 1e-5  # psum, max abs
# against the reference's run on the same split, both modes.  Readings on
# the CPU: the update 1.9e-4 to 5.2e-4 compressed, 2.1e-6 to 2.3e-6 with
# psum, the grad norms within 1.9e-6; the wrong syncs 1.0 (zero) and 0.67
# (drop) on the update, 0.5 (half) on the grad norms.
UPDATE_RTOL, GNORM_RTOL = 5e-3, 1e-4
CASES = [(False, 1), (True, 1), (False, 2), (True, 2)]  # (compress, accum)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (its models are tiny; under
    several test workers more threads only spin against each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    return get_pool(RANKS, torch.device("cpu"))


def configs(accum: int = 1):
    kw = dict(base_lr=1e-3, warmup_steps=2, total_steps=40, grad_accum=accum)
    return RTS.TrainConfig(**kw), TS.TrainConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    rc = rcfg.reduced(rcfg.get_config("qwen1.5-0.5b"))
    tc = tcfg.reduced(tcfg.get_config("qwen1.5-0.5b"))
    state, _ = RTS.init_state(jax.random.PRNGKey(0), rc, configs()[0])
    start = jax.tree.map(np.asarray, state)
    return rc, tc, start, dict(vocab_size=tc.vocab_size, seq_len=16,
                               global_batch=2 * RANKS)


def port_state(tc, start, accum=1):
    return train_state_from_jax(start, tc, configs(accum)[1], device="cpu")


def jax_run(step_fn, rc, start, dkw, n=STEPS):
    state = jax.tree.map(jax.numpy.asarray, start)
    losses, gnorms = [], []
    for s in range(n):
        state, m = step_fn(state, rmake_batch(RDataConfig(**dkw), s))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return jax.tree.map(np.asarray, state), losses, gnorms


def port_single(tc, start, dkw, accum=1, n=STEPS):
    state = port_state(tc, start, accum)
    step = TS.make_train_step(tc, configs(accum)[1])
    losses = []
    for s in range(n):
        state, m = step(state, make_batch(DataConfig(**dkw), s))
        losses.append(float(m["loss"]))
    return state, losses


def _rank_faulty_step(ctx, job: int, rows, fault: str):
    """A rank's step with a wrong gradient sync, for the controls: the
    mean times 0 (``zero``) or 0.5 (``half``), or the mean with the upper
    half of the ranks sending zeros (``drop``: half the batch's rows)."""
    good = DS.sync_grads

    def wrong(grads, comm, compress):
        if fault == "drop":
            if comm.rank >= comm.size // 2:
                grads = T.tree_map(torch.zeros_like, grads)
            return good(grads, comm, compress)
        w = {"zero": 0.0, "half": 0.5}[fault]
        return T.tree_map(lambda g: g * w, good(grads, comm, compress))

    DS.sync_grads = wrong
    try:
        return DS._rank_step(ctx, job, rows)
    finally:
        DS.sync_grads = good


def port_dp(pool, tc, start, dkw, compress, accum=1, n=STEPS, fault=None):
    """The port's 4-rank run -> (replicas, losses, grad norms); ``fault``
    runs every step with ``_rank_faulty_step``'s wrong sync."""
    dp = DS.DataParallel(pool, tc, configs(accum)[1], compress=compress)
    dp.load(port_state(tc, start, accum))
    losses, gnorms = [], []
    for s in range(n):
        batch = make_batch(DataConfig(**dkw), s)
        if fault is None:
            m = dp.run_step(batch)
        else:
            m = pool.map(_rank_faulty_step, [
                (dp.job, rows, fault)
                for rows in DS.shard_rows(batch, RANKS)])[0][0]
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        dp.fingerprint()  # every replica holds the same bits
    return dp, losses, gnorms


def _rank_one_axis(ctx, state, batches, tc, tt, compress: bool):
    """The port's DP step over an axis of one rank (every rank alone, the
    counterpart of the reference's 1-device mesh) -> rank 0's (params,
    losses, grad norms)."""
    comm = ctx.comm.grid(RANKS, 1).model
    state = T.tree_map(lambda t: t.clone(), state)  # not the sent tensors
    losses, gnorms = [], []
    for b in batches:
        state, m = DS.dp_train_step(state, b, tc, tt, comm, compress)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return (state.params, losses, gnorms) if ctx.rank == 0 else None


def port_one_axis(pool, tc, start, dkw, compress, accum):
    batches = [make_batch(DataConfig(**dkw), s) for s in range(STEPS)]
    return pool.call(_rank_one_axis, port_state(tc, start, accum), batches,
                     tc, configs(accum)[1], compress)[0]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def max_diff(got, want) -> float:
    """The largest |difference| of two parameter trees (the port's, and
    the port's or the reference's, in the same leaf order)."""
    want = T.leaves(want) if isinstance(want, dict) and any(
        isinstance(w, torch.Tensor) for w in T.leaves(want)) \
        else jax.tree.leaves(want)
    return max(float(np.abs(_np(g) - _np(w)).max())
               for g, w in zip(T.leaves(got), want))


def update_rel(got, want, start) -> float:
    """The relative L2 of the port's update against the reference's on the
    same start: ``|got - want| / |want - start|`` over every leaf (the
    port's parameter tree, the reference's leaves, the start's)."""
    num = den = 0.0
    for g, w, s in zip(T.leaves(got), want, start):
        w, s = np.float64(_np(w)), np.float64(_np(s))
        num += float(np.square(np.float64(_np(g)) - w).sum())
        den += float(np.square(w - s).sum())
    return (num / den) ** 0.5


def agreement(got, gnorms, want, want_gnorms, start) -> tuple:
    """-> (the update's relative L2, the grad norms' largest relative
    difference), the port's run against the reference's."""
    gn = float(np.max(np.abs(np.subtract(gnorms, want_gnorms))
                      / np.abs(want_gnorms)))
    return update_rel(got, want, start), gn


# ------------------------------------------------------- compressed_psum
def _rank_compressed(ctx, v: np.ndarray, axis: str):
    comm = ctx.comm if axis == "world" else ctx.comm.grid(RANKS, 1).model
    return compressed_psum(torch.from_numpy(v), comm, tag=7).numpy()


def numpy_compressed(vs):
    """The formula in numpy, float32 throughout: the shared scale from the
    largest |v|, round half to even, clamp, an exact integer sum, one
    rescale."""
    amax = max(np.abs(v).max() for v in vs).astype(np.float32)
    scale = amax / np.float32(QMAX) if amax > 0 else np.float32(1.0)
    qs = [np.clip(np.round(v / scale), -QMAX, QMAX).astype(np.int32)
          for v in vs]
    return (np.sum(qs, axis=0).astype(np.float32) * scale), scale


@pytest.mark.parametrize("shape,seed", [((4, 32), 0), ((1000,), 1),
                                        ((3, 5, 7), 2)])
def test_compressed_psum_is_its_formula_and_near_the_sum(pool, shape, seed):
    rs = np.random.RandomState(seed)
    vs = [(rs.randn(*shape) * (r + 1)).astype(np.float32)
          for r in range(RANKS)]
    got = pool.map(_rank_compressed, [(v, "world") for v in vs])
    want, scale = numpy_compressed(vs)
    for g in got:  # every rank gets the same bits
        np.testing.assert_array_equal(g, want)
    # at most half a quantum off a rank, and a rank's share of N ranks
    assert np.abs(got[0] - np.sum(vs, axis=0)).max() <= \
        0.51 * scale * RANKS


def test_compressed_psum_one_device(pool):
    """Over an axis of one rank the 'sum' is the value itself up to the
    int8 rounding (the reference's 1-device test), and equal to the
    reference's ``compressed_psum`` on one device."""
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map

    x = np.random.RandomState(0).randn(4, 32).astype(np.float32)
    got = pool.map(_rank_compressed, [(x, "model")] * RANKS)[0]
    scale = np.abs(x).max() / 127.0
    assert np.abs(got - x).max() <= 0.51 * scale
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    ref = jax.jit(shard_map(lambda v: rcompressed(v, "d"), mesh=mesh,
                            in_specs=P("d"), out_specs=P("d")))
    np.testing.assert_array_equal(got, np.asarray(ref(x)))
    zeros = pool.map(_rank_compressed,
                     [(np.zeros((2, 8), np.float32), "model")] * RANKS)[0]
    np.testing.assert_array_equal(zeros, np.zeros((2, 8)))


def _rank_max(ctx, v: np.ndarray):
    return ctx.comm.all_reduce(torch.from_numpy(v), 3, op="max").wait(
    ).numpy()


def test_all_reduce_max_and_an_unknown_op(pool):
    from repro_torch.dist.ranks import RankComm

    vs = [np.random.RandomState(r).randn(6).astype(np.float32)
          for r in range(RANKS)]
    for g in pool.map(_rank_max, [(v,) for v in vs]):
        np.testing.assert_array_equal(g, np.max(vs, axis=0))
    comm = RankComm(0, 1, torch.device("cpu"))  # refuses before any gloo op
    with pytest.raises(ValueError, match="unknown all_reduce op 'min'"):
        comm.all_reduce(torch.zeros(2), 0, op="min")


# ---------------------------------------------------- the data-parallel step
def check_agreement(got, gnorms, want, want_gnorms, start):
    upd, gn = agreement(got, gnorms, want, want_gnorms, start)
    assert upd <= UPDATE_RTOL and gn <= GNORM_RTOL, (upd, gn)


@pytest.mark.parametrize("compress,accum", CASES)
def test_dp_step_matches_the_single_device_steps(setup, pool, compress,
                                                 accum):
    """4 ranks against the reference's ``jit_dp_train_step`` on a 1-device
    mesh and the port's single-device step, as ``tests/test_dist_step.py``
    holds the reference's DP step to its own; with compression the port's
    step over an axis of one rank against the reference's 1-device mesh."""
    rc, tc, start, dkw = setup
    rt, _ = configs(accum)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    r_state, r_losses, r_gnorms = jax_run(
        RDS.jit_dp_train_step(rc, rt, mesh, compress=compress), rc, start,
        dkw)
    s_state, s_losses = port_single(tc, start, dkw, accum)
    dp, losses, gnorms = port_dp(pool, tc, start, dkw, compress, accum)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, r_losses, rtol=0,
                               atol=LOSS_TOL[compress])
    np.testing.assert_allclose(losses, s_losses, rtol=0,
                               atol=LOSS_TOL[compress])
    got = dp.state()
    assert int(got.step) == STEPS and dp.step == STEPS
    r_params = jax.tree.leaves(r_state.params)
    p0 = jax.tree.leaves(start.params)
    if compress:
        params, one_losses, one_gnorms = port_one_axis(pool, tc, start, dkw,
                                                       True, accum)
        np.testing.assert_allclose(one_losses, r_losses, rtol=0,
                                   atol=LOSS_TOL[True])
        check_agreement(params, one_gnorms, r_params, r_gnorms, p0)
    else:  # the exact sync is both single-device steps
        assert max_diff(got.params, s_state.params) <= PARAM_TOL
        assert max_diff(got.params, r_state.params) <= PARAM_TOL
        check_agreement(got.params, gnorms, r_params, r_gnorms, p0)


JAX_4DEV = r"""
import json, sys, jax, numpy as np
from repro.configs import get_config, reduced
from repro.data.pipeline import DataConfig, make_batch
from repro.train import train_step as TS, dist_step as DS
cfg = reduced(get_config("qwen1.5-0.5b"))
dcfg = DataConfig(**json.loads(sys.argv[1]))
mesh = jax.make_mesh((4,), ("data",))
out = {}
for compress, accum in json.loads(sys.argv[4]):
    tcfg = TS.TrainConfig(base_lr=1e-3, warmup_steps=2, total_steps=40,
                          grad_accum=accum)
    state, _ = TS.init_state(jax.random.PRNGKey(0), cfg, tcfg)
    step = DS.jit_dp_train_step(cfg, tcfg, mesh, compress=compress)
    losses, gnorms = [], []
    for s in range(int(sys.argv[3])):
        state, m = step(state, make_batch(dcfg, s))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    key = f"{int(compress)}{accum}"
    out["losses" + key] = np.asarray(losses)
    out["gnorms" + key] = np.asarray(gnorms)
    for i, leaf in enumerate(jax.tree.leaves(state.params)):
        out[f"p{key}_{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_4dev_child(tmp_path_factory):
    """The reference's 4-device runs, started when the module starts so
    that they run beside the tests before they are needed."""
    path = str(tmp_path_factory.mktemp("jax4") / "out.npz")
    dkw = dict(vocab_size=tcfg.reduced(tcfg.get_config(
        "qwen1.5-0.5b")).vocab_size, seq_len=16, global_batch=2 * RANKS)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", JAX_4DEV, json.dumps(dkw),
                             path, str(STEPS), json.dumps(CASES)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_4dev(jax_4dev_child):
    proc, path = jax_4dev_child
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    return dict(np.load(path))


def reference_4dev(jax_4dev, compress, accum, n_leaves):
    key = f"{int(compress)}{accum}"
    return ([jax_4dev[f"p{key}_{i}"] for i in range(n_leaves)],
            jax_4dev["losses" + key], jax_4dev["gnorms" + key])


@pytest.mark.parametrize("compress,accum", CASES)
def test_dp_step_matches_the_reference_on_4_devices(setup, pool, jax_4dev,
                                                    compress, accum):
    rc, tc, start, dkw = setup
    dp, losses, gnorms = port_dp(pool, tc, start, dkw, compress, accum)
    got = dp.state().params
    p0 = jax.tree.leaves(start.params)
    want, r_losses, r_gnorms = reference_4dev(jax_4dev, compress, accum,
                                              len(p0))
    np.testing.assert_allclose(losses, r_losses, rtol=0,
                               atol=LOSS_TOL[compress])
    if not compress:
        assert max_diff(got, want) <= PARAM_TOL
    check_agreement(got, gnorms, want, r_gnorms, p0)


@pytest.mark.parametrize("fault", ["zero", "half", "drop"])
def test_the_compressed_check_fails_a_wrong_sync(setup, pool, jax_4dev,
                                                 fault):
    """The controls: the port's compressed run with a wrong sync (zeroed,
    halved, or half the ranks dropped) misses the reference's 4-device
    run, by its update or by its grad norms."""
    rc, tc, start, dkw = setup
    dp, losses, gnorms = port_dp(pool, tc, start, dkw, True, fault=fault)
    p0 = jax.tree.leaves(start.params)
    want, _, r_gnorms = reference_4dev(jax_4dev, True, 1, len(p0))
    upd, gn = agreement(dp.state().params, gnorms, want, r_gnorms, p0)
    assert upd > UPDATE_RTOL or gn > GNORM_RTOL, (upd, gn)


def test_dp_rejects_a_batch_that_does_not_split(setup, pool):
    rc, tc, start, dkw = setup
    dp = DS.DataParallel(pool, tc, configs()[1], compress=False)
    batch = make_batch(DataConfig(**dict(dkw, global_batch=6)), 0)
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        dp.run_step(batch)
    assert dp.step == 0


def test_dp_state_load_save_and_the_seed(setup, pool, tmp_path):
    """Replicas built from a seed hold the single-device ``init_state``'s
    bits; ``save`` writes the reference's format, which ``load`` reads."""
    _, tc, _, dkw = setup
    _, tt = configs()
    dp = DS.DataParallel(pool, tc, tt, compress=True, seed=3)
    local = TS.init_state(tc, tt, 3, device="cpu")
    assert dp.fingerprint() == T.fingerprint(local.params)
    dp.run_step(make_batch(DataConfig(**dkw), 0))
    dp.save(str(tmp_path), 1)
    assert ckpt.latest_step(str(tmp_path)) == 1
    saved = ckpt.restore(str(tmp_path), 1, local, device="cpu")
    assert T.fingerprint(saved) == T.fingerprint(dp.state())
    other = DS.DataParallel(pool, tc, tt, compress=True, seed=4)
    assert other.fingerprint() != dp.fingerprint()
    other.load(str(tmp_path))
    assert other.step == 1 and other.fingerprint() == dp.fingerprint()


# ----------------------------------------------------------- the trainer
def loop(d, steps=4, every=100):
    return LoopConfig(num_steps=steps, ckpt_dir=str(d), ckpt_every=every,
                      log_every=0)


def test_trainer_grad_sync_validation(setup, pool):
    _, tc, _, dkw = setup
    _, tt = configs()
    d = DataConfig(**dkw)
    with pytest.raises(ValueError, match="unknown grad_sync"):
        Trainer(tc, tt, d, LoopConfig(), grad_sync="bogus", pool=pool)
    with pytest.raises(ValueError, match="needs a pool"):
        Trainer(tc, tt, d, LoopConfig(), grad_sync="psum")
    with pytest.raises(ValueError, match="not both"):
        Trainer(tc, tt, d, LoopConfig(), grad_sync="psum", pool=pool,
                step_fn=lambda s, b: (s, {}))


def test_trainer_grad_sync_flag(setup, pool, tmp_path):
    """The reference's flag test: the compressed DP trainer follows the
    single-device trainer's losses within 5e-2."""
    _, tc, _, dkw = setup
    _, tt = configs()
    d = DataConfig(**dkw)
    ref = Trainer(tc, tt, d, loop(tmp_path / "ref"), device="cpu")
    ref.run(0)
    tr = Trainer(tc, tt, d, loop(tmp_path / "dp"),
                 grad_sync="compressed_psum", pool=pool)
    state = tr.run(0)
    assert isinstance(state, DS.DataParallel) and state.step == 4
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log],
                               [m["loss"] for m in ref.metrics_log],
                               rtol=0, atol=5e-2)


@pytest.mark.parametrize("grad_sync", ["psum", "compressed_psum"])
def test_dp_trainer_resumes_bit_exact(setup, pool, tmp_path, grad_sync):
    """A DP run failed at step 5 resumes from its step-4 checkpoint and
    repeats the uninterrupted run's losses bit for bit (the int32 sum is
    exact, so this holds with compression too)."""
    _, tc, _, dkw = setup
    _, tt = configs()
    d = DataConfig(**dkw)

    def trainer(name):
        return Trainer(tc, tt, d, loop(tmp_path / name, steps=8, every=4),
                       grad_sync=grad_sync, pool=pool)

    ref = trainer("a")
    ref.run(0)
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer("b").run(0, fail_at=5)
    assert ckpt.latest_step(str(tmp_path / "b")) == 4
    resumed = trainer("b")
    state = resumed.run(0)
    want = {m["step"]: m["loss"] for m in ref.metrics_log}
    assert [m["step"] for m in resumed.metrics_log] == [4, 5, 6, 7]
    assert all(m["loss"] == want[m["step"]] for m in resumed.metrics_log)
    assert state.step == 8 and ckpt.latest_step(str(tmp_path / "b")) == 8


def test_elastic_restart_example_on_the_cpu(capsys):
    """``examples/torch_elastic_restart.py`` at its smallest size."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_elastic_restart.py"
    spec = importlib.util.spec_from_file_location("torch_elastic", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref, resumed = mod.main(["--device", "cpu", "--steps", "6",
                             "--fail-at", "3"])
    assert [m["step"] for m in resumed.metrics_log] == [2, 3, 4, 5]
    assert "losses bit-exact vs reference: True" in capsys.readouterr().out
