"""The message-passing backends ``torch-csp`` and ``torch-pipeline``.

Ranks are processes (``repro_torch.dist.ranks``) in one gloo group; on the
CPU (``[device=cpu]``) each rank's body runs the kernels' plain versions.
One pool of rank processes per rank count serves the whole module (the
backends share ``get_pool``'s cache) and is closed at its end.  Held:

- bitwise against the numpy oracle and ``torch-scan[device=cpu]`` at 1,
  2 and 4 ranks, on every pattern, in every mode with and without
  ``comm_overlap``, on ragged widths (10 and 3 over 4 ranks; width 3
  leaves one column a rank, the kernel loop's dynamic mode), imbalanced,
  and ``run_many`` against ``run``;
- against the reference ``shardmap-csp``/``shardmap-pipeline`` on 4 host
  devices in one child process: slots 0-3 bitwise everywhere, slot 4 and
  up bitwise at the iteration counts where XLA's FMA contraction on the
  CPU cannot show and within rtol 1e-6 elsewhere;
- ``torch-csp[comm=onesided]`` bitwise against K4's plain version
  (``cuda-fused[comm=onesided,ranks=4,device=cpu]``);
- a rank that raises or hangs surfaces in the controller within the
  timeout, and closing a pool leaves no child process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.backends as tb  # noqa: E402
from repro_torch.backends import csp  # noqa: E402
from repro_torch.core import (check_outputs, execute_reference,  # noqa: E402
                              make_graph, pattern_names, replicate)
from repro_torch.dist import (RankError, RankPool, get_pool,  # noqa: E402
                              plan_comm)
from repro_torch.dist import ranks as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
# iterations per kind where XLA-CPU agrees with the oracle to the bit
CROSS_ITERS = {"empty": 4, "compute": 37, "memory": 7}
MODES = ["comm=auto", "comm=allgather", "comm=a2a", "comm=onesided"]
REF_RANKS = 4
CPU = torch.device("cpu")


def graph_kw(pattern, kind="compute", iterations=5, **kw):
    args = dict(width=10, height=6, pattern=pattern, kernel=kind,
                iterations=iterations, imbalance=0.5, span_bytes=512,
                scratch_bytes=2048, **PATTERN_KW.get(pattern, {}))
    args.update(kw)
    return args


def backend(ranks, options="", name="torch-csp"):
    opts = f"{options}," if options else ""
    return tb.get_backend(f"{name}[{opts}ranks={ranks},device=cpu]")


@pytest.fixture(scope="module", autouse=True)
def pools():
    """The module's rank pools, closed when it is done."""
    yield
    R.close_pools()


@pytest.fixture(scope="module")
def oracle():
    cache = {}

    def get(graph):
        if graph not in cache:
            cache[graph] = execute_reference(graph)
        return cache[graph]

    return get


@pytest.fixture(scope="module")
def scan():
    be = tb.get_backend("torch-scan[device=cpu]")
    cache = {}

    def get(graph):
        if graph not in cache:
            cache[graph] = be.run([graph])[0]
        return cache[graph]

    return get


def held(graph, out, oracle, scan):
    """``out`` passes check_outputs, and is bitwise the oracle's (for the
    elementwise kinds) and ``torch-scan``'s."""
    assert out.shape == (graph.width, graph.payload_elems)
    check_outputs(graph, out, expected=oracle(graph))
    if graph.kernel.kind != "compute_mxu":
        np.testing.assert_array_equal(out, oracle(graph))
    np.testing.assert_array_equal(out, scan(graph))


# --------------------------------------- the oracle and torch-scan
@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("pattern", pattern_names())
def test_csp_matches_oracle_and_scan(pattern, ranks, oracle, scan):
    g = make_graph(**graph_kw(pattern))
    held(g, backend(ranks).run([g])[0], oracle, scan)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pattern", pattern_names())
def test_csp_every_mode_matches_oracle_and_scan(pattern, mode, overlap,
                                                oracle, scan):
    g = make_graph(**graph_kw(pattern))
    be = backend(4, f"{mode},comm_overlap={overlap}")
    held(g, be.run([g])[0], oracle, scan)


@pytest.mark.parametrize("spec,pattern", [
    ("comm=ring", "sweep"), ("comm=halo", "stencil"),
    ("comm=halo", "nearest"), ("comm=ring", "trivial")])
@pytest.mark.parametrize("overlap", [False, True])
def test_csp_ppermute_modes_asked_for(spec, pattern, overlap, oracle, scan):
    g = make_graph(**graph_kw(pattern))
    be = backend(4, f"{spec},comm_overlap={overlap}")
    assert be.plan(g).mode == spec.split("=")[1]
    held(g, be.run([g])[0], oracle, scan)


@pytest.mark.parametrize("kind", ["empty", "memory", "compute_mxu"])
@pytest.mark.parametrize("mode", MODES)
def test_csp_kernel_kinds(kind, mode, oracle, scan):
    g = make_graph(**graph_kw("nearest", kind,
                              2 if kind == "compute_mxu" else 5))
    held(g, backend(4, mode).run([g])[0], oracle, scan)


@pytest.mark.parametrize("width", [10, 3])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_csp_ragged_widths(mode, overlap, width, oracle, scan):
    """Width 10 over 4 ranks pads to 12; width 3 leaves a rank only a dead
    column and every rank one column: the dynamic kernel loop."""
    g = make_graph(**graph_kw("stencil", width=width, output_bytes=36,
                              imbalance=2.0))
    be = backend(4, f"{mode},comm_overlap={overlap}")
    plan = be.plan(g)
    assert plan.ragged and plan.local == (3 if width == 10 else 1)
    held(g, be.run([g])[0], oracle, scan)


@pytest.mark.parametrize("kind", ["compute", "memory", "compute_mxu"])
def test_csp_dynamic_mode_one_column_a_rank(kind, oracle, scan):
    g = make_graph(**graph_kw("fft", kind, 3, width=4, imbalance=2.0))
    be = backend(4, "comm=onesided")
    assert be.plan(g).local == 1
    held(g, be.run([g])[0], oracle, scan)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_csp_run_many_matches_run(mode, overlap):
    be = backend(4, f"{mode},comm_overlap={overlap}")
    g = make_graph(**graph_kw("stencil"))
    single = be.run([g])[0]
    same = replicate(g, 3)
    outs = be.run_many(same)
    assert len(outs) == 3
    for out in outs:
        np.testing.assert_array_equal(out, single)
    # same height, different widths, kinds and patterns: one program
    mixed = [g, make_graph(**graph_kw("spread", "memory", width=5)),
             make_graph(**graph_kw("sweep", width=3, output_bytes=40))]
    for h, out in zip(mixed, be.run_many(mixed)):
        np.testing.assert_array_equal(out, be.run([h])[0])
    # heights that differ: each graph its own program
    taller = [g, make_graph(**graph_kw("nearest", height=9))]
    for h, out in zip(taller, be.run_many(taller)):
        np.testing.assert_array_equal(out, be.run([h])[0])


@pytest.mark.parametrize("pattern", pattern_names())
def test_pipeline_matches_oracle_and_scan(pattern, oracle, scan):
    g = make_graph(**graph_kw(pattern))
    be = backend(4, name="torch-pipeline")
    if pattern == "sweep":
        assert be.plan(g).mode == "ring" and be.axis == "stage"
    held(g, be.run([g])[0], oracle, scan)
    held(g, backend(4, "comm_overlap=True", "torch-pipeline").run([g])[0],
         oracle, scan)


def test_pipeline_run_many_matches_run():
    be = backend(4, name="torch-pipeline")
    graphs = [make_graph(**graph_kw("sweep")),
              make_graph(**graph_kw("sweep", "memory", width=7))]
    for g, out in zip(graphs, be.run_many(graphs)):
        np.testing.assert_array_equal(out, be.run([g])[0])


# ---------------------------------------------------- K4's plain version
@pytest.mark.parametrize("kind", ["empty", "compute", "memory"])
@pytest.mark.parametrize("pattern", pattern_names())
def test_onesided_equals_k4_plain(pattern, kind):
    g = make_graph(**graph_kw(pattern, kind))
    k4 = tb.get_backend("cuda-fused[comm=onesided,ranks=4,device=cpu]")
    for overlap in (False, True):
        got = backend(4, f"comm=onesided,comm_overlap={overlap}").run([g])[0]
        np.testing.assert_array_equal(got, k4.run([g])[0])


# --------------------------------------------------- the program shapes
def test_overlap_exchanges_as_often_as_blocking():
    """Both forms issue exactly H exchanges (the last step of the
    double-buffered form runs outside its loop): the gloo ops a rank
    posts are the same; each stages its rows out and back."""
    g = make_graph(**graph_kw("stencil", height=7))
    ops = {}
    for overlap in (False, True):
        runner = backend(4, f"comm_overlap={overlap}").prepare([g])
        runner()
        stats = runner.stats[0]
        # on the CPU K1 runs its plain version: no kernel launched
        assert [s["launches"] for s in stats] == [{}] * 4
        ops[overlap] = [s["ops"] for s in stats]
        # a halo step: a send and a receive to each neighbour there is
        assert ops[overlap] == [2 * 7, 4 * 7, 4 * 7, 2 * 7]
        assert all(s["copies"] == s["ops"] for s in stats)
        assert all(s["wall_s"] >= s["body_s"] > 0 for s in stats)
    assert ops[False] == ops[True]


def test_csp_options_and_default_ranks(monkeypatch):
    be = backend(4, "comm=a2a,comm_overlap=True")
    assert (be.comm, be.comm_overlap, be.ndev, be.device) == (
        "a2a", True, 4, CPU)
    assert tb.get_backend("torch-csp[device=cpu]").ndev == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tb.get_backend("torch-csp").ndev == 3
    assert tb.get_backend("torch-pipeline[ranks=2]").ndev == 2


@pytest.mark.parametrize("spec,match", [
    ("torch-csp[comm=bogus,device=cpu]", "unknown comm mode"),
    ("torch-csp[ranks=0,device=cpu]", "positive int"),
    ("torch-csp[ranks=True,device=cpu]", "positive int"),
    ("torch-pipeline[ranks=2.5,device=cpu]", "positive int")])
def test_csp_option_validation(spec, match):
    with pytest.raises(ValueError, match=match):
        tb.get_backend(spec)


def test_plan_shards_are_what_a_rank_is_handed():
    g = make_graph(**graph_kw("nearest", width=10))
    plan = plan_comm(g, 4, "cols")
    head = plan.without_tables()
    assert head.local_mats.shape[1] == head.iters.shape[1] == 0
    assert head.context_width == plan.context_width
    mats = np.concatenate([plan.shard(r)[0] for r in range(4)], axis=1)
    iters = np.concatenate([plan.shard(r)[1] for r in range(4)], axis=1)
    np.testing.assert_array_equal(mats, plan.local_mats)
    np.testing.assert_array_equal(iters, plan.iters)


# ------------------------------------- the runtime half of CommPlan
def _exchange_on_rank(ctx, plan, rows, async_op):
    """Rank side of ``test_exchange_semantics``: this rank's rows through
    ``plan.exchange`` (ranks import this module by name)."""
    got = plan.exchange(torch.as_tensor(rows[ctx.rank]), ctx.comm, async_op,
                        tag=3)
    return (got.wait() if async_op else got).numpy()


def exchange_model(plan, rows, r):
    """What the reference's ``exchange`` gives rank r (numpy)."""
    h, n, zeros = plan.halo, plan.ndev, np.zeros_like(rows[r][:plan.halo])
    if plan.mode == "allgather":
        return np.concatenate(rows)
    if plan.mode in ("ring", "halo"):
        left = rows[r - 1][-h:] if r > 0 else zeros
        right = rows[r + 1][:h] if r < n - 1 else zeros
        return np.concatenate([left, rows[r]] + (
            [right] if plan.mode == "halo" else []))
    recv = np.stack([rows[s][plan.a2a_send_idx[s, r]] for s in range(n)])
    if plan.mode == "onesided":  # unsignalled slots (dead pairs) are zeros
        recv[plan.send_counts[:, r] == 0] = 0
    return np.concatenate([recv.reshape(-1, rows[r].shape[-1]), rows[r]])


@pytest.mark.parametrize("async_op", [False, True])
@pytest.mark.parametrize("comm,pattern", [
    ("ring", "sweep"), ("halo", "stencil"), ("halo", "nearest"),
    ("allgather", "fft"), ("a2a", "random"), ("onesided", "random"),
    ("onesided", "stencil")])
def test_exchange_semantics(comm, pattern, async_op):
    """Ring and halo do not wrap (a rank with no source gets zeros),
    allgather is tiled in rank order, a2a sends each pair its slots, and
    the stateless one-sided exchange is one put and the wait of epoch 1."""
    g = make_graph(**graph_kw(pattern, width=12, radix=5)
                   if pattern == "nearest" else graph_kw(pattern, width=12))
    plan = plan_comm(g, 4, "cols", comm=comm)
    rng = np.random.RandomState(7)
    rows = [rng.standard_normal((plan.local, 6)).astype(np.float32)
            for _ in range(4)]
    got = get_pool(4, CPU).call(_exchange_on_rank, plan.without_tables(),
                                rows, async_op)
    for r in range(4):
        assert got[r].shape == (plan.context_width, 6)
        np.testing.assert_array_equal(got[r], exchange_model(plan, rows, r))


# ----------------------------------------------- failure and cleanup
def _bad_job(pool, good_plan, g, bad_rank):
    """Stage a halo job whose ``bad_rank`` gets matrices one context
    column too wide: its first body raises while its neighbours wait in
    gloo for the rows of its next step."""
    job = pool.new_job()
    args = []
    for r in range(pool.ranks):
        mats, iters = good_plan.shard(r)
        if r == bad_rank:
            mats = np.zeros(mats.shape[:2] + (mats.shape[2] + 1,), mats.dtype)
        args.append((job, [(g, good_plan.without_tables(), mats, iters)]))
    pool.map(csp._rank_stage, args)
    return job


def test_a_rank_that_raises_raises_in_the_controller():
    pool = RankPool(2, CPU)
    g = make_graph(**graph_kw("stencil", height=20))
    job = _bad_job(pool, plan_comm(g, 2, "cols"), g, bad_rank=1)
    procs = list(pool._procs)
    with pytest.raises(RankError, match="(?s)rank 1 raised.*_rank_run"):
        pool.call(csp._rank_run, job, timeout_s=60)
    # the failed pool is closed at once, leaving no child process
    assert not pool.alive
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)


def test_a_rank_that_hangs_raises_at_the_timeout():
    """Rank 0 posts a halo exchange, rank 1 an all-gather: neither
    answers, and the controller gives up at the call's timeout."""
    pool = RankPool(2, CPU)
    g = make_graph(**graph_kw("stencil"))
    halo, gather = plan_comm(g, 2, "cols"), plan_comm(g, 2, "cols",
                                                      comm="allgather")
    job = pool.new_job()
    pool.map(csp._rank_stage, [
        (job, [(g, p.without_tables(), *p.shard(r))])
        for r, p in enumerate((halo, gather))])
    procs = list(pool._procs)
    with pytest.raises(RankError, match="did not answer within 2"):
        pool.call(csp._rank_run, job, timeout_s=2)
    assert all(not p.is_alive() for p in procs)


def test_closing_a_pool_leaves_no_child_process():
    import multiprocessing

    pool = get_pool(2, CPU)
    assert get_pool(2, CPU) is pool
    assert [i["pid"] for i in pool.info] == [p.pid for p in pool._procs]
    procs = list(pool._procs)
    pool.close()
    assert not pool.alive
    assert all(p.exitcode is not None for p in procs)
    alive = {p.pid for p in multiprocessing.active_children()}
    assert not alive & {p.pid for p in procs}
    assert get_pool(2, CPU) is not pool  # a closed pool is started anew
    with pytest.raises(RankError, match="closed"):
        pool.call(csp.launch_counts)


# --------------------------------------- the reference on 4 host devices
REF_SPECS = {
    "torch-csp": "shardmap-csp",
    "torch-csp[comm_overlap=True]": "shardmap-csp[comm_overlap=True]",
    "torch-csp[comm=a2a]": "shardmap-csp[comm=a2a]",
    "torch-csp[comm=onesided]": "shardmap-csp[comm=onesided]",
    "torch-csp[comm=onesided,comm_overlap=True]":
        "shardmap-csp[comm=onesided,comm_overlap=True]",
    "torch-pipeline": "shardmap-pipeline",
}


def cross_check_cases():
    """name -> (graph kwargs, bitwise in every slot)."""
    its = CROSS_ITERS
    cases = {}
    for pattern in ("stencil", "nearest", "sweep", "fft", "spread"):
        cases[f"{pattern}-compute"] = (graph_kw(
            pattern, "compute", its["compute"], width=6, height=8), True)
    cases["tree-memory"] = (graph_kw("tree", "memory", its["memory"],
                                     width=6), True)
    cases["random-empty"] = (graph_kw("random", "empty", its["empty"],
                                      width=6), True)
    cases["ragged10-stencil-compute"] = (graph_kw(
        "stencil", "compute", its["compute"], output_bytes=36), True)
    cases["ragged3-sweep-memory"] = (graph_kw(
        "sweep", "memory", its["memory"], width=3), True)
    # counts where the reference's FMA contraction shows in slot 4
    cases["nearest-compute5"] = (graph_kw("nearest", "compute", 5), False)
    cases["ragged3-stencil-compute5"] = (graph_kw("stencil", "compute", 5,
                                                  width=3), False)
    return cases


CASES = cross_check_cases()

CHILD = """
import json, sys
import numpy as np
import repro.core as rc
from repro.backends import get_backend
specs, cases = json.loads(sys.argv[1])
names = sorted(cases)
graphs = [rc.make_graph(**cases[n][0]) for n in names]
out = {}
for spec in specs:
    be = get_backend(spec)
    assert be.ndev == %d, be.ndev
    for n, o in zip(names, be.run(graphs)):
        out[spec + "|" + n] = np.asarray(o)
np.savez(sys.argv[2], **out)
""" % REF_RANKS


@pytest.fixture(scope="module", autouse=True)
def reference_child(tmp_path_factory):
    """One child process running the reference backends on every case,
    started before the module's first test so it runs beside them."""
    out = tmp_path_factory.mktemp("csp") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{REF_RANKS}",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_NUM_CPU_DEVICES", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD,
         json.dumps([sorted(REF_SPECS.values()), CASES]), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference_outputs(reference_child):
    proc, out = reference_child
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log
    with np.load(out) as data:
        return {name: data[name] for name in data.files}


@pytest.mark.parametrize("spec", sorted(REF_SPECS))
def test_equal_to_reference_on_four_devices(spec, reference_outputs):
    name, opts = tb.parse_backend_spec(spec)
    be = tb.get_backend(name, ranks=REF_RANKS, device="cpu", **opts)
    names = sorted(CASES)
    graphs = [make_graph(**CASES[n][0]) for n in names]
    for n, g, got in zip(names, graphs, be.run(graphs)):
        want = reference_outputs[REF_SPECS[spec] + "|" + n]
        assert got.shape == want.shape == (g.width, g.payload_elems), n
        np.testing.assert_array_equal(got[:, :4], want[:, :4], err_msg=n)
        if CASES[n][1]:
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=1e-6,
                                       atol=0, err_msg=n)
