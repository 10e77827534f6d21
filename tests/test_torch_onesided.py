"""The one-sided fused backend ``cuda-fused[comm=onesided,ranks=N]`` (K4).

On the CPU the backend runs K4's plain version (``taskbench_onesided_plain``)
over the same per-rank tables the kernel takes.  It is held:

- against the numpy oracle (``check_outputs``) for every pattern x kernel
  kind at 1, 2, 4 and 8 ranks, imbalanced, and on ragged widths;
- bitwise against the single-rank ``cuda-fused`` for the elementwise kinds;
- bitwise against the reference ``pallas-fused[comm=onesided]`` run on 4
  host devices in one child process (``reference_outputs``), where the
  reference's remote DMA puts really cross devices.  The reference is held
  only at the counts where XLA's FMA contraction on the CPU cannot show
  (see ``test_torch_backends.py``).
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
from repro_torch.backends import megakernel  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    MegakernelBackend, onesided_tables_from_numpy, taskbench_onesided,
    taskbench_onesided_plain)
from repro_torch.core import (check_outputs, execute_reference,  # noqa: E402
                              make_graph, pattern_names, replicate)
from repro_torch.dist import plan_comm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
KINDS = ["empty", "compute", "memory", "compute_mxu"]
# iterations per kind where XLA-CPU agrees with the oracle to the bit
CROSS_ITERS = {"empty": 4, "compute": 37, "memory": 7}
RAGGED = [(10, 4), (3, 4), (6, 8)]  # (width, ranks)
REF_RANKS = 4


def graph_kw(pattern, kind, iterations=5, **kw):
    args = dict(width=6, height=8, pattern=pattern, kernel=kind,
                iterations=iterations, imbalance=0.5, span_bytes=512,
                scratch_bytes=2048, **PATTERN_KW.get(pattern, {}))
    args.update(kw)
    return args


def onesided(ranks):
    return tb.get_backend(f"cuda-fused[comm=onesided,ranks={ranks},"
                          f"device=cpu]")


@pytest.fixture(scope="module")
def oracle():
    cache = {}

    def get(graph):
        if graph not in cache:
            cache[graph] = execute_reference(graph)
        return cache[graph]

    return get


# ------------------------------------------------------------ the oracle
@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pattern", pattern_names())
def test_onesided_matches_oracle(pattern, kind, ranks, oracle):
    g = make_graph(**graph_kw(pattern, kind, iterations=2
                              if kind == "compute_mxu" else 5))
    out = onesided(ranks).run([g])[0]
    assert out.shape == (g.width, g.payload_elems)
    check_outputs(g, out, expected=oracle(g))
    if kind != "compute_mxu":
        np.testing.assert_array_equal(out, oracle(g))


@pytest.mark.parametrize("width,ranks", RAGGED)
@pytest.mark.parametrize("pattern", pattern_names())
def test_onesided_ragged_widths(pattern, width, ranks, oracle):
    g = make_graph(**graph_kw(pattern, "compute", width=width,
                              output_bytes=36))
    assert plan_comm(g, ranks, "cols", comm="onesided").ragged
    out = onesided(ranks).run([g])[0]
    assert out.shape == (width, 9)
    check_outputs(g, out, expected=oracle(g))
    np.testing.assert_array_equal(out, oracle(g))


@pytest.mark.parametrize("kind", ["empty", "compute", "memory"])
@pytest.mark.parametrize("pattern", pattern_names())
def test_onesided_bitwise_equal_to_single_rank_fused(pattern, kind):
    g = make_graph(**graph_kw(pattern, kind, width=10))
    want = tb.get_backend("cuda-fused[device=cpu]").run([g])[0]
    for ranks in (2, 3, 4, 10):
        np.testing.assert_array_equal(onesided(ranks).run([g])[0], want)


@pytest.mark.parametrize("pattern", ["stencil", "spread"])
def test_onesided_run_many_matches_run(pattern):
    g = make_graph(**graph_kw(pattern, "compute"))
    be = onesided(4)
    single = be.run([g])[0]
    mixed = [g, make_graph(**graph_kw("fft", "memory", width=5))]
    outs = be.run_many(replicate(g, 3))
    assert len(outs) == 3
    for out in outs:
        np.testing.assert_array_equal(out, single)
    for h, out in zip(mixed, be.run_many(mixed)):
        np.testing.assert_array_equal(out, be.run([h])[0])


# ------------------------------------------------------------- options
def test_onesided_options():
    be = onesided(4)
    assert (be.comm, be.ranks, be.device) == ("onesided", 4,
                                              torch.device("cpu"))
    plain = tb.get_backend("cuda-fused[device=cpu]")
    assert (plain.comm, plain.ranks) == (None, None)
    assert be._build_stacked(replicate(make_graph(width=4, height=3), 2)) \
        is None


def test_onesided_ranks_default_to_one_on_the_cpu(oracle):
    """As the reference's takes its rank count from the devices, and as
    ``torch-csp`` defaults: the card count, or one rank on the CPU."""
    be = tb.get_backend("cuda-fused[comm=onesided,device=cpu]")
    assert (be.comm, be.ranks) == ("onesided", 1)
    g = make_graph(width=5, height=4, pattern="stencil", iterations=3)
    np.testing.assert_array_equal(be.run([g])[0], oracle(g))


@pytest.mark.parametrize("spec,match", [
    ("cuda-fused[comm=halo,device=cpu]", "comm must be 'onesided'"),
    ("cuda-fused[comm=onesided,ranks=-1,device=cpu]", "needs ranks"),
    ("cuda-fused[comm=onesided,ranks=0,device=cpu]", "needs ranks"),
    ("cuda-fused[comm=onesided,ranks=2.5,device=cpu]", "needs ranks"),
    ("cuda-fused[comm=onesided,ranks=True,device=cpu]", "needs ranks"),
    ("cuda-fused[ranks=4,device=cpu]", "needs comm=onesided"),
])
def test_onesided_option_validation(spec, match):
    with pytest.raises(ValueError, match=match):
        tb.get_backend(spec)


# ------------------------------------------------------- K4's wrapper
def staged(g, ranks, device="cpu"):
    plan = plan_comm(g, ranks, "cols", comm="onesided")
    offsets, tabs = MegakernelBackend._onesided_tables(g, plan)
    return offsets, tabs, onesided_tables_from_numpy(offsets, tabs, device)


def test_cpu_wrapper_runs_plain_and_counts_no_launch(monkeypatch):
    g = make_graph(width=6, height=5, pattern="fft", iterations=3)
    _, _, tabs = staged(g, 3)
    kw = dict(kernel=g.kernel, height=5, payload_elems=g.payload_elems)
    # the wrapper takes the plain version, held by a spy rather than by a
    # second call of the plain version
    calls = []

    def plain(*args, **kwargs):
        calls.append((args, kwargs, taskbench_onesided_plain(*args,
                                                             **kwargs)))
        return calls[-1][2]

    monkeypatch.setattr(megakernel, "taskbench_onesided_plain", plain)
    before = taskbench_onesided.launches
    got = taskbench_onesided(*tabs, **kw)
    assert taskbench_onesided.launches == before
    assert len(calls) == 1 and got is calls[0][2]
    assert all(a is b for a, b in zip(calls[0][0], tabs))
    assert got.shape == (6, g.payload_elems)


def test_wrapper_rejects_bad_tables():
    g = make_graph(width=8, height=4, pattern="stencil", iterations=2,
                   kernel="compute_mxu")
    offsets, raw, tabs = staged(g, 4)
    idx, mask, iters, base, send_rows, offs, w = tabs
    kw = dict(kernel=g.kernel, height=4, payload_elems=g.payload_elems)
    with pytest.raises(ValueError, match="weight"):
        taskbench_onesided(idx, mask, iters, base, send_rows, offs, None,
                           **kw)
    with pytest.raises(ValueError, match="mask must be int32"):
        taskbench_onesided(idx, mask.to(torch.int64), iters, base,
                           send_rows, offs, w, **kw)
    with pytest.raises(ValueError, match="idx must be"):
        taskbench_onesided(*tabs, **{**kw, "height": 5})
    with pytest.raises(ValueError, match="send_rows must be int32"):
        taskbench_onesided(idx, mask, iters, base, send_rows[:, :1], offs,
                           w, **kw)
    bad = (np.full_like(raw[0], 99),) + raw[1:]
    with pytest.raises(ValueError, match="dependency slots"):
        onesided_tables_from_numpy(offsets, bad, "cpu")
    bad = raw[:4] + (np.full_like(raw[4], 2),) + raw[5:]
    with pytest.raises(ValueError, match="put rows"):
        onesided_tables_from_numpy(offsets, bad, "cpu")
    with pytest.raises(ValueError, match="ring offsets"):
        onesided_tables_from_numpy([1, 4], raw, "cpu")


def test_plain_version_puts_through_the_inbox():
    """Swapping the rows the puts carry changes what crosses ranks: the
    consumers' dependency checksums must change with it."""
    g = make_graph(width=8, height=5, pattern="stencil", iterations=2)
    _, _, tabs = staged(g, 4)
    kw = dict(kernel=g.kernel, height=5, payload_elems=g.payload_elems)
    good = taskbench_onesided_plain(*tabs, **kw)
    rolled = list(tabs)
    rolled[4] = (tabs[4] + 1) % 2
    assert not torch.equal(taskbench_onesided_plain(*rolled, **kw)[:, 3],
                           good[:, 3])


# --------------------------------------- the reference on 4 host devices
def cross_check_cases():
    cases = {}
    for pattern in pattern_names():
        for kind, its in CROSS_ITERS.items():
            cases[f"{pattern}-{kind}"] = graph_kw(pattern, kind, its)
    for width in (10, 3):
        cases[f"ragged{width}-stencil-compute"] = graph_kw(
            "stencil", "compute", 37, width=width, output_bytes=36)
        cases[f"ragged{width}-spread-memory"] = graph_kw(
            "spread", "memory", 7, width=width)
    return cases


CASES = cross_check_cases()

CHILD = """
import json, sys
import numpy as np
import repro.core as rc
from repro.backends import get_backend
cases = json.loads(sys.argv[1])
be = get_backend("pallas-fused[comm=onesided]")
assert be.ndev == {ranks}, be.ndev
names = sorted(cases)
outs = be.run([rc.make_graph(**cases[n]) for n in names])
np.savez(sys.argv[2], **{{n: np.asarray(o) for n, o in zip(names, outs)}})
""".format(ranks=REF_RANKS)


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    """One child process: the reference one-sided kernel on every case."""
    out = tmp_path_factory.mktemp("onesided") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{REF_RANKS}",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_NUM_CPU_DEVICES", None)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(CASES), str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out) as data:
        return {name: data[name] for name in data.files}


@pytest.mark.parametrize("case", sorted(CASES))
def test_onesided_bitwise_equal_to_reference_on_four_devices(
        case, reference_outputs):
    g = make_graph(**CASES[case])
    got = onesided(REF_RANKS).run([g])[0]
    want = reference_outputs[case]
    assert got.shape == want.shape == (g.width, g.payload_elems)
    np.testing.assert_array_equal(got, want)
