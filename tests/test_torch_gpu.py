"""The CUDA kernels K1-K6 on the card, against their plain versions, and
the backends that launch them.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without
one.  The file imports neither JAX nor the reference package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    K3_COUNTERS, MegakernelBackend, fused_blocks, onesided_tables_from_numpy,
    tables_from_numpy, taskbench_fused, taskbench_fused_plain,
    taskbench_onesided, taskbench_onesided_plain)
from repro_torch.core import make_graph, pattern_names, replicate  # noqa: E402
from repro_torch.core.graph import CHECKSUM_MOD  # noqa: E402
from repro_torch.dist import plan_comm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import (taskbench_compute,  # noqa: E402
                                 taskbench_compute_plain, taskbench_memory,
                                 taskbench_memory_plain)
from repro_torch.kernels import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.bodies import FOLD_BLOCK, memory_geometry  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ssd import (_with_skip, ssd_chunked,  # noqa: E402
                                     ssd_chunked_plain, uses_tensor_cores)

COMPUTE_CASES = [(8, 12), (16, 40), (32, 7)]      # tests/test_kernels.py
MEMORY_CASES = [(1024, 128, 7), (2048, 256, 0), (512, 512, 9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("width,max_iters", COMPUTE_CASES + [(132, 16)])
def test_k1_on_card_is_bitwise_with_plain(cuda, width, max_iters):
    rng = np.random.RandomState(width)
    tiles = torch.from_numpy(rng.uniform(-1, 0.5, (width, 8, 128))
                             .astype(np.float32)).to(cuda)
    its = torch.from_numpy(rng.randint(0, max_iters + 1, width)
                           .astype(np.int32)).to(cuda)
    n = taskbench_compute.launches
    got = taskbench_compute(tiles, its, max_iters)
    assert taskbench_compute.launches == n + 1
    assert torch.equal(got, taskbench_compute_plain(tiles, its, max_iters))


@pytest.mark.gpu
@pytest.mark.parametrize("size,span,iterations", MEMORY_CASES)
def test_k2_on_card_is_bitwise_with_plain(cuda, size, span, iterations):
    x = (torch.arange(size, dtype=torch.float32) / size).to(cuda)
    assert torch.equal(taskbench_memory(x, iterations, span),
                       taskbench_memory_plain(x, iterations, span))
    rows = torch.rand(4, size, generator=torch.Generator().manual_seed(0))
    its = torch.tensor([0, 1, iterations, 40], dtype=torch.int32)
    rows, its = rows.to(cuda), its.to(cuda)
    assert torch.equal(taskbench_memory(rows, its, span),
                       taskbench_memory_plain(rows, its, span))


# bodies.cuh::memory_window: a group of the 16-byte walk is kThreads *
# kWideUnroll float4s (256 * 8 * 4 values).  Windows within one group,
# of whole groups, with a tail past them, and two the walk takes as floats
# (a span that is not a multiple of 4, and of 1).
WIDE_GROUP = 256 * 8 * 4
WALK_SPANS = [16, WIDE_GROUP, WIDE_GROUP + 20, WIDE_GROUP + 21, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("span", WALK_SPANS)
@pytest.mark.parametrize("offset", [0, 1])
def test_k2_wide_and_plain_walks_are_bitwise_with_plain(cuda, span, offset):
    """K2 walks float4s where the wrapper finds every window on 16 bytes
    and floats elsewhere (a view 4 bytes into its buffer, a span that is
    not a multiple of 4): bitwise its plain version either way, with row
    counts below, at and above the row's 3 windows (0, 1 and 2+ steps a
    window), and counted in ``wide_launches`` on the first path only."""
    rows, size = 4, 3 * span
    buf = torch.rand(rows * size + 1,
                     generator=torch.Generator().manual_seed(span)).to(cuda)
    x = buf[offset:offset + rows * size].view(rows, size)
    its = torch.tensor([0, 2, 3, 7], dtype=torch.int32, device=cuda)
    wide = int(span % 4 == 0 and offset == 0)
    for args in ((x, its, span), (x[1], 7, span)):
        n, w = taskbench_memory.launches, taskbench_memory.wide_launches
        got = taskbench_memory(*args)
        assert (taskbench_memory.launches - n,
                taskbench_memory.wide_launches - w) == (1, wide)
        assert torch.equal(got, taskbench_memory_plain(*args))


def memory_rows_left(wave, iters, kernel):
    """The scratch rows a memory body leaves at the last timestep, from
    plain parts: each task's row filled with 1 + acc * 2^-46 (acc from the
    wave's base and combined slots) and walked by K2's plain version with
    the task's last count."""
    span, size, _ = memory_geometry(kernel)
    acc = (wave[:, 3].to(torch.int64) - wave[:, 2].to(torch.int64)) \
        % CHECKSUM_MOD
    start = acc.to(torch.float32) * FOLD_BLOCK + 1.0
    rows = start[:, None].expand(-1, size).contiguous()
    its = iters.reshape(-1).clamp(0, kernel.iterations).to(torch.int32)
    return taskbench_memory_plain(rows, its, span)


def with_scratch(monkeypatch, call, size):
    """``call()`` and the (tasks, size) scratch its wrapper allocated."""
    made, empty = [], torch.empty

    def kept(*args, **kwargs):
        made.append(empty(*args, **kwargs))
        return made[-1]

    with monkeypatch.context() as m:
        m.setattr(torch, "empty", kept)
        out = call()
    scratch, = [t for t in made if t.dim() == 2 and t.shape[1] == size]
    return out, scratch


# (span, windows a row, iterations): 0, 1 and 2+ steps a window, and the
# benchmark's memory cells (64 KiB windows, 2 MiB rows, 32 iterations)
MEMORY_BODY_CASES = [(span, 3, its) for span in WALK_SPANS
                     for its in (2, 3, 7)] + [(16384, 32, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("span,nwin,iterations", MEMORY_BODY_CASES)
def test_k3_k4_memory_body_is_bitwise_on_both_walks(cuda, monkeypatch, span,
                                                    nwin, iterations):
    """K3's and K4's memory body, on float4s where the span is a multiple
    of 4 (the wrappers' scratch is aligned) and on floats elsewhere: the
    wave bitwise their plain versions', every task's scratch row bitwise
    the plain fill and walk, and counted in ``wide_launches`` on the first
    path only."""
    g = make_graph(width=8, height=4, pattern="stencil", kernel="memory",
                   iterations=iterations, span_bytes=4 * span,
                   scratch_bytes=4 * span * nwin)
    assert memory_geometry(g.kernel) == (span, span * nwin, nwin)
    wide = int(span % 4 == 0)
    tabs = tables_from_numpy(MegakernelBackend._tables(
        [g], max(1, g.max_radix())), cuda)
    kw = dict(kernel=g.kernel, height=g.height,
              payload_elems=g.payload_elems)
    n, w = taskbench_fused.launches, taskbench_fused.wide_launches
    got, scratch = with_scratch(
        monkeypatch, lambda: taskbench_fused(*tabs, ngraphs=1, **kw),
        span * nwin)
    assert (taskbench_fused.launches - n,
            taskbench_fused.wide_launches - w) == (1, wide)
    assert torch.equal(got, taskbench_fused_plain(*tabs, ngraphs=1, **kw))
    assert torch.equal(scratch, memory_rows_left(got, tabs[2][-1], g.kernel))

    tabs = onesided_tables(g, 4, cuda)
    n, w = taskbench_onesided.launches, taskbench_onesided.wide_launches
    got, scratch = with_scratch(
        monkeypatch, lambda: taskbench_onesided(*tabs, **kw), span * nwin)
    assert (taskbench_onesided.launches - n,
            taskbench_onesided.wide_launches - w) == (1, wide)
    assert torch.equal(got, taskbench_onesided_plain(*tabs, **kw))
    assert torch.equal(scratch,
                       memory_rows_left(got, tabs[2][:, -1], g.kernel))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
@pytest.mark.parametrize("pattern", ["stencil", "fft", "random"])
def test_k3_on_card_matches_plain(cuda, kind, pattern):
    g = make_graph(width=8, height=8, pattern=pattern, kernel=kind,
                   iterations=5, imbalance=0.5, span_bytes=512,
                   scratch_bytes=2048)
    for graphs in ([g], replicate(g, 3)):
        tabs = tables_from_numpy(MegakernelBackend._tables(
            graphs, max(1, g.max_radix())), cuda)
        kw = dict(kernel=g.kernel, ngraphs=len(graphs), height=g.height,
                  payload_elems=g.payload_elems)
        got, want = taskbench_fused(*tabs, **kw), taskbench_fused_plain(
            *tabs, **kw)
        if kind == "compute_mxu":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got, want)


def profiled_kernels(runner) -> list:
    """Names of the CUDA kernels ``torch.profiler`` records in one run."""
    from torch.profiler import ProfilerActivity, profile

    runner()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


@pytest.mark.gpu
@pytest.mark.parametrize("ngraphs", [1, 3])
def test_k3_is_one_cuda_kernel_per_run(cuda, ngraphs):
    g = make_graph(width=8, height=6, iterations=4)
    runner = get_backend("cuda-fused").prepare_many(replicate(g, ngraphs))
    kernels = profiled_kernels(runner)
    assert len(kernels) == 1, kernels


def onesided_tables(g, ranks, device):
    offsets, tabs = MegakernelBackend._onesided_tables(
        g, plan_comm(g, ranks, "cols", comm="onesided"))
    return onesided_tables_from_numpy(offsets, tabs, device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
@pytest.mark.parametrize("pattern", ["stencil", "fft", "random", "spread"])
def test_k4_on_card_matches_plain(cuda, kind, pattern):
    for width, ranks in ((8, 2), (10, 4), (6, 8), (8, 8)):
        g = make_graph(width=width, height=8, pattern=pattern, kernel=kind,
                       iterations=5, imbalance=0.5, span_bytes=512,
                       scratch_bytes=2048)
        tabs = onesided_tables(g, ranks, cuda)
        kw = dict(kernel=g.kernel, height=g.height,
                  payload_elems=g.payload_elems)
        n = taskbench_onesided.launches
        got = taskbench_onesided(*tabs, **kw)
        assert taskbench_onesided.launches == n + 1
        want = taskbench_onesided_plain(*tabs, **kw)
        if kind == "compute_mxu":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(got, want), (width, ranks)


@pytest.mark.gpu
@pytest.mark.parametrize("ngraphs", [1, 3])
def test_k4_is_one_cuda_kernel_per_graph(cuda, ngraphs):
    """The launch counter holds the count: one K4 a graph.  The profiler
    can miss whole launches on the card, so of it this asks only, over
    ``runs`` runs in one window, that it record at least one kernel, none
    but K4 and no more than were launched (as chip_smoke.py phase 4
    does)."""
    from torch.profiler import ProfilerActivity, profile

    g = make_graph(width=8, height=6, iterations=4)
    runner = get_backend("cuda-fused[comm=onesided,ranks=4]").prepare_many(
        replicate(g, ngraphs))
    runs = 4
    runner()
    n = taskbench_onesided.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            runner()
        torch.cuda.synchronize()
    assert taskbench_onesided.launches - n == ngraphs * runs
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert 1 <= len(kernels) <= ngraphs * runs, kernels
    assert all("onesided_kernel" in k for k in kernels), kernels


@pytest.mark.gpu
def test_k4_oversubscribed_ranks_raise(cuda):
    limit = _build.library().taskbench_onesided_blocks(cuda.index or 0)
    assert limit >= 132
    g = make_graph(width=limit + 1, height=2, iterations=1)
    with pytest.raises(RuntimeError, match="co-resident"):
        get_backend(f"cuda-fused[comm=onesided,ranks={limit + 1}]").run([g])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
def test_cuda_graph_is_bitwise_with_torch_scan_on_card(cuda, kind):
    """The captured graph computes what ``torch-scan`` launches eagerly,
    stacked and alone, on every replay."""
    graphs = [make_graph(width=8, height=6, pattern=p, kernel=kind,
                         iterations=5, imbalance=0.5, span_bytes=512,
                         scratch_bytes=2048)
              for p in ("stencil", "fft", "random")]
    captured, scan = get_backend("cuda-graph"), get_backend("torch-scan")
    for got, want in zip(captured.run_many(graphs), scan.run_many(graphs)):
        assert np.array_equal(got, want)
    runner = captured.prepare([graphs[0]])
    want = scan.run([graphs[0]])[0]
    for _ in range(3):
        # blocks freed since the capture, filled with other values, must
        # not be what the graph reads or writes
        junk = torch.full((1 << 20,), 7.0, device=cuda)
        assert np.array_equal(runner()[0], want)
        del junk


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["compute", "memory"])
@pytest.mark.parametrize("ngraphs", [1, 3])
def test_cuda_graph_run_is_one_graph_launch(cuda, kind, ngraphs):
    """The capture records one K1 (or K2) node a timestep; a run is one
    ``cudaGraphLaunch`` from the host and no kernel launch, and its device
    side holds no more K1 (K2) kernels than were captured.  That the
    profiled run's kernels ran is shown by its outputs: the graph's output
    buffers are overwritten before it, and it must give the oracle's
    values (the profiler can miss launches, even all of a window's, so
    neither its count nor the counters, which count at capture, can)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import execute_reference

    g = make_graph(width=8, height=6, kernel=kind, iterations=4,
                   span_bytes=512, scratch_bytes=2048)
    runner = get_backend("cuda-graph").prepare_many(replicate(g, ngraphs))
    name = {"compute": "taskbench_compute", "memory": "taskbench_memory"}
    assert runner.program.nodes == {
        n: g.height if k == kind else 0 for k, n in name.items()}
    runner()
    counted = taskbench_compute.launches + taskbench_memory.launches
    outs = runner.program.outputs
    for t in outs if isinstance(outs, (list, tuple)) else [outs]:
        t.fill_(-1)  # what a run that launched nothing would return
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = runner()
        torch.cuda.synchronize()
    assert taskbench_compute.launches + taskbench_memory.launches == counted
    want = execute_reference(g)
    assert len(got) == ngraphs and all(np.array_equal(a, want) for a in got)
    host = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]
    assert sum("cudaGraphLaunch" in n for n in host) == 1, host
    assert not [n for n in host if "LaunchKernel" in n]
    kernel = {"compute": "compute_kernel", "memory": "memory_kernel"}[kind]
    ours = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and kernel in e.name]
    assert len(ours) <= g.height, ours


HOSTS = ["torch-host", "torch-host[schedule=steal,workers=4]"]


def host_graphs(kind, ngraphs):
    return [make_graph(width=8, height=6, pattern=p, kernel=kind,
                       iterations=5, imbalance=0.5, span_bytes=512,
                       scratch_bytes=2048)
            for p in ("stencil", "fft", "random")[:ngraphs]]


@pytest.mark.gpu
@pytest.mark.parametrize("ngraphs", [1, 3])
@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
@pytest.mark.parametrize("spec", HOSTS)
def test_torch_host_is_bitwise_with_torch_scan_on_card(cuda, spec, kind,
                                                       ngraphs):
    """Per-task dispatch (K1 or K2 for a single column, the task's own
    iterations) computes what ``torch-scan``'s timestep launches do."""
    graphs = host_graphs(kind, ngraphs)
    scan = get_backend("torch-scan")
    for got, want in zip(get_backend(spec).run_many(graphs),
                         scan.run_many(graphs)):
        assert np.array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ngraphs", [1, 3])
@pytest.mark.parametrize("kind", ["compute", "memory"])
@pytest.mark.parametrize("spec", HOSTS)
def test_torch_host_launches_k1_or_k2_once_a_task(cuda, spec, kind,
                                                  ngraphs):
    graphs = host_graphs(kind, ngraphs)
    runner = get_backend(spec).prepare_many(graphs)
    counters = {"compute": taskbench_compute, "memory": taskbench_memory}
    before = {k: fn.launches for k, fn in counters.items()}
    runner()
    counted = {k: fn.launches - before[k] for k, fn in counters.items()}
    tasks = sum(g.num_tasks for g in graphs)
    assert counted == {k: tasks if k == kind else 0 for k in counters}


@pytest.mark.gpu
@pytest.mark.parametrize("ngraphs", [1, 3])
@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
@pytest.mark.parametrize("spec", HOSTS)
def test_torch_host_dispatch_never_syncs(cuda, spec, kind, ngraphs):
    """A run issues every task without one device-to-host sync: the copy
    to numpy after the issue is the only one."""
    graphs = host_graphs(kind, ngraphs)
    runner = get_backend(spec).prepare_many(graphs)
    want = runner()  # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        finals = runner.issue()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for got, w in zip(finals, want):
        assert np.array_equal(got.cpu().numpy(), w)


CSP_SPECS = ["torch-csp[ranks=2]", "torch-csp[ranks=4]",
             "torch-csp[comm_overlap=True,ranks=4]",
             "torch-csp[comm=a2a,ranks=4]", "torch-csp[comm=onesided,ranks=4]",
             "torch-csp[comm=onesided,comm_overlap=True,ranks=4]",
             "torch-pipeline[ranks=4]"]


def csp_graphs(kind, ngraphs, width=10):
    return [make_graph(width=width, height=6, pattern=p, kernel=kind,
                       iterations=5, imbalance=0.5, span_bytes=512,
                       scratch_bytes=2048)
            for p in ("stencil", "sweep", "fft")[:ngraphs]]


@pytest.mark.gpu
@pytest.mark.parametrize("ngraphs", [1, 3])
@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
@pytest.mark.parametrize("spec", CSP_SPECS)
def test_torch_csp_is_bitwise_with_torch_scan_on_card(cuda, spec, kind,
                                                      ngraphs):
    """Rank processes sharing the card (each rank's body K1 or K2 for its
    columns, rows staged through host buffers over gloo) compute what
    ``torch-scan`` does; ``run_many`` runs the combined program."""
    graphs = csp_graphs(kind, ngraphs)
    scan = get_backend("torch-scan")
    for got, want in zip(get_backend(spec).run_many(graphs),
                         scan.run_many(graphs)):
        assert np.array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [10, 3])
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("kind", ["compute", "memory"])
def test_torch_csp_launches_k1_or_k2_each_step_on_every_rank(cuda, kind,
                                                             ranks, width):
    """Each rank launches its kernel once a timestep a graph (width 3 over
    4 ranks: one column a rank, the dynamic loop), counted by the ranks'
    own wrapper counters."""
    from repro_torch.backends import csp

    key = "K1" if kind == "compute" else "K2"
    be = get_backend(f"torch-csp[ranks={ranks}]")
    for graphs in (csp_graphs(kind, 1, width), csp_graphs(kind, 3, width)):
        runner = be.prepare_many(graphs)
        pool = be.pool()
        pool.call(csp.reset_launch_counts)
        runner()
        h = graphs[0].height * len(graphs)
        want = {k: h if k == key else 0 for k in ("K1", "K2")}
        assert pool.call(csp.launch_counts) == [want] * ranks
        assert [s["launches"] for s in runner.stats[0]] == [want] * ranks


# chip_smoke.py phase 11's graphs at a small size: (make_graph kwargs,
# graphs, the winner torch-auto resolves them to, the kernel it launches)
AUTO_CASES = {
    "stencil": (dict(pattern="stencil", iterations=16), 1, "cuda-fused",
                "K3"),
    "nearest_x4": (dict(pattern="nearest", iterations=16, radix=5), 4,
                   "cuda-fused", "K3"),
    "memory": (dict(pattern="stencil", kernel="memory", iterations=4,
                    span_bytes=4096, scratch_bytes=1 << 16), 1,
               "cuda-fused", "K3"),
    "stencil_4096B": (dict(pattern="stencil", iterations=16,
                           output_bytes=4096), 1,
                      "torch-csp[comm=onesided]", "K1"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(AUTO_CASES))
def test_torch_auto_is_bitwise_with_its_winner_on_card(cuda, case):
    """``torch-auto`` only delegates: on the card its outputs are its
    winner's own and the oracle's, and the winner's kernel runs (K3 in
    ``cuda-fused``; K1 in the one ``torch-csp`` rank the card count gives
    it)."""
    from repro_torch.backends import csp
    from repro_torch.core import execute_reference

    kw, n, winner, kernel = AUTO_CASES[case]
    graphs = replicate(make_graph(width=12, height=6, **kw), n)
    auto = get_backend("torch-auto")
    assert auto.resolve_spec(graphs) == winner
    runner = auto.prepare_many(graphs)
    if kernel == "K3":
        before = taskbench_fused.launches
        got = runner()
        assert taskbench_fused.launches == before + 1
    else:
        be = auto.delegate(graphs)
        assert be.ndev == torch.cuda.device_count()
        be.pool().call(csp.reset_launch_counts)
        got = runner()
        assert be.pool().call(csp.launch_counts)[0]["K1"] == graphs[0].height
    want = get_backend(winner).run_many(graphs)
    for g, a, b in zip(graphs, got, want):
        assert np.array_equal(a, b)
        assert np.array_equal(a, execute_reference(g))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["stencil", "random", "spread"])
def test_k3_grid_stride_matches_plain(cuda, pattern):
    """More tasks than K3's grid has CTAs: each CTA runs several tasks a
    timestep, t outermost, the order the dependency waits rely on.  At
    width 200 the random pattern has more than 32 dependency slots, which
    warp_combine loads itself past its lanes' first ones."""
    blocks = _build.library().taskbench_fused_blocks(1 << 20, 0,
                                                     cuda.index or 0)
    g = make_graph(width=200, height=8, pattern=pattern, kernel="compute",
                   iterations=5, imbalance=0.5,
                   **({"radix": 5} if pattern == "spread" else {}))
    graphs = replicate(g, blocks // g.width + 1)
    assert len(graphs) * g.width > blocks
    tabs = tables_from_numpy(MegakernelBackend._tables(
        graphs, max(1, g.max_radix())), cuda)
    kw = dict(kernel=g.kernel, ngraphs=len(graphs), height=g.height,
              payload_elems=g.payload_elems)
    assert torch.equal(taskbench_fused(*tabs, **kw),
                       taskbench_fused_plain(*tabs, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", pattern_names())
def test_k3_k4_run_ahead_under_imbalance(cuda, pattern):
    """Task durations of 1 to 64 iterations (imbalance 1.0) over 64
    timesteps, so short tasks run many steps ahead of their neighbours
    wherever the pattern lets them; K3 and K4 stay bitwise with their plain
    versions."""
    g = make_graph(width=16, height=64, pattern=pattern, kernel="compute",
                   iterations=64, imbalance=1.0,
                   **({"radix": 3} if pattern in ("nearest", "spread")
                      else {}))
    kw = dict(kernel=g.kernel, height=g.height,
              payload_elems=g.payload_elems)
    for graphs in ([g], replicate(g, 3)):
        tabs = tables_from_numpy(MegakernelBackend._tables(
            graphs, max(1, g.max_radix())), cuda)
        assert torch.equal(
            taskbench_fused(*tabs, ngraphs=len(graphs), **kw),
            taskbench_fused_plain(*tabs, ngraphs=len(graphs), **kw))
    for ranks in (4, 16):
        tabs = onesided_tables(g, ranks, cuda)
        assert torch.equal(taskbench_onesided(*tabs, **kw),
                           taskbench_onesided_plain(*tabs, **kw)), ranks


# the benchmark's K3 cells (portbench/configs, portbench/traffic)
K3_CELLS = {
    "compute": dict(kernel="compute", iterations=64),
    "memory": dict(kernel="memory", iterations=32, span_bytes=65536,
                   scratch_bytes=2097152),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(K3_CELLS))
def test_traced_k3_is_bitwise_with_untraced_and_counts(cuda, cell):
    """K3's traced instance (recording on) returns the untraced wave bit
    for bit at the benchmark cells' shapes, on the untraced grid, with each
    CTA's counters: 0 < wait cycles <= task cycles, late tasks at most the
    CTA's tasks."""
    g = make_graph(width=132, height=1000, pattern="stencil",
                   **K3_CELLS[cell])
    tabs = tables_from_numpy(MegakernelBackend._tables(
        [g], max(1, g.max_radix())), cuda)
    kw = dict(kernel=g.kernel, ngraphs=1, height=g.height,
              payload_elems=g.payload_elems)
    want = taskbench_fused(*tabs, **kw)
    with trace.recording() as rec:
        got = taskbench_fused(*tabs, **kw)
    assert torch.equal(got, want)
    assert [s.name for s in rec.spans] == ["fused.check", "fused.alloc",
                                           "fused.launch"]
    c = {k.name: k.values for k in rec.counters}
    assert list(c) == list(K3_COUNTERS)
    blocks = fused_blocks(g.width, cuda.index or 0, cell == "memory")
    assert all(len(v) == blocks for v in c.values())
    wait, task, late = (c[k] for k in K3_COUNTERS)
    per_cta = g.height * -(-g.width // blocks)
    for w, t, n in zip(wait, task, late):
        assert 0 < w <= t and 0 <= n <= per_cta
    assert taskbench_fused(*tabs, **kw).equal(want)  # untraced again


@pytest.mark.gpu
@pytest.mark.parametrize("spec,inner", [("cuda-fused", "fused.launch"),
                                        ("cuda-graph", "graph.replay")])
def test_runner_spans_on_the_card(cuda, spec, inner):
    """A runner with recording on: its outputs as with it off; each run
    over launch, wait and copy, which cover nearly all of a run (the
    median: a stall of the host can land between two spans); the program's
    own span inside launch."""
    g = make_graph(width=132, height=100, iterations=16)
    runner = get_backend(spec).prepare_many([g])
    want = runner()
    with trace.recording() as rec:
        got = [runner() for _ in range(10)]
    for out in got:
        assert np.array_equal(out[0], want[0])
    runs = [k for k, s in enumerate(rec.spans) if s.name == "run"]
    assert len(runs) == 10
    covered = []
    for k in runs:
        kids = [s for s in rec.spans if s.parent == k]
        assert [s.name for s in kids] == ["launch", "wait", "copy"]
        r = rec.spans[k]
        covered.append(sum(s.end_ns - s.start_ns for s in kids)
                       / (r.end_ns - r.start_ns))
        launch = rec.spans.index(kids[0])
        assert inner in {s.name for s in rec.spans if s.parent == launch}
    assert sorted(covered)[len(covered) // 2] >= 0.9, covered


# B, S, H, P, G, N, chunk: tests/test_kernels.py's SSD cases, chunk 1 and 37,
# and the full-width Mamba-2 2.7B prefill at a shorter S
SSD_CASES = [(2, 128, 4, 16, 2, 8, 32), (1, 256, 8, 32, 1, 16, 64),
             (2, 64, 2, 64, 2, 32, 64), (1, 9, 2, 8, 1, 4, 1),
             (2, 74, 4, 16, 2, 8, 37), (1, 256, 80, 64, 1, 128, 128)]
# the full-width Mamba-2 2.7B prefill at the lengths serving gives K6: 37
# tokens (one chunk of 37: a single 64-row half, two 64-column boxes of N),
# 128 (one chunk), 384, 1024 and 1536
SSD_SERVE = [(1, S, 80, 64, 1, 128, min(S, 128))
             for S in (37, 128, 384, 1024, 1536)]
SSD_TOL = 1e-4  # float32 sums taken in another order than the plain version


def ssd_inputs(B, S, H, P, G, N, device, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g) * 0.5
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.5)
    Bm = torch.randn(B, S, G, N, generator=g) * 0.5
    Cm = torch.randn(B, S, G, N, generator=g) * 0.5
    return (x.to(device, dtype), dt.to(device), A.to(device),
            Bm.to(device, dtype), Cm.to(device, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_CASES)
def test_k6_on_card_matches_plain(cuda, case):
    *shape, chunk = case
    args = ssd_inputs(*shape, cuda)
    D = torch.randn(shape[2]).to(cuda)
    n = ssd_chunked.launches
    y, h = ssd_chunked(*args, D, chunk=chunk)
    assert ssd_chunked.launches == n + 1
    y_p, h_p = ssd_chunked_plain(*args, D, chunk=chunk)
    torch.testing.assert_close(y, y_p, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(h, h_p, rtol=SSD_TOL, atol=SSD_TOL)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2 ** -126)))
                      - 7)


def within_one_ulp(y: torch.Tensor, y_plain: torch.Tensor) -> bool:
    ref = y_plain.float()
    allowed = bf16_ulp(ref) + SSD_TOL * (1 + ref.abs())
    return bool(((y.float() - ref).abs() <= allowed).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_CASES + SSD_SERVE)
def test_k6_bf16_is_within_one_ulp_of_plain(cuda, case):
    """bf16 x, B and C (the tensor-core kernel): y within the float32
    tolerance plus one bf16 ulp for the rounding of the two float32 sums
    (near zero the float32 error of a sum of large terms exceeds a bf16 ulp
    of the small result), the state within the float32 tolerance.  With D,
    y is the kernel's y with D x added in float32 and rounded again outside
    the kernel, as in the reference; the rule holds before that second
    rounding (after it, one ulp of y can be several of a smaller y + D x)."""
    *shape, chunk = case
    args = ssd_inputs(*shape, cuda, dtype=torch.bfloat16)
    D = torch.randn(shape[2]).to(cuda)
    assert uses_tensor_cores(args[0], args[3])
    n = ssd_chunked.launches
    y, h = ssd_chunked(*args, chunk=chunk)
    y_d, h_d = ssd_chunked(*args, D, chunk=chunk)
    assert ssd_chunked.launches == n + 2
    y_p, h_p = ssd_chunked_plain(*args, chunk=chunk)
    assert y.dtype == torch.bfloat16 and bool(y.isfinite().all())
    assert within_one_ulp(y, y_p)
    torch.testing.assert_close(h, h_p, rtol=SSD_TOL, atol=SSD_TOL)
    assert torch.equal(y_d, _with_skip(y, args[0], D))
    assert torch.equal(h_d, h)


@pytest.mark.gpu
def test_k6_bf16_ragged_prompt_through_ops(cuda):
    args = ssd_inputs(1, 100, 4, 16, 2, 8, cuda, dtype=torch.bfloat16)
    y, h = ssd_ops.ssd(*args, chunk=32)
    y_p, h_p = ssd_ops.ssd(*args, chunk=32, impl="plain")
    assert y.shape == (1, 100, 4, 16) and within_one_ulp(y, y_p)
    torch.testing.assert_close(h, h_p, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 128, 2, 128, 1, 16, 64),
                                  (1, 128, 2, 32, 1, 256, 64)])
def test_k6_bf16_past_the_tensor_core_sizes_runs_simt(cuda, case):
    """P > 64 or N > 128 in bf16 takes the SIMT kernel, held to the same
    rule."""
    *shape, chunk = case
    args = ssd_inputs(*shape, cuda, dtype=torch.bfloat16)
    assert not uses_tensor_cores(args[0], args[3])
    y, h = ssd_chunked(*args, chunk=chunk)
    y_p, h_p = ssd_chunked_plain(*args, chunk=chunk)
    assert within_one_ulp(y, y_p)
    torch.testing.assert_close(h, h_p, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.gpu
def test_k6_bf16_rejects_misaligned_views_and_launches_nothing(cuda):
    """The tensor-core kernel copies 8 or 16 bytes at a time: x, B and C
    8-byte aligned."""
    x, dt, A, Bm, Cm = ssd_inputs(1, 64, 2, 16, 1, 8, cuda,
                                  dtype=torch.bfloat16)
    buf = torch.zeros(Bm.numel() + 4, dtype=torch.bfloat16, device=cuda)
    view = buf[1:1 + Bm.numel()].view(Bm.shape)
    assert view.is_contiguous() and view.data_ptr() % 8
    n = ssd_chunked.launches
    with pytest.raises(ValueError, match="8-byte aligned"):
        ssd_chunked(x, dt, A, view, Cm, chunk=64)
    assert ssd_chunked.launches == n
    ssd_chunked(x, dt, A, buf[4:4 + Bm.numel()].view(Bm.shape), Cm, chunk=64)
    assert ssd_chunked.launches == n + 1


@pytest.mark.gpu
def test_k6_ragged_prompt_through_ops(cuda):
    args = ssd_inputs(1, 100, 4, 16, 2, 8, cuda)
    y, h = ssd_ops.ssd(*args, chunk=32)
    y_p, h_p = ssd_ops.ssd(*args, chunk=32, impl="plain")
    torch.testing.assert_close(y, y_p, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(h, h_p, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.gpu
def test_k6_enforces_chunk_at_most_128(cuda):
    args = ssd_inputs(1, 256, 2, 8, 1, 4, cuda)
    n = ssd_chunked.launches
    with pytest.raises(ValueError, match="chunk must be in 1..128"):
        ssd_chunked(*args, chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunked(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                    *args[1:], chunk=64)
    odd = ssd_inputs(1, 64, 2, 6, 1, 4, cuda)
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_chunked(*odd, chunk=64)
    assert ssd_chunked.launches == n


@pytest.mark.gpu
def test_reduced_mamba_serves_on_card_through_k6(cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_model
    from repro_torch.serve import ServeEngine

    cfg = reduced(get_config("mamba2-2.7b"))
    params = init_model(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    reqs = [([1, 2, 3], 7), ([4, 5], 3), ([6], 5), (list(range(1, 38)), 5)]
    outs = {}
    for mode in ("chunked", "host"):
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=64,
                          chunk_size=4, decode_mode=mode)
        n = ssd_chunked.launches
        rids = [eng.submit(np.array(p), max_new_tokens=m) for p, m in reqs]
        out = eng.run()
        outs[mode] = [out[r] for r in rids]
        # a one-token prompt is a decode step from a zero state (as in the
        # reference), every longer prompt one K6 launch a layer
        longer = sum(len(p) > 1 for p, _ in reqs)
        assert ssd_chunked.launches - n == longer * cfg.num_layers
        assert eng.stats["prefills"] == len(reqs)
    assert outs["chunked"] == outs["host"]
    assert [len(o) for o in outs["chunked"]] == [m for _, m in reqs]


# B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset: tests/test_kernels.py's
# ATTN_CASES, ragged lengths, fully masked rows (a causal q_offset < 0),
# the full-width RecurrentGemma-2B prefill at S = 1000, then shapes the
# tensor-core kernel's 128 x 64 tiles can get wrong: ragged GQA at D=128, a
# chunked-prefill offset that is no tile multiple, non-causal MQA with Skv
# no multiple of 64
ATTN_CASES = [(2, 128, 128, 4, 2, 64, True, None, 0),
              (1, 128, 256, 8, 8, 32, True, 64, 128),
              (2, 64, 64, 4, 1, 64, False, None, 0),
              (1, 256, 256, 2, 2, 128, True, 128, 0),
              (2, 128, 128, 6, 3, 64, True, None, 0),
              (2, 37, 37, 4, 2, 32, True, 16, 0),
              (1, 100, 100, 6, 2, 64, False, None, 0),
              (1, 300, 300, 10, 1, 256, True, 128, 0),
              (1, 100, 100, 4, 2, 64, True, None, -60),
              (1, 1000, 1000, 10, 1, 256, True, 2048, 0),
              (2, 777, 777, 8, 2, 128, True, 256, 0),
              (1, 100, 357, 4, 4, 256, True, None, 257),
              (1, 130, 201, 10, 1, 256, False, None, 0),
              # D = 80 (HuBERT X-Large's heads): its encoder, causal,
              # ragged, GQA with a window and an offset
              (2, 256, 256, 16, 16, 80, False, None, 0),
              (1, 200, 200, 4, 4, 80, True, None, 0),
              (3, 77, 130, 4, 2, 80, True, 50, 53)]
ATTN_TOL = 2e-5  # the reference's float32 kernel-test tolerance


def attn_inputs(B, Sq, Skv, Hq, Hkv, D, device, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype)
            for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_k5_on_card_matches_plain(cuda, case, dtype):
    """float32: |o - o_plain| <= 2e-5 (1 + |o_plain|); bf16 output: one bf16
    ulp of o_plain more, for the rounding of two float32 values a float32
    rounding apart; a row no key is allowed for is exactly 0."""
    *shape, causal, window, q_offset = case
    q, k, v = attn_inputs(*shape, cuda, dtype)
    n = flash_attention.launches
    o = flash_attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, causal=causal, window=window,
                                q_offset=q_offset).float()
    allowed = ATTN_TOL * (1 + ref.abs())
    if dtype == torch.bfloat16:
        allowed = allowed + bf16_ulp(ref)
    assert o.dtype == dtype and bool(o.isfinite().all())
    assert bool(((o.float() - ref).abs() <= allowed).all())
    qpos = q_offset + np.arange(q.shape[1])
    hi = np.minimum(qpos + 1, k.shape[1]) if causal else np.full_like(
        qpos, k.shape[1])
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros_like(qpos))
    keyless = torch.from_numpy(hi <= lo).to(cuda)
    assert not o[:, keyless].any()


def random_attn_case(seed):
    """(B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset) from a seed: any
    head size K5 takes, GQA groups of 1-3, lengths 1-400 off the tile grid,
    a window or none, offsets that start before or after the keys; every
    third case is not causal."""
    r = np.random.RandomState(seed)
    Hkv, group = int(r.randint(1, 3)), int(r.randint(1, 4))
    window = None if r.rand() < 0.4 else int(r.randint(1, 200))
    return (int(r.randint(1, 4)), int(r.randint(1, 300)),
            int(r.randint(1, 400)), Hkv * group, Hkv,
            int(r.choice([32, 64, 128, 256])), seed % 3 != 0, window,
            int(r.randint(-100, 300)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(12))
def test_k5_on_card_matches_plain_at_random_shapes(cuda, seed, dtype):
    test_k5_on_card_matches_plain(cuda, random_attn_case(seed), dtype)


@pytest.mark.gpu
def test_k5_rejects_what_it_does_not_take(cuda):
    q, k, v = attn_inputs(1, 64, 64, 4, 2, 48, cuda, torch.float32)
    n = flash_attention.launches
    with pytest.raises(ValueError, match="head sizes"):
        flash_attention(q, k, v)
    q, k, v = attn_inputs(1, 64, 64, 4, 2, 64, cuda, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert flash_attention.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("D", [16, 40, 48, 96, 112, 160, 192, 512])
def test_k5_raises_at_head_sizes_it_is_not_built_for(cuda, D):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attn_inputs(1, 64, 64, 2, 2, D, cuda, dtype)
        n = flash_attention.launches
        with pytest.raises(ValueError, match="head sizes"):
            flash_attention(q, k, v)
        assert flash_attention.launches == n


@pytest.mark.gpu
def test_k5_bf16_rejects_misaligned_views_and_launches_nothing(cuda):
    """The tensor-core kernel loads by TMA: data 16-byte aligned."""
    q, k, v = attn_inputs(1, 64, 64, 4, 2, 64, cuda, torch.bfloat16)
    n = flash_attention.launches
    buf = torch.zeros(k.numel() + 8, dtype=torch.bfloat16, device=cuda)
    for off in (1, 4):  # 2 and 8 bytes in
        view = buf[off:off + k.numel()].view(k.shape)
        assert view.is_contiguous() and view.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention(q, view, v)
    assert flash_attention.launches == n
    flash_attention(q, buf[8:8 + k.numel()].view(k.shape), v)
    assert flash_attention.launches == n + 1


@pytest.mark.gpu
def test_reduced_gemma_serves_on_card_through_k5(cuda):
    """One K5 launch a local_attn layer for every prefill of more than one
    token (ring caches: max_len 96 > window 32), none in decode."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_model
    from repro_torch.serve import ServeEngine

    cfg = reduced(get_config("recurrentgemma-2b"))
    params = init_model(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    reqs = [([1, 2, 3], 7), ([4, 5], 3), ([6], 5), (list(range(1, 71)), 5)]
    outs = {}
    for mode in ("chunked", "host"):
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=96,
                          chunk_size=4, decode_mode=mode)
        n = flash_attention.launches
        rids = [eng.submit(np.array(p), max_new_tokens=m) for p, m in reqs]
        out = eng.run()
        outs[mode] = [out[r] for r in rids]
        longer = sum(len(p) > 1 for p, _ in reqs)
        local = cfg.pattern_for_depth().count("local_attn")
        assert flash_attention.launches - n == longer * local
    assert outs["chunked"] == outs["host"]
    assert [len(o) for o in outs["chunked"]] == [m for _, m in reqs]


# ------------------------------------------- the captured decode step
SERVE_REQS = [([1, 2, 3], 7), ([4, 5], 3), ([6], 5), (list(range(1, 38)), 5),
              ([9, 1, 9], 9)]
SERVE_MODELS = [("mamba2-2.7b", 64), ("recurrentgemma-2b", 96),
                ("qwen1.5-0.5b", 64), ("mixtral-8x7b", 96),
                ("arctic-480b", 64)]


def reduced_model(name, cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_model

    cfg = reduced(get_config(name))
    return cfg, init_model(cfg, torch.Generator(cuda).manual_seed(0), cuda)


def drain(cfg, params, mode, graphs, max_len, reqs=SERVE_REQS, eos=None,
          eng=None):
    from repro_torch.serve import ServeEngine

    eng = eng or ServeEngine(cfg, params, batch_slots=2, max_len=max_len,
                             chunk_size=4, decode_mode=mode, graphs=graphs)
    before = dict(eng.stats)
    rids = [eng.submit(np.array(p), max_new_tokens=m, eos_id=eos)
            for p, m in reqs]
    out = eng.run()
    return ([out[r] for r in rids],
            {k: v - before[k] for k, v in eng.stats.items()}, eng)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["chunked", "host"])
@pytest.mark.parametrize("name,max_len", SERVE_MODELS)
def test_captured_engine_gives_the_eager_engines_tokens_and_stats(
        cuda, name, max_len, mode):
    """The captured step replayed gives the eager step's tokens and all
    five ``stats``, over a stream that reuses both slots, with an eos
    stop, and for a request served after the stream on the same engine."""
    cfg, params = reduced_model(name, cuda)
    eager, eager_stats, _ = drain(cfg, params, mode, False, max_len)
    got, stats, eng = drain(cfg, params, mode, True, max_len)
    assert eng.program is not None
    assert eng.program.nodes == {"flash_attention": 0, "ssd_chunked": 0}
    assert got == eager and stats == eager_stats
    assert [len(t) for t in got] == [m for _, m in SERVE_REQS]
    seq = eager[0]
    k, eos = next((i, t) for i, t in enumerate(seq)
                  if 0 < i < len(seq) - 1 and t not in seq[:i])
    want, want_stats, _ = drain(cfg, params, mode, False, max_len, eos=eos)
    got, stats, _ = drain(cfg, params, mode, None, max_len, eos=eos, eng=eng)
    assert got[0] == seq[:k + 1] == want[0]
    assert got == want and stats == want_stats
    fresh, _, _ = drain(cfg, params, mode, False, max_len,
                        reqs=[SERVE_REQS[-1]])
    again, _, _ = drain(cfg, params, mode, None, max_len,
                        reqs=[SERVE_REQS[-1]], eng=eng)
    assert again == fresh


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["chunked", "host"])
@pytest.mark.parametrize("name,max_len", SERVE_MODELS)
def test_capture_leaves_the_pool_zeroed(cuda, name, max_len, mode):
    from repro_torch.models.cache import LayerCache
    from repro_torch.serve import ServeEngine

    cfg, params = reduced_model(name, cuda)
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=max_len,
                      decode_mode=mode)
    layers = [eng.caches] if isinstance(eng.caches, LayerCache) \
        else eng.caches
    for c in layers:
        for t in c.tensors() + [c.pos] * (c.pos is not None):
            assert not t.any()
    assert not eng.cur.any() and not eng._dev.any()
    p = eng.program
    assert p.capture_s > 0 and p.instantiate_s > 0 and p.pool_bytes >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["chunked", "host"])
def test_captured_decode_is_one_graph_launch_a_step(cuda, mode):
    """A tick with no admission or completion: ``steps`` (chunked) or one
    (host) ``cudaGraphLaunch`` from the host and no kernel launch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    cfg, params = reduced_model("mamba2-2.7b", cuda)
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64, chunk_size=4,
                      decode_mode=mode)
    for p in ([1, 2, 3], [4, 5, 6, 7]):
        eng.submit(np.array(p), max_new_tokens=20)
    eng.step()
    before = eng.stats["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        assert eng.step() == []
    steps = eng.stats["decode_steps"] - before
    assert steps == (4 if mode == "chunked" else 1)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert sum("cudaGraphLaunch" in n for n in names) == steps
    assert not any("LaunchKernel" in n for n in names), sorted(set(names))


@pytest.mark.gpu
def test_capture_beside_dead_engines_with_an_eager_collector(cuda):
    """A dead engine (a cycle with its captured step) holds a pinned buffer
    that served asynchronous copies on the default stream; freed during a
    later capture it would record an event there and invalidate it.  With
    the collector run at every allocation, captures after dead engines
    still succeed and serve the eager engine's tokens."""
    import gc

    cfg, params = reduced_model("recurrentgemma-2b", cuda)
    want, _, _ = drain(cfg, params, "chunked", False, 96)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        for mode in ("chunked", "host", "chunked"):
            got, _, _ = drain(cfg, params, mode, True, 96)
            assert got == want, mode
    finally:
        gc.set_threshold(*threshold)


CAPTURE_FAILS = """
import numpy as np, torch
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import init_model
from repro_torch.serve import ServeEngine, engine
cfg = reduced(get_config("qwen1.5-0.5b"))
params = init_model(cfg, 0, "cuda")
real = engine._greedy
engine._greedy = lambda logits: real(logits) + int(logits.sum() * 0)
try:
    ServeEngine(cfg, params, batch_slots=2, max_len=32)
except RuntimeError as e:  # torch.AcceleratorError among them
    print("raised", type(e).__name__)
else:
    print("captured")
"""


@pytest.mark.gpu
def test_a_capture_that_fails_raises(cuda, tmp_path):
    """A step that syncs with the host cannot be captured: the engine's
    construction raises, with no eager fallback (in a child process, since
    a failed capture may leave the context unusable)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.stdout.strip().splitlines()[-1].startswith("raised "), \
        proc.stdout + proc.stderr


# ------------------------------------------------------------ the MoE block
@pytest.mark.gpu
def test_moe_dense_on_card_matches_the_cpu_path(cuda, monkeypatch):
    """bf16 experts: the card's ``bmm`` with a float32 output against the
    CPU's one-expert-at-a-time upcast.  The float32 sum before the cast to
    bf16 within 1e-4 of its scale (float32 sums in another order, and a
    product near a bf16 rounding boundary of ``h``), and the card's path
    with any one product rounded to bf16 outside ten times that; the
    routing identical."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe

    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              dtype="bfloat16")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    pc = {k: v.to(cuda) for k, v in p.items()}
    y_cpu, m_cpu = moe.apply_moe(p, x, cfg)
    y, m = moe.apply_moe(pc, x.to(cuda), cfg)
    assert y.dtype == torch.bfloat16 and y.is_cuda
    assert abs(float(m["moe_lb_loss"]) - float(m_cpu["moe_lb_loss"])) < 1e-5
    x2 = x.reshape(-1, cfg.d_model)
    want, _, _ = moe._dense_mix(p, x2, cfg)
    got, _, _ = moe._dense_mix(pc, x2.to(cuda), cfg)
    assert torch.equal(got.to(torch.bfloat16).reshape(y.shape), y)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    exact = moe._bmm_f32
    for which in range(3):
        calls = []

        def rounding(a, b):
            out = exact(a, b)
            calls.append(None)
            return (out.to(torch.bfloat16).float()
                    if len(calls) - 1 == which else out)
        monkeypatch.setattr(moe, "_bmm_f32", rounding)
        bad, _, _ = moe._dense_mix(pc, x2.to(cuda), cfg)
        assert float((bad.cpu() - want).abs().max()) > 1e-3 * scale, which


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["replicated", "sp"])
def test_moe_a2a_on_card_ranks_matches_dense(cuda, mode):
    """The a2a path on 4 rank processes sharing the card, (2, 2) grid,
    float32 at capacity factor 8: within the reference's 5e-4 max(scale,
    1) of the dense path, each rank's all-to-all bytes the analytic
    count."""
    import dataclasses

    from repro_torch.bench.moe import MoEDispatchSpec, analytic_a2a_bytes
    from repro_torch.configs import get_config, reduced
    from repro_torch.dist.ranks import get_pool
    from repro_torch.models import moe

    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              moe_capacity_factor=8.0)
    grid = moe.ExpertGrid(get_pool(4, cuda), 2, 2, cfg=cfg, seed=5)
    p = moe.init_moe(torch.Generator(cuda).manual_seed(5), cfg,
                     torch.float32, cuda)
    x = torch.randn(8, 32, cfg.d_model, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    y_d, _ = moe.apply_moe(p, x, cfg, impl="dense")
    y, _ = moe.apply_moe(p, x, cfg, ep_mode=mode, grid=grid)
    assert y.is_cuda
    tol = 5e-4 * max(float(y_d.abs().max()), 1.0)
    assert float((y - y_d).abs().max()) < tol
    want = analytic_a2a_bytes(MoEDispatchSpec(batch=8, seq=32, data=2,
                                              model=2, ep_mode=mode))
    assert [s["data"]["a2a_bytes"] for s in grid.stats] == \
        [want["a2a_bytes"]] * 4


# ----------------------------------------------------------- training
GRAD_RTOL = 1e-5  # of each input's largest plain gradient: both backward
# passes run the same plain graph (the kernel path recomputes it)


def grads_through(fn, inputs, seed=1):
    ins = [t.detach().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(ins[0].device).manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen,
                                        device=o.device)).sum() for o in outs)
    return torch.autograd.grad(loss, ins)


def assert_same_grads(got, want):
    for g, w in zip(got, want):
        top = w.float().abs().max().item()
        assert top > 0 and bool(g.isfinite().all())
        assert (g.float() - w.float()).abs().max().item() <= GRAD_RTOL * top


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 128, 128, 4, 2, 64, True, None, 0),
                                  (2, 100, 100, 4, 4, 80, False, None, 0),
                                  (1, 77, 130, 4, 2, 80, True, 50, 53)])
def test_k5_gradients_on_card_match_the_plain_path(cuda, case, dtype):
    """Through K5 on the card the gradients of q, k and v are the plain
    path's and not zero: the wrapper does not cut the graph."""
    *shape, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    inputs = attn_inputs(*shape, cuda, dtype)
    n = flash_attention.launches
    got = grads_through(lambda q, k, v: flash_attention(q, k, v, **kw),
                        inputs)
    assert flash_attention.launches == n + 1
    want = grads_through(lambda q, k, v: flash_attention_plain(q, k, v, **kw),
                         inputs)
    assert_same_grads(got, want)
    # no gradient needed: the direct launch, as serving makes it
    out = flash_attention(*inputs, **kw)
    assert out.grad_fn is None and flash_attention.launches == n + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 128, 4, 16, 2, 8, 32),
                                  (1, 256, 8, 64, 1, 128, 128)])
def test_k6_gradients_on_card_match_the_plain_path(cuda, case, dtype):
    """Through K6 on the card (both kernels) the gradients of x, dt, A, B,
    C and D are the plain path's and not zero."""
    *shape, chunk = case
    inputs = list(ssd_inputs(*shape, cuda, dtype=dtype))
    inputs.append(torch.linspace(0.5, 1.5, shape[2], device=cuda))  # D
    n = ssd_chunked.launches
    got = grads_through(lambda *a: ssd_chunked(*a, chunk=chunk), inputs)
    assert ssd_chunked.launches == n + 1
    want = grads_through(lambda *a: ssd_chunked_plain(*a, chunk=chunk),
                         inputs)
    assert_same_grads(got, want)


def tiny_train(name, cuda, **changes):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(reduced(get_config(name)), dtype="bfloat16",
                              **changes)
    tcfg = TS.TrainConfig(warmup_steps=0, total_steps=10)
    return cfg, tcfg, TS.init_state(cfg, tcfg, 0, cuda)


@pytest.mark.gpu
def test_reduced_hubert_trains_on_card_through_k5(cuda):
    """A reduced HuBERT at head size 80 in bf16 (remat "full") trains on
    the card: K5 twice a layer a step (the forward and the recompute), no
    other kernel of K1-K6, finite losses, and the first step equal to the
    same step on K5's plain version within the chip phase's tolerances."""
    import dataclasses

    from repro_torch.data import DataConfig, make_batch
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import train_step as TS

    cfg, tcfg, state = tiny_train("hubert-xlarge", cuda, head_dim=80)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=4,
                      embed_dim=cfg.d_model)
    b0 = TS.to_device(make_batch(dcfg, 0), cuda)
    g, m = TS.compute_grads(state.params, b0, dataclasses.replace(
        cfg, kernel_impl="plain"), tcfg)
    plain = (float(m["loss"]), float(global_norm(g)))
    step = TS.make_train_step(cfg, tcfg)
    for i in range(3):
        n5, n6 = flash_attention.launches, ssd_chunked.launches
        state, m = step(state, make_batch(dcfg, i))
        assert flash_attention.launches - n5 == 2 * cfg.num_layers
        assert ssd_chunked.launches == n6
        assert np.isfinite(float(m["loss"]))
        if i == 0:
            assert abs(float(m["loss"]) - plain[0]) <= 1e-2 * plain[0]
            assert abs(float(m["grad_norm"]) - plain[1]) <= 0.1 * plain[1]
    assert int(state.step) == 3


@pytest.mark.gpu
def test_reduced_mamba2_train_step_on_card_through_k6(cuda):
    """K6 under autograd in a model: twice a layer a step, every SSD
    parameter gets a gradient, and the loss is the plain path's."""
    import dataclasses

    from repro_torch.data import DataConfig, make_batch
    from repro_torch.train import train_step as TS

    cfg, tcfg, state = tiny_train("mamba2-2.7b", cuda)
    batch = TS.to_device(make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=2), 0), cuda)
    n = ssd_chunked.launches
    grads, m = TS.compute_grads(state.params, batch, cfg, tcfg)
    assert ssd_chunked.launches - n == 2 * cfg.num_layers
    from repro_torch import tree as T

    for k, v in T.flatten(grads["blocks_scanned"]["ssd"]):
        assert v.float().abs().sum() > 0, k
    _, pm = TS.compute_grads(state.params, batch, dataclasses.replace(
        cfg, kernel_impl="plain"), tcfg)
    assert abs(float(m["loss"]) - float(pm["loss"])) <= 1e-2 * float(
        pm["loss"])


@pytest.mark.gpu
def test_trainer_resumes_bit_exact_on_card(cuda, tmp_path):
    """A run failed at step 3 and restarted reproduces the uninterrupted
    run's losses bit for bit on the card."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import LoopConfig, Trainer

    cfg = reduced(get_config("hubert-xlarge"))

    def trainer(d):
        return Trainer(cfg, TS.TrainConfig(warmup_steps=1, total_steps=10),
                       DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=4, embed_dim=cfg.d_model),
                       LoopConfig(num_steps=6, ckpt_dir=str(d), ckpt_every=2,
                                  log_every=0), device=cuda)

    ref = trainer(tmp_path / "a")
    ref.run(0)
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer(tmp_path / "b").run(0, fail_at=3)
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = trainer(tmp_path / "b")
    resumed.run(0)
    want = {m["step"]: m["loss"] for m in ref.metrics_log}
    assert [m["step"] for m in resumed.metrics_log] == [2, 3, 4, 5]
    assert all(m["loss"] == want[m["step"]] for m in resumed.metrics_log)


@pytest.mark.gpu
def test_bf16_expert_products_differentiate_on_card(cuda):
    """The MoE dense path's bf16 expert products (``torch.bmm(...,
    out_dtype=float32)`` on the card, which has no derivative) take the
    float32-cotangent gradient on the card: equal to the CPU path's within
    one bf16 ulp, and a reduced bf16 Mixtral trains a step."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import moe
    from repro_torch.train import train_step as TS

    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4, 33, 64, generator=gen).bfloat16()
    b = torch.randn(4, 64, 48, generator=gen).bfloat16()
    g = torch.randn(4, 33, 48, generator=gen)
    grads = {}
    for dev in ("cpu", cuda):
        x, w = (t.to(dev).requires_grad_(True) for t in (a, b))
        y = moe._bmm_f32(x, w)
        assert y.dtype == torch.float32
        grads[str(dev)] = [t.cpu().float() for t in
                           torch.autograd.grad(y, (x, w), g.to(dev))]
    for got, want in zip(grads[str(cuda)], grads["cpu"]):
        assert bool(((got - want).abs() <= bf16_ulp(want) + 1e-6).all())
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                              dtype="bfloat16")
    tcfg = TS.TrainConfig(warmup_steps=0, total_steps=10)
    state = TS.init_state(cfg, tcfg, 0, cuda)
    state, m = TS.make_train_step(cfg, tcfg)(state, make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=2), 0))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


# --------------------------------------- data-parallel and pipelined training
def _rank_compressed(ctx, v):
    from repro_torch.dist.compression import compressed_psum

    return compressed_psum(torch.from_numpy(v).to(ctx.device), ctx.comm,
                           tag=7).cpu().numpy()


@pytest.mark.gpu
def test_compressed_psum_on_card_ranks_matches_the_cpu_ranks(cuda):
    """``compressed_psum`` on 2 rank processes sharing the card gives the
    bits it gives on 2 CPU ranks (a float32 max, IEEE division, round half
    to even, an exact int32 sum)."""
    from repro_torch.dist.ranks import get_pool

    rs = np.random.RandomState(0)
    vs = [(rs.randn(1000, 33) * (r + 1)).astype(np.float32) for r in range(2)]
    got = get_pool(2, cuda).map(_rank_compressed, [(v,) for v in vs])
    want = get_pool(2, torch.device("cpu")).map(_rank_compressed,
                                                [(v,) for v in vs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("compress", [False, True])
def test_reduced_dp_step_on_card_matches_the_single_device_step(cuda,
                                                                compress):
    """A reduced float32 qwen1.5-0.5b, 2 rank processes on the card against
    the card's single-device step from the same seed: the replicas start
    with the controller's bits and stay equal, K5 runs twice a layer a rank
    step (forward and remat), and the losses are within the reference's
    tolerances (``tests/test_distributed.py``: 1e-4 with ``psum``, 2e-2
    with compression), the parameters within its 1e-5 with ``psum``.  The
    compressed run is a function of the ranks' split, so it is held to the
    same run on 2 CPU ranks from the same state (which
    ``tests/test_torch_dist_step.py`` holds to the reference): the update
    within 5e-3 relative L2, the grad norms within 1e-4 (the CPU tests'
    bounds)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.dist.ranks import get_pool
    from repro_torch.train import dist_step as DS
    from repro_torch.train import train_step as TS

    cfg = reduced(get_config("qwen1.5-0.5b"))
    tcfg = TS.TrainConfig(base_lr=1e-3, warmup_steps=2, total_steps=40)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4)
    state = TS.init_state(cfg, tcfg, torch.Generator(cuda).manual_seed(0),
                          cuda)
    start = [t.detach().cpu().clone() for t in T.leaves(state.params)]
    dp = DS.DataParallel(get_pool(2, cuda), cfg, tcfg, compress=compress,
                         seed=0)
    assert dp.fingerprint() == T.fingerprint(state.params)
    if compress:
        on_cpu = DS.DataParallel(get_pool(2, torch.device("cpu")), cfg,
                                 tcfg, compress=True).load(state)
    step = TS.make_train_step(cfg, tcfg)
    gnorms = {"card": [], "cpu": []}
    for s in range(3):
        batch = make_batch(dcfg, s)
        state, m = step(state, batch)
        got = dp.run_step(batch)
        assert abs(got["loss"] - float(m["loss"])) <= (
            2e-2 if compress else 1e-4)
        assert [st["K5"] for st in dp.stats] == [2 * cfg.num_layers] * 2
        dp.fingerprint()
        if compress:
            gnorms["card"].append(got["grad_norm"])
            gnorms["cpu"].append(on_cpu.run_step(batch)["grad_norm"])
    mine = T.leaves(dp.state().params)
    if not compress:
        for a, b in zip(mine, T.leaves(state.params)):
            assert float((a.float() - b.float().cpu()).abs().max()) <= 1e-5
        return
    want = T.leaves(on_cpu.state().params)
    num = sum(float((a - b).double().square().sum())
              for a, b in zip(mine, want))
    den = sum(float((b - s0).double().square().sum())
              for b, s0 in zip(want, start))
    assert (num / den) ** 0.5 <= 5e-3
    np.testing.assert_allclose(gnorms["card"], gnorms["cpu"], rtol=1e-4)


@pytest.mark.gpu
def test_pp_loss_gradients_on_card_through_k5_match_the_plain_path(cuda):
    """``pp_loss_fn`` of a reduced float32 yi-6b at 4 layers, 2 stages x 4
    microbatches, on the card: K5 once a layer a microbatch (its autograd
    function), every stage's blocks get a gradient, and every gradient is
    the plain path's within 1e-3 of its leaf's largest (K5's forward is
    its plain version's within 2e-5 (1 + |o|) a layer, and the backward
    is the plain graph on those outputs)."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import get_config, reduced
    from repro_torch.dist import pipeline as PP
    from repro_torch.models import model as M

    cfg = dataclasses.replace(reduced(get_config("yi-6b")), num_layers=4)
    params = PP.stack_params_by_stage(M.init_model(cfg, 0, cuda), 2)
    toks = torch.randint(0, cfg.vocab_size, (8, 32), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    batch = {"tokens": toks, "labels": toks}

    def grads(c):
        pp = T.tree_map(lambda t: t.detach().requires_grad_(True), params)
        total, _ = PP.pp_loss_fn(pp, c, batch, 2, 4)
        return dict(zip((k for k, _ in T.flatten(pp)),
                        torch.autograd.grad(total, T.leaves(pp))))

    n = flash_attention.launches
    got = grads(cfg)
    assert flash_attention.launches - n == cfg.num_layers * 4
    want = grads(dataclasses.replace(cfg, kernel_impl="plain"))
    for key, w in want.items():
        top = float(w.abs().max())
        assert top > 0 and bool(got[key].isfinite().all()), key
        assert float((got[key] - w).abs().max()) <= 1e-3 * top, key
        if key.startswith("['blocks_scanned']"):
            assert all(float(got[key][s].abs().sum()) > 0 for s in range(2))


# ------------------------------------------- Granite 4.0-H Small, small cut
def granite_model(cuda):
    """Granite at ``reduced()``'s cut (one period of the pattern, 2 of 8
    experts held, top-3) in bfloat16, the benchmark cell's precision."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import init_model

    cfg = dataclasses.replace(reduced(get_config("granite-4.0-h-small")),
                              dtype="bfloat16")
    return cfg, init_model(cfg, torch.Generator(cuda).manual_seed(0), cuda)


def granite_chunks(cfg, params, graphs, chunks=3):
    """Three requests decoded chunk by chunk; every chunk's tokens, logits
    and held pairs."""
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=3, max_len=96, chunk_size=4,
                      graphs=graphs, keep_logits=True)
    for n in (5, 17, 40):
        eng.submit(np.arange(n) % 200 + 1, max_new_tokens=40)
    out = []
    for _ in range(chunks):
        eng.step()
        out.append(([list(r.out) for r in eng.slot_requests],
                    eng.logits.clone(), eng.held_pairs))
    return out, eng


@pytest.mark.gpu
def test_granite_captured_engine_gives_the_eager_engines_tokens_and_logits(
        cuda):
    cfg, params = granite_model(cuda)
    eager, _ = granite_chunks(cfg, params, False)
    got, eng = granite_chunks(cfg, params, True)
    assert eng.program is not None
    for (t0, l0, h0), (t1, l1, h1) in zip(eager, got):
        assert t1 == t0 and h1 == h0 > 0
        assert torch.equal(l1, l0)


@pytest.mark.gpu
def test_granite_held_expert_layer_is_capture_safe(cuda):
    """The held-expert layer captured alone, with a host sync made an
    error, replays on new rows in its fixed buffers as it runs eagerly,
    and counts its pairs in the replay."""
    from repro_torch.models import moe

    cfg, params = granite_model(cuda)
    p = params["blocks"][0]["moe"]
    x = torch.zeros(6, 1, cfg.d_model, dtype=torch.bfloat16, device=cuda)
    counter = torch.zeros(1, dtype=torch.int64, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream):
            moe.apply_moe(p, x, cfg)
            with torch.cuda.graph(graph, stream=stream):
                y = moe.apply_moe(p, x, cfg, held_pairs=counter)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    g = torch.Generator(cuda).manual_seed(2)
    for _ in range(2):
        new = torch.randn(x.shape, generator=g, device=cuda).to(x.dtype)
        x.copy_(new)
        counter.zero_()
        graph.replay()
        want = moe.apply_moe(p, new, cfg)[0]
        assert y.shape == want.shape and torch.equal(y, want)
        _, idx, _ = moe._router(new.reshape(-1, cfg.d_model), p["router"],
                                cfg.num_experts, cfg.num_experts_per_tok)
        lo, hi = cfg.experts_held
        assert int(counter) == int(((idx >= lo) & (idx < hi)).sum())


@pytest.mark.gpu
def test_granite_held_pairs_equal_the_pairs_routed_on_the_host(cuda,
                                                               monkeypatch):
    """The engine's ``held_pairs`` of each chunk (counted on the device in
    the captured step) equal the pairs an eager engine's router sends to
    the held experts, counted on the host from its indices."""
    from repro_torch.models import moe

    cfg, params = granite_model(cuda)
    got, _ = granite_chunks(cfg, params, True)
    routed, router = [], moe._router

    def spy(x2d, wr, E, k):
        out = router(x2d, wr, E, k)
        routed.append(out[1].cpu().numpy())
        return out

    monkeypatch.setattr(moe, "_router", spy)
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, batch_slots=3, max_len=96, chunk_size=4,
                      graphs=False)
    for n in (5, 17, 40):
        eng.submit(np.arange(n) % 200 + 1, max_new_tokens=40)
    lo, hi = cfg.experts_held
    for _, _, held in got:
        routed.clear()
        eng.step()
        decode = [r for r in routed if r.shape[0] == 3]  # not the prefills
        assert len(decode) == 4 * cfg.num_layers
        assert held == sum(int(((r >= lo) & (r < hi)).sum())
                           for r in decode)
