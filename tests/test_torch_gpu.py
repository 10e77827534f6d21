"""The CUDA kernels K1-K4 on the card, against their plain versions.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without
one.  The file imports neither JAX nor the reference package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    MegakernelBackend, onesided_tables_from_numpy, tables_from_numpy,
    taskbench_fused, taskbench_fused_plain, taskbench_onesided,
    taskbench_onesided_plain)
from repro_torch.core import make_graph, replicate  # noqa: E402
from repro_torch.dist import plan_comm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import (taskbench_compute,  # noqa: E402
                                 taskbench_compute_plain, taskbench_memory,
                                 taskbench_memory_plain)

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
    g = make_graph(width=8, height=6, iterations=4)
    runner = get_backend("cuda-fused[comm=onesided,ranks=4]").prepare_many(
        replicate(g, ngraphs))
    kernels = profiled_kernels(runner)
    assert len(kernels) == ngraphs, kernels


@pytest.mark.gpu
def test_k4_oversubscribed_ranks_raise(cuda):
    limit = _build.library().taskbench_onesided_blocks(cuda.index or 0)
    assert limit >= 132
    g = make_graph(width=limit + 1, height=2, iterations=1)
    with pytest.raises(RuntimeError, match="co-resident"):
        get_backend(f"cuda-fused[comm=onesided,ranks={limit + 1}]").run([g])
