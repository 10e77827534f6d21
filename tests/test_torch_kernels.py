"""The port's task kernels K1-K3: plain versions, wrappers, tables, build.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves run only on a card (``test_torch_gpu.py``).

Numerics: the plain versions round after every multiply and every add, as
the numpy oracle (``core.kernel_ref``) does, and are held to it bitwise at
every iteration count.  XLA on the CPU contracts ``a*b + c`` into one fused
multiply-add, so the reference package's own kernels differ from that
oracle by an ulp at some counts (its ``tests/test_kernels.py`` compares them
at rtol 1e-6).  Against the reference the port is therefore held at that
same tolerance on arbitrary inputs, and bitwise at the counts where the
contraction cannot show: the compute orbit from 0.5 after 15 or more steps,
and up to 6 memory steps from 1.0.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backends import get_backend as ref_backend  # noqa: E402
from repro.backends.megakernel import MegakernelBackend as RefMega  # noqa: E402
from repro.kernels import bodies as ref_bodies  # noqa: E402
from repro.kernels import ops  # noqa: E402
import repro.core as rc  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    MegakernelBackend, _wide, scratch_elems, tables_from_numpy,
    taskbench_fused, taskbench_fused_plain)
from repro_torch.core import make_graph, replicate  # noqa: E402
from repro_torch.core.kernel_ref import (COMPUTE_C, MEM_BIAS,  # noqa: E402
                                         MEM_SCALE, run_kernel_ref)
from repro_torch.kernels import (_build, bodies, taskbench_compute,  # noqa: E402
                                 taskbench_compute_plain, taskbench_memory,
                                 taskbench_memory_plain)
from repro_torch.kernels.memory import wide_path  # noqa: E402

COMPUTE_CASES = [(8, 12), (16, 40), (32, 7)]      # tests/test_kernels.py
MEMORY_CASES = [(1024, 128, 7), (2048, 256, 0), (512, 512, 9)]
PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}


def np_compute(tiles, iters, max_iters):
    """The oracle's rounding, step by step in numpy float32."""
    out = tiles.copy()
    for w in range(out.shape[0]):
        for _ in range(min(max(int(iters[w]), 0), max_iters)):
            out[w] = (out[w] * out[w]).astype(np.float32) - COMPUTE_C
    return out


def np_memory(x, iterations, span):
    """The oracle's sequential window walk (step k touches window k % nwin)."""
    x = x.copy()
    nwin = x.shape[0] // span
    for k in range(iterations):
        w = (k % nwin) * span
        x[w:w + span] = (x[w:w + span] * MEM_SCALE).astype(np.float32) \
            + MEM_BIAS
    return x


def compute_inputs(width, max_iters):
    tiles = np.full((width, 8, 128), 0.5, np.float32)
    iters = np.random.RandomState(width).randint(
        1, max_iters + 1, width).astype(np.int32)
    return tiles, iters


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("width,max_iters", COMPUTE_CASES)
def test_compute_plain_matches_oracle_and_reference(width, max_iters):
    tiles, iters = compute_inputs(width, max_iters)
    got = taskbench_compute(torch.from_numpy(tiles), torch.from_numpy(iters),
                            max_iters).numpy()
    np.testing.assert_array_equal(got, np_compute(tiles, iters, max_iters))
    ref = np.asarray(ops.taskbench_compute(
        jnp.asarray(tiles), jnp.asarray(iters), max_iters, impl="interpret"))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_compute_plain_is_bitwise_with_reference_past_contraction():
    tiles = np.full((32, 8, 128), 0.5, np.float32)
    iters = np.clip(np.arange(9, 41), 15, 40).astype(np.int32)
    got = taskbench_compute_plain(torch.from_numpy(tiles),
                                  torch.from_numpy(iters), 40).numpy()
    ref = np.asarray(ops.taskbench_compute(
        jnp.asarray(tiles), jnp.asarray(iters), 40, impl="interpret"))
    np.testing.assert_array_equal(got, ref)


def test_compute_plain_arbitrary_tiles_and_clamped_counts():
    rng = np.random.RandomState(0)
    tiles = rng.uniform(-1, 0.5, (5, 8, 128)).astype(np.float32)
    iters = np.array([-3, 0, 4, 9, 50], np.int32)
    got = taskbench_compute_plain(torch.from_numpy(tiles),
                                  torch.from_numpy(iters), 9).numpy()
    np.testing.assert_array_equal(got, np_compute(tiles, iters, 9))


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("size,span,iterations", MEMORY_CASES)
def test_memory_plain_matches_oracle_and_reference(size, span, iterations):
    x = np.array(jnp.arange(size, dtype=jnp.float32) / size)
    got = taskbench_memory(torch.from_numpy(x), iterations, span).numpy()
    np.testing.assert_array_equal(got, np_memory(x, iterations, span))
    ref = np.asarray(ops.taskbench_memory(jnp.asarray(x), iterations, span,
                                          impl="interpret"))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("iterations", [1, 5, 6])
def test_memory_plain_is_bitwise_with_reference_from_one(iterations):
    x = np.ones(512, np.float32)
    got = taskbench_memory_plain(torch.from_numpy(x), iterations, 512)
    ref = ops.taskbench_memory(jnp.asarray(x), iterations, 512,
                               impl="interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_memory_rows_form_equals_its_rows():
    rng = np.random.RandomState(1)
    x = rng.uniform(0, 1, (5, 512)).astype(np.float32)
    its = np.array([0, 3, 4, 9, 17], np.int32)
    got = taskbench_memory(torch.from_numpy(x), torch.from_numpy(its),
                           128).numpy()
    for c in range(5):
        row = taskbench_memory(torch.from_numpy(x[c]), int(its[c]),
                               128).numpy()
        np.testing.assert_array_equal(got[c], row)
        np.testing.assert_array_equal(got[c], np_memory(x[c], its[c], 128))


def test_memory_is_out_of_place():
    x = torch.ones(256)
    out = taskbench_memory(x, 0, 64)
    out += 1.0
    assert (x == 1.0).all()


# ------------------------------------------------------------- wrappers
def test_cpu_wrappers_run_plain_and_count_no_launch():
    before = (taskbench_compute.launches, taskbench_memory.launches,
              taskbench_fused.launches)
    taskbench_compute(torch.zeros(2, 8, 128), torch.ones(2, dtype=torch.int32),
                      3)
    taskbench_memory(torch.zeros(256), 2, 64)
    g = make_graph(width=4, height=3, iterations=2)
    tabs = tables_from_numpy(MegakernelBackend._tables([g], 3), "cpu")
    taskbench_fused(*tabs, kernel=g.kernel, ngraphs=1, height=3,
                    payload_elems=g.payload_elems)
    assert (taskbench_compute.launches, taskbench_memory.launches,
            taskbench_fused.launches) == before


# the benchmark's memory cells (portbench/configs/stencil-memory.json):
# 64 KiB windows of 2 MiB rows
BENCH_SPAN, BENCH_SIZE = 16384, 524288


@pytest.mark.parametrize("span,x_off,out_off,wide", [
    pytest.param(BENCH_SPAN, 0, 0, True, id="benchmark"),
    pytest.param(BENCH_SPAN, 4, 0, False, id="x-4-bytes-off"),
    pytest.param(BENCH_SPAN, 0, 4, False, id="out-4-bytes-off"),
    pytest.param(BENCH_SPAN, 8, 8, False, id="8-bytes-off"),
    pytest.param(BENCH_SPAN, 16, 48, True, id="16-bytes-off"),
    pytest.param(BENCH_SPAN + 2, 0, 0, False, id="span-mod-4-is-2"),
    pytest.param(BENCH_SPAN + 1, 0, 0, False, id="span-odd"),
    pytest.param(1, 0, 0, False, id="span-1"),
    pytest.param(4, 0, 0, True, id="span-4"),
    pytest.param(BENCH_SIZE, 0, 0, True, id="one-window-a-row"),
])
def test_wide_path_needs_every_window_on_16_bytes(span, x_off, out_off,
                                                  wide):
    base = 1 << 32
    assert wide_path(span, base + x_off, base + (1 << 24) + out_off) is wide


@pytest.mark.parametrize("kind,span_bytes,offset,wide", [
    pytest.param("memory", 4 * BENCH_SPAN, 0, True, id="benchmark"),
    pytest.param("memory", 4 * BENCH_SPAN, 1, False, id="row-4-bytes-off"),
    pytest.param("memory", 4 * BENCH_SPAN + 4, 0, False, id="span-odd"),
    pytest.param("memory", 4, 0, False, id="span-1"),
    pytest.param("compute", 4 * BENCH_SPAN, 0, False, id="compute"),
])
def test_k3_k4_take_the_wide_memory_body_from_their_scratch(kind, span_bytes,
                                                           offset, wide):
    """``_wide``, K3's and K4's choice, on a scratch of two task rows laid
    out as their wrappers lay it (rows ``scratch_elems`` apart), here on
    the CPU's allocator, which aligns to at least 16 bytes."""
    spec = rc.KernelSpec(kind=kind, span_bytes=span_bytes,
                         scratch_bytes=4 * BENCH_SIZE)
    span, size, _ = bodies.memory_geometry(spec)
    assert size % span == 0
    buf = torch.empty(2 * size + 4)
    assert buf.data_ptr() % 16 == 0
    scratch = buf[offset:offset + 2 * size].view(2, size)
    assert _wide(spec, span, scratch) is wide


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(2, 8, 64), torch.ones(2, dtype=torch.int32), 3),
     "float32 \\(W, 8, 128\\)"),
    ((torch.zeros(2, 8, 128, dtype=torch.float64),
      torch.ones(2, dtype=torch.int32), 3), "float32"),
    ((torch.zeros(2, 8, 128), torch.ones(2, dtype=torch.int64), 3), "int32"),
    ((torch.zeros(2, 8, 128), torch.ones(3, dtype=torch.int32), 3), "int32"),
    ((torch.zeros(2, 128, 8).transpose(1, 2), torch.ones(2, dtype=torch.int32),
      3), "contiguous"),
    ((torch.zeros(2, 8, 128), torch.ones(2, dtype=torch.int32), -1),
     "max_iters"),
])
def test_compute_wrapper_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        taskbench_compute(*args)


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(300), 2, 64), "whole number"),
    ((torch.zeros(256, dtype=torch.float64), 2, 64), "float32"),
    ((torch.zeros(256), -1, 64), ">= 0"),
    ((torch.zeros(256), torch.ones(1, dtype=torch.int32), 64), "int"),
    ((torch.zeros(2, 256), 3, 64), "int32"),
    ((torch.zeros(2, 256), torch.ones(2, dtype=torch.int64), 64), "int32"),
    ((torch.zeros(256, 2).t(), torch.ones(2, dtype=torch.int32), 64),
     "contiguous"),
])
def test_memory_wrapper_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        taskbench_memory(*args)


def test_fused_wrapper_rejects_bad_tables():
    g = make_graph(width=4, height=3, iterations=2, kernel="compute_mxu")
    idx, mask, iters, base, w = tables_from_numpy(
        MegakernelBackend._tables([g], 3), "cpu")
    kw = dict(kernel=g.kernel, ngraphs=1, height=3,
              payload_elems=g.payload_elems)
    with pytest.raises(ValueError, match="weight"):
        taskbench_fused(idx, mask, iters, base, None, **kw)
    with pytest.raises(ValueError, match="mask must be int32"):
        taskbench_fused(idx, mask.to(torch.int64), iters, base, w, **kw)
    with pytest.raises(ValueError, match="idx must be"):
        taskbench_fused(idx, mask, iters, base, w,
                        **{**kw, "height": 4})
    with pytest.raises(ValueError, match="dependency columns"):
        tables_from_numpy((np.full((3, 4, 3), 4, np.int32),) * 4, "cpu")


# --------------------------------------------------------------- bodies
def body_inputs(width=6, lo=1, hi=9):
    rng = np.random.RandomState(width)
    iters = rng.randint(lo, hi + 1, (width, 1)).astype(np.int32)
    seed = (rng.randint(0, 1 << 20, (width, 1)).astype(np.float32)
            * np.float32(bodies.FOLD_BLOCK))
    return iters, seed


@pytest.mark.parametrize("kind,lo,hi,max_iters", [
    ("empty", 1, 9, 9), ("compute", 15, 40, 40), ("memory", 0, 9, 9)])
def test_run_kernel_columns_matches_reference(kind, lo, hi, max_iters):
    kernel = rc.KernelSpec(kind=kind, iterations=max_iters, span_bytes=512,
                           scratch_bytes=2048)
    iters, seed = body_inputs(lo=lo, hi=hi)
    got = bodies.run_kernel_columns(kernel, torch.from_numpy(iters),
                                    torch.from_numpy(seed), max_iters)
    ref = ref_bodies.run_kernel_columns(kernel, jnp.asarray(iters),
                                        jnp.asarray(seed), max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_run_kernel_columns_mxu_matches_reference():
    kernel = rc.KernelSpec(kind="compute_mxu", iterations=4)
    iters, seed = body_inputs(width=3, lo=0, hi=4)
    got = bodies.run_kernel_columns(kernel, torch.from_numpy(iters),
                                    torch.from_numpy(seed), 4)
    ref = ref_bodies.run_kernel_columns(kernel, jnp.asarray(iters),
                                        jnp.asarray(seed), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
def test_plain_bodies_equal_the_wrapper_path(kind):
    kernel = rc.KernelSpec(kind=kind, iterations=5, span_bytes=512,
                           scratch_bytes=2048)
    iters, seed = body_inputs(width=4, hi=5)
    args = (kernel, torch.from_numpy(iters), torch.from_numpy(seed), 5)
    assert torch.equal(bodies.run_kernel_columns(*args),
                       bodies.run_kernel_columns(*args, plain=True))


@pytest.mark.parametrize("kind", ["empty", "compute", "memory"])
def test_seed_rounds_to_the_start_value(kind):
    """acc * 2^-46 with acc < 2^20 vanishes in float32: every column runs
    from the oracle's start value, whatever its dependency checksum."""
    kernel = rc.KernelSpec(kind=kind, iterations=3, span_bytes=512,
                           scratch_bytes=2048)
    seed = torch.tensor([[0.0], [float((1 << 20) - 1) * bodies.FOLD_BLOCK]])
    out = bodies.run_kernel_columns(kernel, torch.full((2, 1), 3,
                                                       dtype=torch.int32),
                                    seed, 3)
    assert out[0, 0] == out[1, 0]
    assert out[0, 0].item() == run_kernel_ref(kernel, 3)


# ------------------------------------------------------------------- K3
def ref_pair(graphs):
    radix = max(1, max(g.max_radix() for g in graphs))
    return radix, RefMega._tables(graphs, radix)


@pytest.mark.parametrize("pattern", rc.pattern_names())
def test_fused_tables_match_reference(pattern):
    kw = dict(width=6, height=7, pattern=pattern, iterations=3,
              imbalance=0.5, **PATTERN_KW.get(pattern, {}))
    for graphs, rgraphs in (([make_graph(**kw)], [rc.make_graph(**kw)]),
                            (replicate(make_graph(**kw), 3),
                             rc.replicate(rc.make_graph(**kw), 3))):
        radix, want = ref_pair(rgraphs)
        got = MegakernelBackend._tables(graphs, radix)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_fused_tables_match_reference_mixed_patterns():
    pats = ["stencil", "fft", "random"]
    graphs = [make_graph(width=6, height=5, pattern=p, iterations=2,
                         kernel="compute_mxu") for p in pats]
    rgraphs = [rc.make_graph(width=6, height=5, pattern=p, iterations=2,
                             kernel="compute_mxu") for p in pats]
    radix, want = ref_pair(rgraphs)
    for a, b in zip(MegakernelBackend._tables(graphs, radix), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,iterations,ngraphs", [
    ("empty", 3, 1), ("compute", 37, 1), ("memory", 7, 1),
    ("compute", 37, 3), ("compute_mxu", 2, 1)])
def test_plain_fused_on_reference_tables_equals_pallas_fused(kind, iterations,
                                                             ngraphs):
    kw = dict(width=6, height=6, pattern="stencil", kernel=kind,
              iterations=iterations, imbalance=0.5, span_bytes=512,
              scratch_bytes=2048)
    rgraphs = rc.replicate(rc.make_graph(**kw), ngraphs)
    radix, tabs = ref_pair(rgraphs)
    want = np.stack(ref_backend("pallas-fused").run_many(rgraphs))
    g = make_graph(**kw)
    got = taskbench_fused_plain(
        *tables_from_numpy(tabs, "cpu"), kernel=g.kernel, ngraphs=ngraphs,
        height=g.height, payload_elems=g.payload_elems).numpy()
    got = got.reshape(want.shape)
    if kind == "compute_mxu":
        np.testing.assert_array_equal(got[..., :4], want[..., :4])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_scratch_elems():
    assert scratch_elems(rc.KernelSpec(kind="empty")) == 0
    assert scratch_elems(rc.KernelSpec(kind="compute")) == 1024
    assert scratch_elems(rc.KernelSpec(kind="compute_mxu")) == 2 * 128 * 128
    assert scratch_elems(rc.KernelSpec(kind="memory", span_bytes=512,
                                       scratch_bytes=2100)) == 512


# ---------------------------------------------------------------- build
def test_build_names_repo_sources_and_sm90a():
    srcs = [p.name for p in _build.sources()]
    assert srcs == ["compute.cu", "flash_attention.cu", "fused.cu",
                    "memory.cu", "onesided.cu", "ssd.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH
    assert _build.library_path().parent == _build.BUILD_DIR
    root = Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / "build" / "repro_torch"
    assert "build/" in (root / ".gitignore").read_text().split()


def test_sources_export_every_bound_function():
    text = "".join(p.read_text() for p in _build.sources())
    for name in _build.SIGNATURES:
        assert re.search(rf'extern "C" [^(]*\b{name}\(', text), name


def test_bound_functions_take_the_declared_arguments():
    """Each exported function's C parameter list is as long as its ctypes
    ``argtypes``: ctypes would pass a shorter list's tail as garbage."""
    text = "".join(p.read_text() for p in _build.sources())
    for name, (argtypes, _) in _build.SIGNATURES.items():
        params = re.search(rf'extern "C" [^(]*\b{name}\(([^)]*)\)',
                           text).group(1)
        assert len(params.split(",")) == len(argtypes), name


@pytest.mark.parametrize("src,replaces", [
    ("compute.cu", "src/repro/kernels/compute.py::_compute_kernel"),
    ("memory.cu", "src/repro/kernels/memory.py::_memory_kernel"),
    ("fused.cu", "src/repro/backends/megakernel.py::_fused_kernel"),
    ("onesided.cu", "src/repro/backends/megakernel.py::_onesided_kernel"),
    ("ssd.cu", "src/repro/kernels/ssd.py::_ssd_kernel"),
    ("ssd_sm90.cuh", "src/repro/kernels/ssd.py::_ssd_kernel"),
    ("flash_attention.cu",
     "src/repro/kernels/flash_attention.py::_flash_kernel"),
    ("flash_attention_sm90.cuh",
     "src/repro/kernels/flash_attention.py::_flash_kernel"),
])
def test_each_kernel_names_what_it_replaces_and_its_bound(src, replaces):
    head = (_build.CSRC / src).read_text().split("#include")[0]
    assert replaces in head
    assert "Bound on the H100" in head


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_digest_follows_sources_and_flags(monkeypatch):
    d0 = _build.source_digest()
    assert d0 == _build.source_digest()
    monkeypatch.setattr(_build, "COMPILE_FLAGS", _build.COMPILE_FLAGS + ["-G"])
    assert _build.source_digest() != d0
