"""The port's copy of the task-graph core equals the reference's.

``repro_torch.core`` is a copy of the numpy-only ``repro.core`` (the port
imports nothing of ``repro``).  These tests hold the copy equal to the
reference on every pattern: dependency tables, checksums, dependence
matrices, task durations and the numpy oracle itself.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro_torch.core as tc  # noqa: E402

PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
MEM_KW = {"scratch_bytes": 2048, "span_bytes": 512}


def graph_pair(pattern, kind="compute", **kw):
    args = dict(width=7, height=8, pattern=pattern, kernel=kind,
                iterations=6, imbalance=0.5, seed=3,
                **PATTERN_KW.get(pattern, {}),
                **(MEM_KW if kind == "memory" else {}))
    args.update(kw)
    return tc.make_graph(**args), rc.make_graph(**args)


def test_pattern_registry_matches():
    assert tc.pattern_names() == rc.pattern_names()


@pytest.mark.parametrize("pattern", rc.pattern_names())
def test_dependency_tables_match(pattern):
    g, r = graph_pair(pattern)
    for a, b in zip(g.dependency_table(), r.dependency_table()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    wide = r.dependency_table()[0].shape[2] + 2
    for a, b in zip(g.dependency_table(wide), r.dependency_table(wide)):
        np.testing.assert_array_equal(a, b)
    assert g.max_radix() == r.max_radix()


@pytest.mark.parametrize("pattern", rc.pattern_names())
def test_checksums_and_matrices_match(pattern):
    g, r = graph_pair(pattern, width=9, height=40)
    np.testing.assert_array_equal(g.checksum_table(), r.checksum_table())
    assert g.checksum_table().dtype == np.uint32
    np.testing.assert_array_equal(g.dependence_matrices(),
                                  r.dependence_matrices())
    assert g.is_time_invariant() == r.is_time_invariant()
    for t in (0, 1, g.height - 1):
        for i in range(g.width):
            assert g.deps(t, i) == r.deps(t, i)
            assert g.reverse_deps(t, i) == r.reverse_deps(t, i)
            assert g.checksum(t, i) == r.checksum(t, i)


@pytest.mark.parametrize("imbalance", [0.0, 0.5, 1.5])
@pytest.mark.parametrize("pattern", ["stencil", "random", "spread"])
def test_task_iterations_match(pattern, imbalance):
    g, r = graph_pair(pattern, imbalance=imbalance, iterations=37)
    got = [[g.task_iterations(t, i) for i in range(g.width)]
           for t in range(g.height)]
    want = [[r.task_iterations(t, i) for i in range(r.width)]
            for t in range(r.height)]
    assert got == want
    assert g.total_iterations() == r.total_iterations()
    assert g.total_useful_work() == r.total_useful_work()


@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
@pytest.mark.parametrize("pattern", rc.pattern_names())
def test_execute_reference_matches(pattern, kind):
    g, r = graph_pair(pattern, kind, iterations=3 if kind == "compute_mxu"
                      else 6)
    got = tc.execute_reference(g, return_all=True)
    want = rc.execute_reference(r, return_all=True)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["empty", "compute", "memory",
                                  "compute_mxu"])
def test_kernel_spec_work_matches(kind):
    kw = MEM_KW if kind == "memory" else {}
    a = tc.KernelSpec(kind=kind, iterations=11, **kw)
    b = rc.KernelSpec(kind=kind, iterations=11, **kw)
    assert (a.flops_per_task, a.bytes_per_task, a.useful_work()) == \
        (b.flops_per_task, b.bytes_per_task, b.useful_work())


def test_check_outputs_rejects_a_wrong_checksum():
    g, _ = graph_pair("stencil")
    out = tc.execute_reference(g)
    tc.check_outputs(g, out)
    bad = out.copy()
    bad[2, 3] += 1.0
    with pytest.raises(AssertionError, match="column 2 slot 3"):
        tc.check_outputs(g, bad, expected=out)


def test_graph_validation_matches():
    with pytest.raises(ValueError):
        tc.make_graph(width=0)
    with pytest.raises(ValueError):
        tc.KernelSpec(kind="nope")
    with pytest.raises(ValueError):
        tc.KernelSpec(kind="memory", span_bytes=8, scratch_bytes=4)
    with pytest.raises(KeyError):
        tc.make_graph(pattern="nope")
    g = tc.make_graph(width=5, height=3, output_bytes=40)
    assert g.payload_elems == 10
    assert tc.replicate(g, 3) == [g, g, g]
