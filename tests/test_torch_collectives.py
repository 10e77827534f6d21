"""The port's comm planning and one-sided tables against the reference.

``repro_torch.dist.collectives`` is a copy of the numpy planning half of
``repro.dist.collectives``; ``MegakernelBackend._onesided_tables`` builds
K4's per-rank tables from its one-sided plan.  Both are numpy, so they are
held equal to the reference field by field here, in-process, for every
pattern, rank count and width (ragged widths included).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
from repro.backends.megakernel import MegakernelBackend as RefMega  # noqa: E402
from repro.dist import collectives as RC  # noqa: E402
from repro_torch.backends.megakernel import MegakernelBackend  # noqa: E402
from repro_torch.core import make_graph, pattern_names  # noqa: E402
from repro_torch.dist import collectives as TC  # noqa: E402

PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
WIDTHS = (6, 10, 3)
MODES = ("onesided", "a2a", "auto", "halo")
SCALARS = ("mode", "axis", "ndev", "width", "padded_width", "local", "halo",
           "comm_overlap", "a2a_cap", "ragged", "context_width")
ARRAYS = ("local_mats", "iters", "send_counts", "a2a_send_idx",
          "recv_counts")


def graphs(pattern, width, height=6, **kw):
    args = dict(width=width, height=height, pattern=pattern, iterations=2,
                imbalance=0.5, **PATTERN_KW.get(pattern, {}), **kw)
    return make_graph(**args), rc.make_graph(**args)


def plan_or_error(module, graph, ndev, mode):
    try:
        return module.plan_comm(graph, ndev, "cols", comm=mode)
    except ValueError as e:
        return e


def assert_plans_equal(got, want, where):
    for f in SCALARS:
        assert getattr(got, f) == getattr(want, f), (f, where)
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), (f, where)
        if a is not None:
            assert a.dtype == b.dtype, (f, where)
            np.testing.assert_array_equal(a, b, err_msg=f"{f} {where}")
    if got.mode == "onesided":
        assert len(got._onesided_offsets) == len(want._onesided_offsets)
        for mine, ref in zip(got._onesided_offsets, want._onesided_offsets):
            assert mine[0] == ref[0], where
            for a, b in zip(mine[1:], ref[1:]):
                assert a.dtype == b.dtype, where
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("pattern", pattern_names())
def test_plan_comm_matches_reference(pattern, ndev):
    for width in WIDTHS:
        g, rg = graphs(pattern, width)
        for mode in MODES:
            where = (pattern, width, ndev, mode)
            got = plan_or_error(TC, g, ndev, mode)
            want = plan_or_error(RC, rg, ndev, mode)
            if isinstance(want, ValueError):
                # halo where the reach exceeds a rank's block
                assert isinstance(got, ValueError), where
                assert str(got) == str(want)
                continue
            assert_plans_equal(got, want, where)
            padded = np.arange(got.padded_width)
            np.testing.assert_array_equal(got.trim(padded),
                                          np.arange(width))


@pytest.mark.parametrize("pattern", pattern_names())
def test_reach_matches_reference(pattern):
    for width in WIDTHS:
        g, rg = graphs(pattern, width)
        assert TC.directional_reach(g) == RC.directional_reach(rg)
        assert TC.dependency_reach(g) == RC.dependency_reach(rg)
        np.testing.assert_array_equal(TC._dep_offsets(g),
                                      RC._dep_offsets(rg))


def test_plan_comm_rejects_like_reference():
    g, rg = graphs("stencil", 6)
    for args in ((g, 2, "cols", "bogus"), (g, 0, "cols", "a2a"),
                 (g, 2, "cols", "ring")):
        with pytest.raises(ValueError) as mine:
            TC.plan_comm(*args)
        with pytest.raises(ValueError) as ref:
            RC.plan_comm(rg, *args[1:])
        assert str(mine.value) == str(ref.value)
    assert TC.MODES == RC.MODES


def test_comm_overlap_and_prefer_ring_match_reference():
    g, rg = graphs("sweep", 10)
    for kw in ({"comm": "auto", "prefer_ring": True},
               {"comm": "a2a", "comm_overlap": True},
               {"comm": "onesided", "comm_overlap": True}):
        assert_plans_equal(TC.plan_comm(g, 4, "cols", **kw),
                           RC.plan_comm(rg, 4, "cols", **kw), kw)


# ------------------------------------------------------- one-sided tables
def onesided_tables(pattern, width, ranks, **kw):
    g, rg = graphs(pattern, width, **kw)
    got = MegakernelBackend._onesided_tables(
        g, TC.plan_comm(g, ranks, "cols", comm="onesided"))
    want = RefMega._onesided_tables(
        rg, RC.plan_comm(rg, ranks, "cols", comm="onesided"))
    return got, want


@pytest.mark.parametrize("ranks", [2, 4, 8, "W"])
@pytest.mark.parametrize("pattern", pattern_names())
def test_onesided_tables_match_reference(pattern, ranks):
    for width in WIDTHS:
        n = width if ranks == "W" else ranks
        (offs, tabs), (ref_offs, ref_tabs) = onesided_tables(pattern, width,
                                                             n)
        where = (pattern, width, n)
        assert offs == ref_offs, where
        # idx / mask in inbox coordinates, iters, base
        for a, b in zip(tabs[:4], ref_tabs[:4]):
            assert a.dtype == b.dtype and a.shape == b.shape, where
            np.testing.assert_array_equal(a, b, err_msg=str(where))
        # send_rows: the argmax of the reference's one-hot put selection
        send_rows, sel = tabs[4], ref_tabs[4]
        assert send_rows.dtype == np.int32
        assert send_rows.shape == sel.shape[:3], where
        hot = sel.any(-1)
        np.testing.assert_array_equal(send_rows[hot], sel.argmax(-1)[hot])
        assert (send_rows[~hot] == 0).all()
        assert hot.any() == bool(offs), where


def test_onesided_tables_mxu_weight_matches_reference():
    (offs, tabs), (_, ref_tabs) = onesided_tables("fft", 10, 4,
                                                  kernel="compute_mxu")
    assert len(tabs) == len(ref_tabs) == 6
    np.testing.assert_array_equal(tabs[5], ref_tabs[5])


def test_onesided_tables_full_width_rank_per_column():
    """W ranks of one column each: the one-task-per-CTA shape of K4."""
    (offs, tabs), (ref_offs, ref_tabs) = onesided_tables("stencil", 32, 32,
                                                         height=5)
    assert offs == ref_offs == [1, 31]
    assert tabs[0].shape == (32, 5, 1, 3)
    for a, b in zip(tabs[:4], ref_tabs[:4]):
        np.testing.assert_array_equal(a, b)
