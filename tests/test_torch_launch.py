"""The port's launch layer: meshes, specs, the roofline counter, the
kernels' declared costs and the generated tables.

- ``production_mesh_spec``, ``train_grad_accum`` and the batch and cache
  structs equal the reference's;
- each kernel K1-K6's declared cost gives ``PERF.md`` §6's bound column at
  §6's shapes, by the quantity and at the rate the column names, the
  rates from ``chip_smoke.py``'s own bound code (``card_peaks``,
  ``bound_of``) at the H100's SMs and clock, which ``launch.roofline``
  holds;
- the counter: a matmul's FLOPs exactly, FLOPs scaling with a loop's trip
  count (nested loops multiply), as the reference's HLO walker in
  ``tests/test_roofline.py``; each collective kind by its convention;
  DTensor's global-shape ops unseen; a kernel charged its declared cost
  and its plain version's ops not counted;
- ``model_flops`` and ``model_bytes`` equal the reference's for every
  config and shape;
- ``--tables``: the METG table the port's runner splices equals the
  reference's ``append_tables`` table on the same synthetic artifacts,
  names mapped.
"""
import copy
import importlib
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.configs as rcfg  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    MegakernelBackend, onesided_tables_from_numpy, tables_from_numpy,
    taskbench_fused, taskbench_onesided)
from repro_torch.dist import plan_comm  # noqa: E402
from repro_torch.kernels import (taskbench_compute,  # noqa: E402
                                 taskbench_memory)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd import ssd_chunked  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- meshes and specs
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("stages", [1, 2, 4, 16])
def test_production_mesh_spec_equals_the_reference(multi_pod, stages):
    from repro.launch.mesh import production_mesh_spec

    assert TMESH.production_mesh_spec(multi_pod=multi_pod,
                                      pipeline_stages=stages) == \
        production_mesh_spec(multi_pod=multi_pod, pipeline_stages=stages)


def test_production_mesh_spec_refuses_an_indivisible_data_axis():
    with pytest.raises(ValueError, match="not divisible"):
        TMESH.production_mesh_spec(pipeline_stages=3)


@pytest.mark.parametrize("name", rcfg.ALL_ARCHS)
def test_structs_and_grad_accum_equal_the_reference(name):
    from types import SimpleNamespace

    rc, pc = rcfg.get_config(name), tcfg.get_config(name)
    for shape_name, shape in rcfg.SHAPES.items():
        got, got_axes = TSP.batch_struct(pc, tcfg.SHAPES[shape_name])
        want, want_axes = RSP.batch_struct(rc, shape)
        assert got_axes == want_axes
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        for mp in (False, True):
            shp, axes = TMESH.production_mesh_spec(multi_pod=mp)
            mesh = SimpleNamespace(shape=dict(zip(axes, shp)))
            assert TSP.train_grad_accum(pc, tcfg.SHAPES[shape_name],
                                        mesh.shape) == \
                RSP.train_grad_accum(rc, shape, mesh)
            assert TSP.decode_grad_accum(pc, tcfg.SHAPES[shape_name],
                                         mesh) == 1
    caches, axes = TSP.caches_struct(pc, 4, 64)
    layers = caches if isinstance(caches, list) else [caches]
    assert all(t.is_meta for c in layers for t in c.tensors())


# ------------------------------------------- the kernels' declared costs
def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _k1():
    return taskbench_compute.cost(meta(132, 8, 128),
                                  meta(132, dtype=torch.int32), 16)


def _k2():
    return taskbench_memory.cost(meta(132, 262144),
                                 torch.full((132,), 4, dtype=torch.int32), 64)


def _stencil():
    return chip_smoke.full_size("stencil")


def _k3():
    g = _stencil()
    tabs = tables_from_numpy(MegakernelBackend._tables([g], g.max_radix()),
                             "cpu")
    return taskbench_fused.cost(*tabs, kernel=g.kernel, ngraphs=1,
                                height=g.height,
                                payload_elems=g.payload_elems)


def _k4():
    g = _stencil()
    plan = plan_comm(g, 132, "cols", comm="onesided")
    tabs = onesided_tables_from_numpy(
        *MegakernelBackend._onesided_tables(g, plan), "cpu")
    return taskbench_onesided.cost(*tabs, kernel=g.kernel, height=g.height,
                                   payload_elems=g.payload_elems)


def _k5():
    bf = torch.bfloat16
    return flash_attention.cost(meta(1, 3000, 10, 256, dtype=bf),
                                meta(1, 3000, 1, 256, dtype=bf),
                                meta(1, 3000, 1, 256, dtype=bf), True, 2048,
                                0)


def _k6():
    bf = torch.bfloat16
    return ssd_chunked.cost(meta(1, 1024, 80, 64, dtype=bf),
                            meta(1, 1024, 80), meta(80),
                            meta(1, 1024, 1, 128, dtype=bf),
                            meta(1, 1024, 1, 128, dtype=bf), None, 128)


# PERF.md §6's bound column: (declared cost, quantity, rate, ms, by)
SECTION6 = {
    "K1": (_k1, "ops", "fp32", 0.000323, "bytes"),
    "K2": (_k2, "ops", "fp32", 0.082634, "bytes"),
    "K3": (_k3, "ops", "fp32", 0.064646, "operations"),
    "K4": (_k4, "ops", "fp32", 0.064646, "operations"),
    "K5": (_k5, "flops", "bf16", 0.038719, "operations"),
    "K6 bytes": (_k6, "flops", "bf16", 0.007297, "bytes"),
    "K6 ops": (_k6, "flops", "fp32", 0.070445, "operations"),
}


def test_roofline_constants_are_chip_smokes_rates():
    fp32, bf16 = chip_smoke.card_peaks(TR.SMS, TR.MAX_SM_CLOCK_HZ / 1e6)
    assert (TR.PEAK_FP32, TR.PEAK_FLOPS) == (fp32, bf16)
    assert TR.HBM_BW == chip_smoke.HBM_BYTES_PER_S
    from repro_torch.bench import moe

    assert moe.LINK_BW is TR.LINK_BW == 450e9


@pytest.mark.parametrize("kernel", sorted(SECTION6))
def test_declared_cost_gives_the_section6_bound(kernel):
    make, quantity, rate, want_ms, want_by = SECTION6[kernel]
    cost = make()
    fp32, bf16 = chip_smoke.card_peaks(TR.SMS, TR.MAX_SM_CLOCK_HZ / 1e6)
    peak = fp32 if rate == "fp32" else bf16
    if kernel == "K6 ops":  # §6's second K6 figure: its products alone
        s, by = cost.flops / peak, "operations"
    else:
        s, by = chip_smoke.bound_of(getattr(cost, quantity), cost.bytes, peak)
    assert (round(s * 1e3, 6), by) == (want_ms, want_by)
    # matmul FLOPs only for K5 and K6, by the roofline's convention
    assert (cost.flops > 0) == kernel.startswith(("K5", "K6"))


def test_chip_smokes_bounds_are_the_declared_costs():
    """The bound helpers the serving and training phases call are the
    kernels' declared costs."""
    k5, k6 = _k5(), _k6()
    assert chip_smoke.attn_cost(1, 3000, 3000, 10, 1, 256, True, 2048, 0,
                                2) == (k5.flops, k5.bytes)
    assert chip_smoke.ssd_bound(1, 1024, 80, 64, 128, 128, 2) == \
        (k6.flops, k6.bytes)


# --------------------------------------------------------------- counter
def test_single_matmul_flops_exact():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    _, got = TR.count_program(lambda: a @ b)
    assert got["flops"] == 2 * 64 * 32 * 128
    assert got["hbm_bytes"] == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert got["collectives"] == {"total": 0.0}


def test_loop_multiplies_by_trip_count():
    w, x = torch.randn(7, 32, 32), torch.randn(8, 32)

    def fn():
        h = x
        for i in range(w.shape[0]):
            h = torch.tanh(h @ w[i])
        return h

    _, got = TR.count_program(fn)
    assert got["flops"] == 7 * 2 * 8 * 32 * 32
    assert got["unknown_trip_whiles"] == 0


def test_nested_loops_multiply():
    w, x = torch.randn(3, 5, 16, 16), torch.randn(4, 16)

    def fn():
        h = x
        for i in range(3):
            for j in range(5):
                h = torch.tanh(h @ w[i, j])
        return h

    _, got = TR.count_program(fn)
    assert got["flops"] == 3 * 5 * 2 * 4 * 16 * 16


def test_hbm_bytes_positive_and_bounded():
    a = torch.randn(256, 256)
    _, got = TR.count_program(lambda: a @ a)
    nbytes = 256 * 256 * 4
    assert 3 * nbytes * 0.9 <= got["hbm_bytes"] <= 30 * nbytes


def test_kernels_charge_their_declared_cost_not_their_plain_ops():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 32, generator=g)
    k = torch.randn(1, 64, 2, 32, generator=g)
    _, got = TR.count_program(lambda: flash_attention(q, k, k, True, None, 0))
    want = flash_attention.cost(q, k, k, True, None, 0)
    assert (got["flops"], got["hbm_bytes"], got["ops"]) == tuple(want)
    tiles = torch.full((3, 8, 128), 0.5)
    its = torch.full((3,), 5, dtype=torch.int32)
    _, got = TR.count_program(lambda: taskbench_compute(tiles, its, 5))
    want = taskbench_compute.cost(tiles, its, 5)
    assert (got["flops"], got["hbm_bytes"], got["ops"]) == tuple(want)
    assert TR.active_counter() is None


def test_collective_conventions():
    """all-gather, all-to-all, permute: result bytes; all-reduce: twice
    its result; reduce-scatter: its operand (functional and c10d ops)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from repro_torch.launch.dryrun import fake_group

    x = torch.ones(4, 8)  # 128 bytes
    with fake_group(4):
        group = dist.group.WORLD
        with TR.CostCounter() as c:
            fc.wait_tensor(fc.all_gather_tensor(x, 0, group))
            fc.wait_tensor(fc.all_reduce(x, "sum", group))
            fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0, group))
            out = torch.empty(4, 8)
            dist.all_to_all_single(out, x)
            dist.all_gather([torch.empty(4, 8) for _ in range(4)], x)
            dist.all_reduce(x)
            dist.recv(out, src=1)
    got = c.analysis()["collectives"]
    assert got == {"all-gather": 4 * 128 * 2, "all-reduce": 2 * 128 * 2,
                   "reduce-scatter": 128, "all-to-all": 128,
                   "collective-permute": 128, "total": float(
                       4 * 128 * 2 + 2 * 128 * 2 + 128 + 128 + 128)}


def test_dtensor_global_shape_ops_are_not_counted():
    """A (512, 1024) @ (1024, 2048) product, rows over data and columns
    over model of a (32, 16) mesh: the local product's FLOPs alone (the
    global op's are what FlopCounterMode adds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist.sharding import make_rules
    from repro_torch.launch.dryrun import fake_group

    with fake_group(512):
        mesh = TMESH.make_debug_mesh((32, 16), ("data", "model"),
                                     device="cpu")
        rules = make_rules(mesh)
        with FakeTensorMode():
            a = TSP.place(torch.zeros(512, 1024), ("batch", None), rules)
            b = TSP.place(torch.zeros(1024, 2048), (None, "ffn"), rules)
            with TR.CostCounter() as c:
                a @ b
    assert c.analysis()["flops"] == 2 * 16 * 128 * 1024 == 4194304


@pytest.mark.parametrize("name", rcfg.ALL_ARCHS)
def test_model_flops_and_bytes_equal_the_reference(name):
    rc, pc = rcfg.get_config(name), tcfg.get_config(name)
    for shape_name, shape in rcfg.SHAPES.items():
        ps = tcfg.SHAPES[shape_name]
        assert TR.model_flops(pc, ps) == RR.model_flops(rc, shape)
        assert TR.model_bytes(pc, ps) == RR.model_bytes(rc, shape)


def test_roofline_terms_read_the_analysis():
    cfg, shape = tcfg.get_config("yi-6b"), tcfg.SHAPES["decode_32k"]
    a = {"flops": TR.PEAK_FLOPS, "hbm_bytes": 2 * TR.HBM_BW,
         "attn_sq_bytes": TR.HBM_BW, "collectives": {"total": 0.0}}
    t = TR.roofline_terms(a, cfg, shape, chips=4)
    assert (t["compute_s"], t["memory_s"], t["memory_s_raw"]) == (1.0, 1.0,
                                                                  2.0)
    assert t["bound_step_s"] == 1.0 and "bw_fraction" in t
    assert TR.step_seconds({**a, "ops": 3 * TR.PEAK_FP32}) == 3.0


# ------------------------------------------------------------------ tables
def _mapped(doc):
    from repro_torch.bench.names import port_label, port_spec

    doc = copy.deepcopy(doc)
    doc["scenario"]["name"] = port_label(doc["scenario"]["name"])
    doc["scenario"]["backend"] = port_spec(doc["scenario"]["backend"])
    return doc


@pytest.mark.parametrize("family", ["bench_metg_patterns", "bench_metg_deps"])
def test_tables_metg_equals_the_reference_append_tables(family, tmp_path):
    import append_tables
    import repro.bench as rb
    from benchmarks.common import BenchContext as RefContext
    from repro_torch.bench import run as prun
    from repro_torch.bench import tables

    ctx = RefContext(smoke=True, artifacts_dir=str(tmp_path / "ref"),
                     timer=rb.SyntheticTimer())
    importlib.import_module(f"benchmarks.{family}").run(ctx)
    ref_docs, skipped = append_tables.load_metg_artifacts(str(tmp_path /
                                                              "ref"))
    assert not skipped
    md = tmp_path / "E.md"
    md.write_text("# notes kept\n")
    prun.main(["--only", family, "--smoke", "--timer", "synthetic",
               "--artifacts", str(tmp_path / "port"), "--tables",
               "--tables-file", str(md)])
    docs, skipped = tables.load_metg_artifacts(str(tmp_path / "port"))
    assert not skipped and len(docs) == len(ref_docs)
    got = tables.render_metg_summary(docs)
    assert got == append_tables.render_metg_summary(
        [_mapped(d) for d in ref_docs])
    text = md.read_text()
    assert text.startswith("# notes kept\n") and got in text
    assert tables.MARKER in text and "TUNE" not in text
    assert "Auto-backend tuning winners" in text


def test_tables_need_artifacts(capsys):
    from repro_torch.bench import run as prun

    with pytest.raises(SystemExit):
        prun.main(["--tables", "--artifacts", ""])
    assert "--tables requires --artifacts" in capsys.readouterr().err


def test_dryrun_tables_render(tmp_path):
    from repro_torch.bench import tables

    v = {"arch": "yi-6b", "shape": "decode_32k", "mesh": "pod16x16",
         "strategy": "tp+fsdp+sp", "status": "ok", "compile_s": 8.2,
         "flops_per_device": 1.6e10, "hbm_bytes_per_device": 5.7e10,
         "collectives": {"total": 3.1e8, "all-gather": 2.8e8},
         "memory": {"argument_gb": 17.2, "output_gb": 17.2, "temp_gb": 0.1,
                    "alias_gb": 17.2}}
    path = tmp_path / "r.json"
    path.write_text(json.dumps({"yi-6b|decode_32k|pod16x16|tp+fsdp+sp": v}))
    out = tables.append_dryrun_tables(str(path), str(tmp_path / "E.md"))
    text = open(out).read()
    assert "| yi-6b | decode_32k |" in text and "| yes |" in text
