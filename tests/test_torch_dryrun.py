"""The port's dry run, the MoE program's collectives and ``DryRunTimer``.

- the reduced ``yi-6b`` tiny-train dry run (``launch.dryrun.lower_cell``,
  batch 8 x 64 tokens, ``grad_accum=2``) on a fake (2, 2, 2) process group
  gives per-device FLOPs within FLOPS_RTOL of the reference's sharded
  count, which a child process measures (8 host devices, the mesh's axes
  ``Auto``, the reference's own ``state_struct``, ``train_step`` and
  ``analyze_hlo``); the collective bytes of both are printed, by kind, not
  held equal; on one rank the same step counts exactly 8 times a rank's
  FLOPs; a prefill and a decode cell trace on the fake mesh;
- the CLI writes its cells to the JSON cache and skips cached ones;
- ``moe_dispatch_report(compiled=True)``: rank 0's all-to-all bytes equal
  ``analytic_a2a_bytes`` exactly, in both ``ep_mode``s, on two grids;
- ``DryRunTimer`` refuses ``torch-host`` with the reference's message and
  charges the backends with whole-graph programs (``torch-auto`` its
  winner's); a fused run is one program, its roofline K3's declared cost.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import DryRunTimer  # noqa: E402
from repro_torch.bench.moe import (MoEDispatchSpec,  # noqa: E402
                                   analytic_a2a_bytes, moe_dispatch_report)
from repro_torch.configs import InputShape, get_config, reduced  # noqa: E402
from repro_torch.core import make_graph  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402

# per-device FLOPs of the port's traced step against the reference's
# compiled program: the same products, partitioned by DTensor and by XLA
FLOPS_RTOL = 0.10
TINY = InputShape("tiny_train", 64, 8, "train")
MESH = ((2, 2, 2), ("pod", "data", "model"))

REF_TINY = r"""
import functools, json
import jax
from jax.sharding import AxisType
from repro.configs import get_config, reduced, InputShape
from repro.dist.sharding import make_rules, use_rules
from repro.launch import specs as SP
from repro.launch.roofline import analyze_hlo
from repro.optim import adamw
from repro.train import train_step as TS

cfg = reduced(get_config("yi-6b"))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
rules = make_rules(mesh)
shape = InputShape("tiny_train", 64, 8, "train")
with mesh, use_rules(rules):
    tcfg = TS.TrainConfig(grad_accum=2, adamw=adamw.AdamWConfig())
    state, axes = SP.state_struct(cfg, tcfg)
    st_sh = SP.shardings_from_axes(axes, state, rules)
    batch, baxes = SP.batch_struct(cfg, shape)
    b_sh = SP.shardings_from_axes(baxes, batch, rules)
    fn = functools.partial(TS.train_step, cfg=cfg, tcfg=tcfg)
    compiled = jax.jit(fn, donate_argnums=(0,), in_shardings=(st_sh, b_sh),
                       out_shardings=(st_sh, None)).lower(state,
                                                          batch).compile()
print(json.dumps(analyze_hlo(compiled.as_text())))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_child():
    """The reference's run, started when the module starts so that it runs
    beside the port's trace before it is needed."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH",
                                                               "")]))
    proc = subprocess.Popen([sys.executable, "-c", REF_TINY], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_child):
    out, err = reference_child.communicate(timeout=600)
    assert reference_child.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return DR.lower_cell("yi-6b", TINY, False, accum=2,
                         cfg=reduced(get_config("yi-6b")), mesh_spec=MESH)


def test_tiny_train_flops_match_the_reference_sharded_count(tiny, reference):
    assert tiny["status"] == "ok" and tiny["mesh"] == "2x2x2"
    assert tiny["grad_accum"] == 2
    got, want = tiny["flops_per_device"], reference["flops"]
    print(f"per-device FLOPs: port {got:.0f}, reference {want:.0f} "
          f"({got / want - 1:+.4%})")
    for kind in sorted(set(tiny["collectives"]) | set(
            reference["collectives"])):
        print(f"  {kind}: port {tiny['collectives'].get(kind, 0.0):.0f}, "
              f"reference {reference['collectives'].get(kind, 0.0):.0f}")
    assert abs(got / want - 1) <= FLOPS_RTOL
    assert tiny["collectives"]["total"] > 0


def test_one_rank_counts_every_rank_at_once(tiny):
    """The same step unsharded: 8 ranks' FLOPs exactly (every product of
    the sharded step splits evenly), and no collective."""
    whole = DR.lower_cell("yi-6b", TINY, False, accum=2,
                          cfg=reduced(get_config("yi-6b")),
                          mesh_spec=((1,), ("data",)))
    assert whole["flops_per_device"] == 8 * tiny["flops_per_device"]
    assert whole["collectives"] == {"total": 0.0}
    mem = whole["memory"]
    assert mem["argument_gb"] > tiny["memory"]["argument_gb"] > 0
    assert mem["alias_gb"] > 0 and mem["temp_gb"] > 0


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_prefill_and_decode_cells_trace_on_the_fake_mesh(kind):
    r = DR.lower_cell("yi-6b", InputShape(f"tiny_{kind}", 64, 8, kind),
                      False, cfg=reduced(get_config("yi-6b")),
                      mesh_spec=MESH)
    assert r["status"] == "ok" and r["flops_per_device"] > 0
    assert r["collectives"]["total"] > 0
    if kind == "decode":
        assert r["memory"]["alias_gb"] > 0  # the caches, updated in place


def test_dryrun_cli_writes_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "dryrun_torch.json")
    argv = ["--arch", "hubert-xlarge", "--shape", "decode_32k",
            "--mesh", "single", "--out", out]
    DR.main(argv)
    results = DR.load_results(out)
    key = "hubert-xlarge|decode_32k|pod16x16|tp+fsdp+sp"
    assert results[key]["status"] == "skip"
    assert DR.cell_key(results[key]) == key
    DR.main(argv)
    assert "[cached]" in capsys.readouterr().out
    assert DR.RESULTS_PATH.endswith("dryrun_torch.json")


def test_fake_group_refuses_a_second_group():
    with DR.fake_group(2):
        with pytest.raises(RuntimeError, match="already started"):
            with DR.fake_group(2):
                pass


@pytest.mark.parametrize("mode", ["replicated", "sp"])
@pytest.mark.parametrize("data,model", [(4, 2), (2, 2)])
def test_compiled_moe_a2a_bytes_equal_the_analytic_count(mode, data, model):
    spec = MoEDispatchSpec(ep_mode=mode, data=data, model=model)
    rep = moe_dispatch_report(spec, compiled=True)
    assert rep["hlo_a2a_bytes"] == analytic_a2a_bytes(spec)["a2a_bytes"]
    assert rep["hlo_a2a_bytes"] == rep["a2a_bytes"]
    # sp gathers the planes' rows over model; replicated gathers nothing
    assert (rep["hlo_allgather_bytes"] > 0) == (mode == "sp")
    assert rep["hlo_collective_bytes"] > rep["hlo_a2a_bytes"]


def test_dryrun_timer_refuses_host_dispatch():
    g = make_graph(width=4, height=3, pattern="stencil", iterations=2)
    with pytest.raises(ValueError,
                       match="does not expose compiled HLO; the dry-run "
                             "timer needs a whole-graph program"):
        DryRunTimer().measure("torch-host[device=cpu]", [g])


@pytest.mark.parametrize("backend", [
    "torch-scan[device=cpu]", "cuda-graph[device=cpu]",
    "cuda-fused[device=cpu]", "torch-auto[device=cpu]",
    "torch-csp[ranks=2,device=cpu]", "torch-pipeline[ranks=2,device=cpu]"])
def test_dryrun_timer_charges_whole_graph_programs(backend):
    graphs = [make_graph(width=6, height=4, pattern="stencil",
                         iterations=8)] * 2
    t = DryRunTimer(dispatch_overhead_s=1e-6)
    wall = t.measure(backend, graphs)
    assert 1e-6 < wall < 1e-2
    programs = t._backends[backend].lowered_programs(graphs)
    assert len(programs) >= 1


def test_fused_roofline_is_k3s_declared_cost():
    from repro_torch.backends import get_backend

    g = make_graph(width=8, height=5, pattern="nearest", radix=3,
                   iterations=16)
    be = get_backend("cuda-fused[device=cpu]")
    [program] = be.lowered_programs([g])
    _, a = TR.count_program(program)
    assert a["ops"] == 2 * 1024 * g.num_tasks * 16
    assert a["flops"] == 0
    assert DryRunTimer().measure("cuda-fused[device=cpu]", [g]) == \
        TR.step_seconds(a)
