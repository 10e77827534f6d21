"""The port's task body and backends against the oracle and the reference.

``torch-scan`` (counterpart of ``xla-scan``) and ``cuda-fused`` (counterpart
of ``pallas-fused``) run here on the CPU (``[device=cpu]``), where the
kernel wrappers take their plain versions.  Every pattern x kernel kind is
checked against the numpy oracle; the elementwise kinds are also checked
bitwise against the reference package's backends on stencil, sweep and
fft, at iteration counts where XLA's fused multiply-add contraction on the
CPU cannot show (see ``test_torch_kernels.py``): compute at 37 steps from
0.5, memory at <= 2 steps per window from 1.0.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.backends as ref_backends  # noqa: E402
import repro.backends.body as ref_body  # noqa: E402
import repro.core as rc  # noqa: E402
import repro_torch.backends as tb  # noqa: E402
from repro_torch.backends import body  # noqa: E402
from repro_torch.core import (check_outputs, execute_reference,  # noqa: E402
                              make_graph, pattern_names, replicate)

ROOT = Path(__file__).resolve().parents[1]
PATTERN_KW = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
KINDS = ["empty", "compute", "memory", "compute_mxu"]
# iterations per kind where XLA-CPU agrees with the oracle to the bit
CROSS_ITERS = {"empty": 4, "compute": 37, "memory": 7}
BACKENDS = ["torch-scan[device=cpu]", "cuda-fused[device=cpu]"]
REF_OF = {"torch-scan[device=cpu]": "xla-scan",
          "cuda-fused[device=cpu]": "pallas-fused"}


def graph_kw(pattern, kind, iterations=5, **kw):
    args = dict(width=6, height=8, pattern=pattern, kernel=kind,
                iterations=iterations, imbalance=0.5, span_bytes=512,
                scratch_bytes=2048, **PATTERN_KW.get(pattern, {}))
    args.update(kw)
    return args


@pytest.fixture(scope="module")
def oracle():
    cache = {}

    def get(graph):
        if graph not in cache:
            cache[graph] = execute_reference(graph)
        return cache[graph]

    return get


# ------------------------------------------------------------ task body
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pattern", pattern_names())
def test_timestep_matches_reference_body(pattern, kind):
    its = 2 if kind == "compute_mxu" else CROSS_ITERS[kind]
    kw = graph_kw(pattern, kind, iterations=its, width=7)
    g, rg = make_graph(**kw), rc.make_graph(**kw)
    t = 3
    hist = execute_reference(g, return_all=True)
    mats, iters = body.graph_static_inputs(g)
    got = body.timestep(g, t, torch.from_numpy(hist[t - 1]),
                        torch.from_numpy(mats[t]), torch.from_numpy(iters[t]))
    want = np.asarray(ref_body.timestep(
        rg, t, jnp.asarray(hist[t - 1]), jnp.asarray(mats[t]),
        jnp.asarray(iters[t])))
    got = got.numpy()
    if kind == "compute_mxu":
        np.testing.assert_array_equal(got[:, :4], want[:, :4])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, hist[t])


def test_timestep_stacked_equals_each_graph():
    """The stacked form is a leading graph dimension written out."""
    graphs = [make_graph(**graph_kw(p, "compute")) for p in
              ("stencil", "fft", "random")]
    hist = [execute_reference(g, return_all=True) for g in graphs]
    statics = [body.graph_static_inputs(g) for g in graphs]
    t = 4
    stacked = body.timestep(
        graphs[0], t, torch.from_numpy(np.stack([h[t - 1] for h in hist])),
        torch.from_numpy(np.stack([m[t] for m, _ in statics])),
        torch.from_numpy(np.stack([i[t] for _, i in statics])))
    for k, g in enumerate(graphs):
        np.testing.assert_array_equal(stacked[k].numpy(), hist[k][t])


def test_checksum_vec_matches_graph_checksum():
    g = make_graph(width=50, height=5)
    cols = torch.arange(50)
    for t in (0, 1, 4, 123456, 2**31 + 7):
        got = body.checksum_vec(t, cols).numpy()
        assert [int(v) for v in got] == [g.checksum(t, i) for i in range(50)]


def test_combine_acc_is_exact_beyond_float32():
    """A sum of W values below 2^20 exceeds f32's 24 bits; int64 keeps it."""
    w = 300
    mat = torch.ones(1, w, dtype=torch.uint8)
    prev = torch.full((w,), (1 << 20) - 1, dtype=torch.int64)
    assert body.combine_acc(mat, prev).item() == (w * ((1 << 20) - 1)) % (1 << 20)


# ------------------------------------------------------------- backends
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pattern", pattern_names())
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_oracle(backend, pattern, kind, oracle):
    g = make_graph(**graph_kw(pattern, kind, iterations=2
                              if kind == "compute_mxu" else 5))
    out = tb.get_backend(backend).run([g])[0]
    check_outputs(g, out, expected=oracle(g))
    if kind != "compute_mxu":
        np.testing.assert_array_equal(out, oracle(g))


@pytest.mark.parametrize("kind", ["empty", "compute", "memory"])
@pytest.mark.parametrize("pattern", ["stencil", "sweep", "fft"])
def test_backends_match_reference_backends_bitwise(pattern, kind):
    kw = graph_kw(pattern, kind, iterations=CROSS_ITERS[kind])
    g, rg = make_graph(**kw), rc.make_graph(**kw)
    for backend in BACKENDS:
        got = tb.get_backend(backend).run([g])[0]
        want = ref_backends.get_backend(REF_OF[backend]).run([rg])[0]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ngraphs", [2, 3])
@pytest.mark.parametrize("pattern", ["stencil", "spread"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_run_many_matches_run(backend, pattern, ngraphs):
    g = make_graph(**graph_kw(pattern, "compute"))
    be = tb.get_backend(backend)
    single = be.run([g])[0]
    outs = be.run_many(replicate(g, ngraphs))
    assert len(outs) == ngraphs
    for out in outs:
        np.testing.assert_array_equal(out, single)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_many_stacks_mixed_patterns(backend, oracle):
    graphs = [make_graph(**graph_kw(p, "memory")) for p in
              ("stencil", "fft", "random", "nearest")]
    assert body.stackable(graphs)
    outs = tb.get_backend(backend).run_many(graphs)
    for g, out in zip(graphs, outs):
        np.testing.assert_array_equal(out, oracle(g))


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_many_unstackable_falls_back_to_run(backend, oracle):
    graphs = [make_graph(**graph_kw("stencil", "compute")),
              make_graph(**graph_kw("stencil", "compute", width=5)),
              make_graph(**graph_kw("fft", "empty", output_bytes=40))]
    assert not body.stackable(graphs)
    outs = tb.get_backend(backend).run_many(graphs)
    for g, out in zip(graphs, outs):
        assert out.shape == (g.width, g.payload_elems)
        np.testing.assert_array_equal(out, oracle(g))


def test_cuda_fused_matches_reference_on_ragged_payload(oracle):
    kw = graph_kw("stencil", "compute", iterations=37, output_bytes=36,
                  width=5, height=4)
    out = tb.get_backend("cuda-fused[device=cpu]").run([make_graph(**kw)])[0]
    want = ref_backends.get_backend("pallas-fused").run([rc.make_graph(**kw)])[0]
    assert out.shape == (5, 9)
    np.testing.assert_array_equal(out, want)


# ------------------------------------------------------ registry, device
def test_port_registry_is_its_own():
    assert tb.backend_names() == ["cuda-fused", "torch-scan"]
    assert not set(tb.backend_names()) & set(ref_backends.backend_names())


def test_spec_grammar():
    assert tb.parse_backend_spec("torch-scan") == ("torch-scan", {})
    assert tb.parse_backend_spec("x[b=cpu,a=False,c=4]") == (
        "x", {"a": False, "b": "cpu", "c": 4})
    assert tb.parse_backend_spec("x[device=cuda:0]")[1] == {"device": "cuda:0"}
    for bad in ("x[a]", "x[=1]", "x[a=1,a=2]", "bad name"):
        with pytest.raises(ValueError):
            tb.parse_backend_spec(bad)


@pytest.mark.parametrize("name", ["torch-scan", "cuda-fused"])
def test_unknown_option_is_rejected_naming_the_key(name):
    with pytest.raises(ValueError, match="'devcie'.*known options: "
                                         "\\['device'\\]"):
        tb.get_backend(f"{name}[devcie=cpu]")
    with pytest.raises(KeyError, match="unknown backend"):
        tb.get_backend("xla-scan")


@pytest.mark.parametrize("spec", ["torch-scan", "cuda-fused",
                                  "torch-scan[device=cuda]"])
def test_no_device_and_no_card_raises(monkeypatch, spec):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.get_backend(spec)
    assert tb.get_backend(spec.split("[")[0] + "[device=cpu]").device \
        == torch.device("cpu")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tb.get_backend("cuda-fused").device == torch.device("cuda")
    assert tb.get_backend("torch-scan", device="cpu").device.type == "cpu"


def test_no_tf32_anywhere():
    import repro_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# ------------------------------------------------------------ isolation
_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)",
                        re.M)


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        hits = _IMPORT_RE.findall(path.read_text())
        assert not hits, (path, hits)


def test_import_and_run_load_no_jax_or_reference_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.bench\n"
        "from repro_torch.backends import get_backend\n"
        "from repro_torch.core import make_graph, check_outputs\n"
        "g = make_graph(width=4, height=3, iterations=2)\n"
        "for b in ('torch-scan[device=cpu]', 'cuda-fused[device=cpu]'):\n"
        "    check_outputs(g, get_backend(b).run([g])[0])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
