"""Granite 4.0-H Small on the port (``configs/granite_4p0_h_small.py``)
against its plain float32 reference, ``tests/plain/granite_hybrid.py``, on
the CPU at ``reduced()``'s cut: one period of the layer pattern (nine
``ssd_moe`` layers and one ``moe``), 2 of 8 experts held, top-3.

Each new block alone, the whole forward, and the engine's prefill then
decode through its cache, on logits; the share test (every chip's share
of the experts, with the shared expert counted once, adds up to the uncut
layer); the held-pair counter; the benchmark's copy of the reference
(``portbench/reference/granite_hybrid.py``) bit for bit equal to this
one; the new settings at their defaults changing nothing.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import PortConfig, get_config, reduced
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import apply_mlp, apply_norm
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
NAME = "granite-4.0-h-small"
TOL = 2e-5  # of the reference's largest value: float32 both sides


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = load(ROOT / "tests" / "plain" / "granite_hybrid.py", "plain_granite")
BENCH = load(ROOT / "portbench" / "reference" / "granite_hybrid.py",
             "bench_granite")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny models; the suite runs several workers on the CPU at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numbers(cfg) -> dict:
    """The reference's model numbers of a port configuration."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "layer_types": ["attention" if k == "moe" else "mamba"
                            for k in cfg.pattern_for_depth()],
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "experts_held": list(cfg.experts_held),
            "mamba_n_heads": cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim,
            "mamba_d_head": cfg.ssm_headdim,
            "mamba_n_groups": cfg.ssm_ngroups,
            "mamba_d_state": cfg.ssm_state, "rms_norm_eps": cfg.norm_eps,
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "attention_multiplier": cfg.attention_scale}


def close(got, want, tol=TOL):
    got, want = got.double(), want.double()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= tol, err


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config(NAME))
    return cfg, M.init_model(cfg, 0, "cpu")


def test_config_is_the_published_model_at_one_chips_share():
    cfg = get_config(NAME)
    assert isinstance(cfg, PortConfig)
    kinds = cfg.pattern_for_depth()
    assert len(kinds) == 40
    assert [i for i, k in enumerate(kinds) if k == "moe"] == [5, 15, 25, 35]
    assert set(kinds) == {"moe", "ssd_moe"}
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.experts_held,
            cfg.d_ff, cfg.dense_residual_ff) == (72, 10, (0, 9), 768, 1536)
    assert cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim == 128
    assert cfg.attention_scale == 1 / 128 and cfg.position_embedding == "nope"
    small = reduced(cfg)
    assert small.pattern_for_depth() == kinds[:10]
    assert (small.num_experts, small.num_experts_per_tok,
            small.experts_held) == (8, 3, (0, 2))


@pytest.mark.parametrize("kind,ref_kind", [("ssd_moe", "mamba"),
                                           ("moe", "attention")])
def test_each_new_block_matches_the_reference(model, kind, ref_kind):
    cfg, params = model
    i = cfg.pattern_for_depth().index(kind)
    p = params["blocks"][i]
    g = torch.Generator().manual_seed(3)
    x = 0.5 * torch.randn(2, 9, cfg.d_model, generator=g)
    positions = torch.arange(9)[None].expand(2, 9)
    got, _ = M.apply_block(p, kind, x, cfg, positions)
    close(got, REF.block(x, p, ref_kind, numbers(cfg)))


def test_the_whole_forward_matches_the_reference(model):
    cfg, params = model
    tokens = torch.randint(0, cfg.vocab_size, (2, 13),
                           generator=torch.Generator().manual_seed(4))
    got, _ = M.forward(params, cfg, tokens)
    close(got, REF.forward(params, numbers(cfg), tokens))


def test_prefill_then_decode_through_the_cache_matches_the_reference(model):
    """The engine's B=1 prefills and its chunked decode (prompts of 3, 6
    and 11 tokens: as long as the conv's tail and longer; a shorter
    prompt's tail lands where the JAX package puts it, ROADMAP Queue 3),
    every decode step's logits against the reference's full forward of
    the prompt and the tokens generated."""
    cfg, params = model
    eng = ServeEngine(cfg, params, batch_slots=3, max_len=32, chunk_size=4,
                      keep_logits=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 6, 11)]
    rids = [eng.submit(p, max_new_tokens=9) for p in prompts]
    results, chunks = {}, []
    while eng.has_work:  # the prefills and 2 chunks of 4 steps
        eng.step(results)
        chunks.append(eng.logits.clone())
    assert len(chunks) == 2
    c = numbers(cfg)
    for s, (rid, p) in enumerate(zip(rids, prompts)):
        seq = torch.from_numpy(np.concatenate([p, results[rid]]))
        want = REF.forward(params, c, seq[None, :-1])[0]
        got = torch.cat([chunk[s] for chunk in chunks])
        close(got, want[len(p):len(p) + 8])
        assert results[rid][1:] == got.argmax(-1).tolist()


def test_every_share_adds_up_to_the_uncut_layer(model):
    """Four chips' shares of a layer's 8 experts (2 each): their partial
    results, with the shared expert (which every chip computes alike)
    counted once, add up to the reference's uncut layer."""
    cfg, _ = model
    whole = dataclasses.replace(cfg, experts_held=(0, 8))
    p = M.init_model(whole, 1, "cpu")["blocks"][0]
    g = torch.Generator().manual_seed(6)
    h = apply_norm(p["norm2"], torch.randn(2, 7, cfg.d_model, generator=g),
                   cfg.norm, cfg.norm_eps)
    parts = []
    for lo in range(0, 8, 2):
        share = dataclasses.replace(cfg, experts_held=(lo, lo + 2))
        ps = dict(p["moe"], **{k: p["moe"][k][lo:lo + 2]
                               for k in ("w_gate", "w_up", "w_down")})
        parts.append(moe.apply_moe(ps, h, share)[0])
    got = sum(parts) + apply_mlp(p["mlp"], h, cfg)
    c, m = numbers(whole), p["mlp"]
    want = REF.moe(h, p["moe"], c) + REF.swiglu(h, m["wi_gate"], m["wi_up"],
                                                m["wo"])
    close(got, want)
    # one share alone is not the layer
    with pytest.raises(AssertionError):
        close(parts[0] + apply_mlp(p["mlp"], h, cfg), want)


def test_held_pairs_are_the_routed_pairs_held_here(model):
    cfg, params = model
    p = params["blocks"][0]["moe"]
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    counter = torch.zeros(1, dtype=torch.int64)
    moe.apply_moe(p, x, cfg, held_pairs=counter)
    moe.apply_moe(p, x, cfg, held_pairs=counter)
    moe.apply_moe(p, x, cfg)  # no counter given: nothing counted
    _, idx, _ = moe._router(x.reshape(-1, cfg.d_model), p["router"],
                            cfg.num_experts, cfg.num_experts_per_tok)
    lo, hi = cfg.experts_held
    assert int(counter) == 2 * int(((idx >= lo) & (idx < hi)).sum()) > 0


def test_a_chunk_records_its_spans_and_the_held_pairs(model):
    cfg, params = model
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=32, chunk_size=4)
    for n in (3, 5):
        eng.submit(np.arange(n) + 1, max_new_tokens=6)
    with trace.recording() as rec:
        eng.step()
    names = [s.name for s in rec.spans]
    assert names == ["serve.prefill"] * 2 + [
        "serve.chunk", "serve.upload", "serve.replay", "serve.download"]
    chunk = names.index("serve.chunk")
    assert all(s.parent == chunk for s in rec.spans[chunk + 1:])
    (counter,) = rec.counters
    assert counter.name == "moe.held_pairs" and counter.span == chunk
    assert counter.values == (eng.held_pairs,) and eng.held_pairs > 0
    eng.step()  # recording off: nothing kept, the count still read
    assert eng.held_pairs > 0


def test_the_two_reference_copies_forward_bit_equal(model):
    cfg, params = model
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(8))
    at = torch.tensor([[3, 11], [0, 7]])
    c = numbers(cfg)
    for rnd in (None, BENCH.fp8):
        a = REF.forward(params, c, tokens, at, rnd)
        b = BENCH.forward(params, c, tokens, at, rnd)
        assert torch.equal(a, b)
    assert not torch.equal(REF.forward(params, c, tokens),
                           REF.forward(params, c, tokens, rnd=BENCH.fp8))


@pytest.mark.parametrize("name", ["yi-6b", "mamba2-2.7b", "mixtral-8x7b"])
def test_the_new_settings_at_their_defaults_change_nothing(name):
    """A ``PortConfig`` with every new setting at its default gives the
    ``ModelConfig``'s logits bit for bit."""
    cfg = reduced(get_config(name))
    port = PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)})
    params = M.init_model(cfg, 0, "cpu")
    assert torch.equal(M.init_model(port, 0, "cpu")["embed"]["table"],
                       params["embed"]["table"])
    tokens = torch.randint(0, cfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(9))
    want, _ = M.forward(params, cfg, tokens)
    got, _ = M.forward(params, port, tokens)
    assert torch.equal(got, want)
