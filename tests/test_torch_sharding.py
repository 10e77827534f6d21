"""The port's logical-axis trees and sharding rules against the reference.

- the axes tree and every parameter's shape and dtype of ``model_spec``
  equal the reference's (``jax.eval_shape`` of its ``init_model``, split
  by its ``split_leaves``), for all ten configs;
- every leaf's ``spec_for`` equals the reference's over the parameters,
  the AdamW state, the caches at ``decode_32k`` and the batch, on the
  single- and multi-pod production meshes with and without a ``stage``
  axis, in both strategies (plain-dict meshes, one case per config);
- the nine cases of ``tests/test_sharding.py``, on the port;
- a ``("pod", "data")`` tuple on a fake (2, 2, 2) mesh gives each rank
  the shard JAX gives its device (the reference's side in a child process
  with 8 host devices);
- the reduced ``yi-6b`` forward under ``use_rules`` on 4 gloo CPU ranks,
  a (2, 2) mesh, within SHARDED_TOL of the unsharded logits;
- ``constrain``, ``constrain_stage_stack`` and ``use_rules`` outside and
  inside a rules context.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as rcfg  # noqa: E402
from repro.dist import sharding as RS  # noqa: E402
from repro.launch import mesh as RMESH  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import split_leaves as ref_split  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import train_step as RTS  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.dist import pipeline as TPP  # noqa: E402
from repro_torch.dist import sharding as TS  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import Leaf, is_leaf, split_leaves  # noqa: E402
from repro_torch.train import train_step as TTS  # noqa: E402

# the sharded forward's float32 logits against the unsharded ones: partial
# sums over the model axis add in another order
SHARDED_TOL = 1e-5
MESHES = [(mp, st) for mp in (False, True) for st in (1, 4)]
STRATEGIES = ["tp+fsdp+sp", "dp_only"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_mesh(**shape):
    return SimpleNamespace(shape=shape)


def walk(tree, path=""):
    """[(path, leaf)] of a tree of dicts, lists and dataclasses, an axes
    tuple or a tensor (or a shape struct) a leaf."""
    if tree is None or isinstance(tree, str):
        return []
    if isinstance(tree, tuple) and all(isinstance(e, (str, type(None)))
                                       for e in tree):
        return [(path, tree)]
    if hasattr(tree, "shape"):
        return [(path, tree)]
    if dataclasses.is_dataclass(tree):
        return [kv for f in dataclasses.fields(tree)
                for kv in walk(getattr(tree, f.name), f"{path}.{f.name}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in walk(tree[k],
                                                        f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in walk(v,
                                                              f"{path}[{i}]")]
    return [(path, tree)]


def dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def described(values, axes):
    """{path: (shape, dtype, axes)} of a value tree and its axes tree."""
    vals, axs = dict(walk(values)), dict(walk(axes))
    assert vals.keys() == axs.keys()
    return {k: (tuple(v.shape), dtype_name(v.dtype), tuple(axs[k]))
            for k, v in vals.items()}


@functools.lru_cache(maxsize=None)
def ref_model(name: str):
    tree = jax.eval_shape(functools.partial(RM.init_model,
                                            cfg=rcfg.get_config(name)),
                          jax.random.PRNGKey(0))
    return ref_split(tree)


@pytest.mark.parametrize("name", rcfg.ALL_ARCHS)
def test_model_spec_axes_and_shapes_equal_the_reference(name):
    params, axes = TM.model_spec(tcfg.get_config(name))
    assert all(t.is_meta for t in TM.T.leaves(params))
    assert described(params, axes) == described(*ref_model(name))


def _specs(rules, values, axes):
    return {k: tuple(rules.spec_for(ax, tuple(values_k.shape)))
            for (k, ax), (_, values_k) in zip(walk(axes), walk(values))}


def _ref_specs(rules, values, axes):
    vals = dict(walk(values))
    return {k: tuple(rules.spec_for(ax, vals[k].shape))
            for k, ax in walk(axes)}


def _cache_leaves(caches, axes):
    """{(layer, field): (shape, axes)} of caches (a list, or one stacked
    cache) by field name: the two packages' LayerCache differ in field
    order and in the port's ``start``."""
    cs = caches if isinstance(caches, list) else [caches]
    ax = axes if isinstance(axes, list) else [axes]
    out = {}
    for i, (c, a) in enumerate(zip(cs, ax)):
        for f in ("k", "v", "pos", "conv_x", "conv_bc", "state", "conv", "h"):
            t, fa = getattr(c, f, None), getattr(a, f, None)
            if t is not None:
                out[(i, f)] = (tuple(t.shape), tuple(fa))
    return out


@pytest.mark.parametrize("name", rcfg.ALL_ARCHS)
def test_every_leaf_spec_equals_the_reference(name):
    rc, pc = rcfg.get_config(name), tcfg.get_config(name)
    ref_params, ref_axes = ref_model(name)
    params, axes = TM.model_spec(pc)
    state, state_axes = TSP.state_struct(pc, TTS.TrainConfig())
    ref_state = RTS.TrainState(step=None, params=ref_params,
                               opt=jax.eval_shape(
                                   lambda p: radamw.init(
                                       p, RTS.TrainConfig().adamw),
                                   ref_params))
    ref_state_axes = RTS.TrainState(
        step=(), params=ref_axes,
        opt=radamw.state_logical_axes(ref_state.opt, ref_axes))
    shape = rcfg.SHAPES["decode_32k"]
    batch, batch_axes = TSP.batch_struct(pc, tcfg.SHAPES["train_4k"])
    ref_batch, ref_batch_axes = RSP.batch_struct(rc, rcfg.SHAPES["train_4k"])
    caches = ref_caches = None
    if rcfg.shape_applicable(rc, shape)[0]:
        caches, cache_axes = TSP.caches_struct(pc, shape.global_batch,
                                               shape.seq_len)
        ref_caches, ref_cache_axes = RSP.caches_struct(
            rc, shape.global_batch, shape.seq_len)
        assert _cache_leaves(caches, cache_axes) == \
            _cache_leaves(ref_caches, ref_cache_axes)
    for mp, stages in MESHES:
        shp, names = TMESH.production_mesh_spec(multi_pod=mp,
                                                pipeline_stages=stages)
        assert (shp, names) == RMESH.production_mesh_spec(
            multi_pod=mp, pipeline_stages=stages)
        sizes = dict(zip(names, shp))
        for strategy in STRATEGIES:
            tr = TS.make_rules(fake_mesh(**sizes), strategy)
            rr = RS.make_rules(fake_mesh(**sizes), strategy)
            assert _specs(tr, params, axes) == \
                _ref_specs(rr, ref_params, ref_axes)
            got_opt = _specs(tr, state.opt, state_axes.opt)
            want_opt = _ref_specs(rr, ref_state.opt, ref_state_axes.opt)
            assert {k: v for k, v in got_opt.items() if ".step" not in k} \
                == {k: v for k, v in want_opt.items() if ".step" not in k}
            assert _specs(tr, batch, batch_axes) == \
                _ref_specs(rr, ref_batch, ref_batch_axes)
            if caches is not None:
                got = {k: tuple(tr.spec_for(a, s)) for k, (s, a)
                       in _cache_leaves(caches, cache_axes).items()}
                want = {k: tuple(rr.spec_for(a, s)) for k, (s, a)
                        in _cache_leaves(ref_caches, ref_cache_axes).items()}
                assert got == want


# ----------------------------------------- tests/test_sharding.py, ported
def rules_for(**shape):
    return TS.make_rules(fake_mesh(**shape))


SHARDING_CASES = {
    "basic_tp_fsdp": (dict(data=16, model=16), "tp+fsdp+sp", [
        (("embed", "heads", "head_dim"), (4096, 32, 128),
         P("data", "model", None)),
        (("embed", "ffn"), (4096, 14336), P("data", "model"))]),
    "heads_fallback_when_indivisible": (dict(data=16, model=16),
                                        "tp+fsdp+sp", [
        (("embed", "heads", "head_dim"), (7168, 56, 128),
         P("data", None, None))]),
    "vocab_fallback_mamba": (dict(data=16, model=16), "tp+fsdp+sp", [
        (("vocab", "embed"), (50280, 2560), P(None, "data"))]),
    "kv_heads_replicate_when_small": (dict(data=16, model=16),
                                      "tp+fsdp+sp", [
        (("embed", "kv_heads", "head_dim"), (4096, 8, 128),
         P("data", None, None)),
        (("embed", "kv_heads", "head_dim"), (1024, 16, 64),
         P("data", "model", None))]),
    "multipod_batch_axes": (dict(pod=2, data=16, model=16), "tp+fsdp+sp", [
        (("batch", "seq"), (256, 4096), P(("pod", "data"), "model")),
        (("embed", "ffn"), (8192, 29568), P(("pod", "data"), "model"))]),
    "batch_one_replicates": (dict(pod=2, data=16, model=16), "tp+fsdp+sp", [
        (("batch", None), (1, 1), P(None, None))]),
    "expert_sharding": (dict(data=16, model=16), "tp+fsdp+sp", [
        (("expert", "expert_embed", "expert_ffn"), (128, 7168, 304),
         P("data", None, "model")),
        (("expert", "expert_embed", "expert_ffn"), (16, 4096, 7168),
         P("data", None, "model"))]),
    "dp_only_strategy": (dict(data=16, model=16), "dp_only", [
        (("embed", "ffn"), (4096, 14336), P(None, None)),
        (("batch", "seq"), (256, 4096), P("data", None))]),
}


@pytest.mark.parametrize("case", sorted(SHARDING_CASES) + ["axis_used_once"])
def test_sharding_cases_of_the_reference(case):
    if case == "axis_used_once":
        r = rules_for(data=16, model=16)
        rules = dict(r.rules)
        rules["x1"] = ["model"]
        rules["x2"] = ["model", "data"]
        rr = TS.ShardingRules(mesh=fake_mesh(data=16, model=16), rules=rules)
        assert tuple(rr.spec_for(("x1", "x2"), (32, 32))) == \
            tuple(P("model", "data"))
        return
    shape, strategy, checks = SHARDING_CASES[case]
    r = TS.make_rules(fake_mesh(**shape), strategy)
    ref = RS.make_rules(fake_mesh(**shape), strategy)
    for axes, dims, want in checks:
        got = r.spec_for(axes, dims)
        assert isinstance(got, TS.PartitionSpec)
        assert tuple(got) == tuple(want) == tuple(ref.spec_for(axes, dims))


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        TS.make_rules(fake_mesh(data=2), "nope")


def test_leaf_split_and_stacked_axes():
    tree = {"a": Leaf(torch.zeros(2, 3), ("embed", "ffn")),
            "b": [Leaf(torch.ones(4), ("embed2",))], "c": None}
    params, axes = split_leaves(tree)
    assert is_leaf(tree["a"]) and not is_leaf(params["a"])
    assert axes == {"a": ("embed", "ffn"), "b": [("embed2",)], "c": None}
    assert torch.equal(params["b"][0], torch.ones(4))
    cfg = tcfg.reduced(tcfg.get_config("yi-6b"))
    _, ax = TM.model_spec(cfg)
    assert ax["blocks_scanned"]["attn"]["wq"] == (
        "layers", "embed", "heads", "head_dim")


def test_init_model_is_unchanged_by_the_leaves():
    """``init_model`` returns plain tensors, the bits of the Leaf tree's."""
    cfg = tcfg.reduced(tcfg.get_config("recurrentgemma-2b"))
    plain = TM.init_model(cfg, 3, "cpu")
    values, _ = split_leaves(TM.init_model_leaves(cfg, 3, "cpu"))
    a, b = TM.T.flatten(plain), TM.T.flatten(values)
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_model_spec_of_the_largest_configs_is_quick():
    import time

    for name in ("arctic-480b", "qwen2-72b"):
        t0 = time.perf_counter()
        params, _ = TM.model_spec(tcfg.get_config(name))
        assert time.perf_counter() - t0 < 1.0
        assert sum(t.numel() for t in TM.T.leaves(params)) > 7e10


def test_constrain_is_the_identity_outside_rules():
    x = torch.randn(2, 3)
    assert TS.active_rules() is None
    assert TS.constrain(x, "batch", None) is x
    pp = {"blocks_scanned": {"w": torch.randn(2, 3, 4)}, "embed": x}
    out = TPP.constrain_stage_stack(pp)
    assert out["blocks_scanned"]["w"] is pp["blocks_scanned"]["w"]
    assert TPP.constrain_stage_stack({"embed": x}) == {"embed": x}
    r = rules_for(data=2)
    with TS.use_rules(r) as got:
        assert TS.active_rules() is got is r
    assert TS.active_rules() is None


def test_meshes_need_a_process_group_of_their_size():
    with pytest.raises(RuntimeError, match="none is started"):
        TMESH.make_debug_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        TMESH.make_production_mesh(device="cpu")


# ------------------------------------------ tuple shards: JAX's and DTensor's
JAX_SHARDS = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
x = np.arange(8 * 4 * 2, dtype=np.float32).reshape(8, 4, 2)
out = {}
for name, spec in (("batch", P(("pod", "data"), None, None)),
                   ("batch_model", P(("pod", "data"), "model", None))):
    a = jax.device_put(x, NamedSharding(mesh, spec))
    out[name] = {str(s.device.id): np.asarray(s.data).tolist()
                 for s in a.addressable_shards}
print(json.dumps(out))
"""


def test_tuple_shards_match_jax_rank_by_rank():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = json.loads(subprocess.run(
        [sys.executable, "-c", JAX_SHARDS], env=env, capture_output=True,
        text=True, check=True, timeout=300).stdout.strip().splitlines()[-1])
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    x = torch.arange(8 * 4 * 2, dtype=torch.float32).reshape(8, 4, 2)
    specs = {"batch": ("batch", None, None),
             "batch_model": ("batch", "act_heads", None)}
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            mesh = TMESH.make_debug_mesh((2, 2, 2), ("pod", "data", "model"),
                                         device="cpu")
            rules = TS.make_rules(mesh)
            for name, axes in specs.items():
                assert tuple(rules.spec_for(axes, x.shape))[0] == \
                    ("pod", "data")
                got = TSP.place(x, axes, rules).to_local()
                assert got.tolist() == ref[name][str(rank)], (name, rank)
        finally:
            dist.destroy_process_group()


def test_placements_refuse_a_tuple_out_of_the_mesh_order():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        TS.placements(mesh, (("data", "pod"), None))


# ------------------------------------------ the sharded forward, 4 gloo ranks
def _rank_sharded_forward(ctx, cfg, tokens):
    from torch.distributed.tensor.experimental import implicit_replication

    mesh = TMESH.make_debug_mesh((2, 2), ("data", "model"), device="cpu")
    rules = TS.make_rules(mesh)
    params, axes = split_leaves(TM.init_model_leaves(cfg, 0, "cpu"))
    placed = TSP.place(params, axes, rules)
    tok = TSP.place(tokens, ("batch", "seq"), rules)
    with TS.use_rules(rules), implicit_replication(), torch.no_grad():
        logits, _ = TM.forward(placed, cfg, tok)
        spec = tuple(rules.spec_for(("batch", "seq", "vocab_out"),
                                    logits.shape))
        return logits.full_tensor(), spec, [
            (type(p).__name__, getattr(p, "dim", None))
            for p in logits.placements]


def test_sharded_forward_matches_the_unsharded_logits():
    from repro_torch.dist.ranks import get_pool

    cfg = tcfg.reduced(tcfg.get_config("yi-6b"))
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (8, 16)).astype(np.int64))
    with torch.no_grad():
        want, _ = TM.forward(TM.init_model(cfg, 0, "cpu"), cfg, tokens)
    pool = get_pool(4, torch.device("cpu"))
    got = pool.map(_rank_sharded_forward, [(cfg, tokens)] * 4)
    for logits, spec, place in got:
        # the sequence takes the model axis first; the vocab replicates
        assert spec == ("data", "model", None)
        assert place == [("Shard", 0), ("Shard", 1)]
        err = float((logits - want).abs().max())
        assert err <= SHARDED_TOL * max(float(want.abs().max()), 1.0), err
