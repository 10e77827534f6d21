"""Model configuration schema, registry, and assigned input shapes.

The port's copy of ``repro.configs.base`` (the port imports nothing of the
reference package); ``tests/test_torch_ssm.py`` holds it equal to the
original field by field.  The registry lists the reference's ten
configurations.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

_REGISTRY: Dict[str, "ModelConfig"] = {}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern, cycled over depth: entries from
    #   {"attn", "moe", "ssd", "rglru", "local_attn"}
    block_pattern: Tuple[str, ...] = ("attn",)
    # attention
    qkv_bias: bool = False
    window: Optional[int] = None        # sliding-window for "attn" blocks
    local_window: Optional[int] = None  # window for "local_attn" blocks
    rope_theta: float = 10000.0
    mrope: bool = False                 # Qwen2-VL multimodal RoPE flag
    causal: bool = True                 # False => encoder-only
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual_ff: int = 0          # Arctic: parallel dense MLP width
    # expert-parallel dispatch mode for the a2a path (models.moe):
    #   "replicated" — tokens replicated over `model`; dispatch a2a
    #                  duplicated per model plane
    #   "sp"         — SP-aware: each model plane all-to-alls only its
    #                  sequence shard (per-plane a2a volume / |model|)
    ep_mode: str = "replicated"
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # RG-LRU (RecurrentGemma/Griffin)
    lru_width: int = 0
    conv1d_width: int = 4
    # embeddings / head / mlp
    tie_embeddings: bool = False
    act: str = "silu"
    mlp_gated: bool = True
    norm: str = "rms"                   # rms | layer
    norm_eps: float = 1e-6
    # modality frontend stub (inputs arrive as embeddings)
    frontend: Optional[str] = None      # None | "vision" | "audio"
    # numerics / execution
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"    # huge-MoE configs drop to bfloat16
    remat: str = "full"                 # none | full | selective
    scan_layers: bool = True
    kernel_impl: str = "auto"           # kernels.ops dispatch
    moe_impl: str = "auto"
    # shape applicability
    supports_decode: bool = True        # False for encoder-only
    subquadratic: bool = False          # may run long_500k

    def pattern_for_depth(self) -> Tuple[str, ...]:
        """The concrete per-layer block kinds (len == num_layers)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def params_dense(self) -> int:
        """Rough non-embedding dense param count (for 6ND roofline)."""
        return _count_params(self, active_only=False)

    @property
    def params_active(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        return _count_params(self, active_only=True)


@dataclass(frozen=True)
class PortConfig(ModelConfig):
    """A ``ModelConfig`` with settings the reference's schema lacks; at
    their defaults it behaves as the ``ModelConfig`` would.  The model code
    reads them with those defaults from either class."""
    position_embedding: str = "rope"    # rope | nope (no positions at all)
    attention_scale: Optional[float] = None  # None: 1/sqrt(head_dim)
    # the experts [lo, hi) this chip holds of ``num_experts`` (the router
    # stays num_experts wide); None: all of them
    experts_held: Optional[Tuple[int, int]] = None
    ssm_conv_bias: bool = False
    # Granite's scalings: the embeddings times, each residual branch
    # times, the logits divided by
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d, f = cfg.d_model, cfg.d_ff
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    total = 2 * cfg.vocab_size * d if not cfg.tie_embeddings else cfg.vocab_size * d
    for kind in cfg.pattern_for_depth():
        if kind in ("attn", "local_attn", "moe"):
            total += d * (H + 2 * Hkv) * Dh + H * Dh * d  # qkvo
        if kind == "attn" or kind == "local_attn":
            total += 3 * d * f if cfg.mlp_gated else 2 * d * f
        elif kind in ("moe", "ssd_moe"):
            held = getattr(cfg, "experts_held", None)
            e = cfg.num_experts_per_tok if active_only else (
                cfg.num_experts if held is None else held[1] - held[0])
            total += e * 3 * d * f
            if cfg.dense_residual_ff:
                total += 3 * d * cfg.dense_residual_ff
        if kind in ("ssd", "ssd_moe"):
            d_in = cfg.ssm_expand * d
            ng, st = cfg.ssm_ngroups, cfg.ssm_state
            total += d * (2 * d_in + 2 * ng * st + d_in // cfg.ssm_headdim)
            total += d_in * d
        elif kind == "rglru":
            w = cfg.lru_width or d
            total += 2 * d * w + w * d + 3 * w  # in x2, out, gates
            total += 3 * d * f if cfg.mlp_gated else 2 * d * f
    return total


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401  (triggers registration imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def config_names():
    from . import ALL_ARCHS  # noqa: F401

    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, seq_ok: bool = True) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests (one fwd/train step)."""
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, 2 * len(cfg.block_pattern)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        scan_layers=cfg.scan_layers,
        window=min(cfg.window, 64) if cfg.window else None,
        local_window=min(cfg.local_window, 32) if cfg.local_window else None,
    )
    if cfg.num_experts:
        changes.update(num_experts=4, num_experts_per_tok=2)
    if cfg.dense_residual_ff:
        changes.update(dense_residual_ff=128)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.lru_width:
        changes.update(lru_width=128)
    if getattr(cfg, "experts_held", None) is not None:
        # one period of the pattern; 2 of 8 experts held, top-3
        changes.update(num_layers=len(cfg.block_pattern), num_experts=8,
                       num_experts_per_tok=3, experts_held=(0, 2))
    new = replace(cfg, **changes)
    object.__setattr__(new, "_registered", False)
    return new


# ------------------------------------------------------- assigned shapes
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "long_decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.kind in ("decode", "long_decode") and not cfg.supports_decode:
        return False, "encoder-only: no decode step"
    if shape.kind == "long_decode" and not cfg.subquadratic:
        return False, "full quadratic attention: long_500k out of scope"
    return True, ""
