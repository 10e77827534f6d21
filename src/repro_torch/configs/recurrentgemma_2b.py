"""RecurrentGemma-2B / Griffin [arXiv:2402.19427]: RG-LRU + local attention,
2 recurrent blocks per 1 local-attention block; GQA kv=1 (MQA)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,          # not 16-divisible -> context-parallel fallback
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    lru_width=2560,
    act="gelu",
    scan_layers=False,     # heterogeneous 3-block period, 26 layers: unroll
    subquadratic=True,
))
