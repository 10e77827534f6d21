"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L MoE 8e top-2, GQA kv=8, SWA."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("moe",),
    num_experts=8,
    num_experts_per_tok=2,
    ep_mode="sp",         # SP-aware EP: per-plane dispatch a2a / |model|
    window=4096,          # sliding-window attention (Mistral lineage)
    rope_theta=1e6,
    subquadratic=True,    # SWA bounds the KV working set -> long_500k runs
))
