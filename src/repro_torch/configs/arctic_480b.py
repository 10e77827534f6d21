"""Snowflake Arctic [hf:Snowflake/snowflake-arctic-base]: 35L, 128e top-2
MoE + dense residual MLP; 56 heads (not 16-divisible -> context-parallel
attention via the sharding fallback); bf16 optimizer state for memory."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=("moe",),
    num_experts=128,
    num_experts_per_tok=2,
    dense_residual_ff=4864,   # dense MLP in parallel with the MoE branch
    opt_state_dtype="bfloat16",
))
