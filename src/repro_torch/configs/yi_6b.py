"""Yi-6B [arXiv:2403.04652]: llama-arch GQA kv=4."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
))
