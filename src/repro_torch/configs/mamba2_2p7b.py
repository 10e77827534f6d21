"""Mamba-2 2.7B [arXiv:2405.21060]: attention-free SSD stack."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,      # not 16-divisible: embed dim picks up TP instead
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    tie_embeddings=True,
    subquadratic=True,
))
