"""Minitron-8B [arXiv:2407.14679]: pruned Nemotron, 256k vocab, GQA kv=8.

Nemotron lineage: squared-ReLU non-gated MLP; head_dim 128 (d/H=128)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    mlp_gated=False,
    act="gelu",
))
