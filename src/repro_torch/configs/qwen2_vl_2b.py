"""Qwen2-VL-2B [arXiv:2409.12191]: M-RoPE, dynamic-resolution vision.

The transformer BACKBONE only (per assignment): the vision frontend is a
stub — input_specs() provides precomputed patch embeddings alongside text
tokens; M-RoPE with coincident position streams (text-only backbone)
reduces exactly to 1-D RoPE (see layers.apply_rope)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,          # not 16-divisible -> context-parallel fallback
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    mrope=True,
    frontend="vision",
    tie_embeddings=True,
))
