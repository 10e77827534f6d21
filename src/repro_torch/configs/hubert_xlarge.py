"""HuBERT X-Large [arXiv:2106.07447]: encoder-only audio transformer.

Backbone only: the conv waveform frontend is a stub — input_specs()
provides precomputed frame embeddings.  Masked-unit prediction over 504
k-means targets; no decode shapes (encoder-only)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,        # k-means cluster units; replicated head (tiny)
    causal=False,
    mlp_gated=False,
    act="gelu",
    norm="layer",
    frontend="audio",
    supports_decode=False,
))
