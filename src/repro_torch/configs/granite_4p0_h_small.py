"""Granite 4.0-H Small [hf:ibm-granite/granite-4.0-h-small, config.json;
``granitemoehybrid``, 32B-A9B]: 40 layers in a period of 10, nine Mamba-2
mixers then one NoPE GQA attention (layers 5, 15, 25, 35), every layer
followed by 72 routed SwiGLU experts of width 768 (softmax top-10) beside
a shared SwiGLU of width 1536.  Embeddings times 12, each residual branch
times 0.22, logits over 16 through the tied table, attention scaled by
``attention_multiplier`` 1/128.

The port's configuration is one chip's expert-parallel share: experts 0-8
of each layer's 72 (eight chips share a layer), the router whole.  The SSD
chunk is 128, K6's largest (the published 256 changes no result).
"""
from .base import PortConfig, register

PERIOD = ("ssd_moe",) * 5 + ("moe",) + ("ssd_moe",) * 4

CONFIG = register(PortConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    block_pattern=PERIOD,
    position_embedding="nope",
    attention_scale=1.0 / 128,
    num_experts=72,
    num_experts_per_tok=10,
    dense_residual_ff=1536,   # the shared expert
    experts_held=(0, 9),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=128,
    ssm_conv_bias=True,
    tie_embeddings=True,
    norm_eps=1e-5,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    subquadratic=True,
))
