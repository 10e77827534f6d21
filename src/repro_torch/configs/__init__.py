"""Model configurations the port can build (a copy of ``repro.configs``).

The reference's ten: the two MoE models (Mixtral 8x7B and Arctic 480B),
the attention-free Mamba-2 stack, the RG-LRU + local-attention hybrid
RecurrentGemma-2B, the four dense attention models (Yi-6B, Qwen1.5-0.5B,
Qwen2-72B and Minitron-8B) and the two with a modality frontend, whose
inputs arrive as embeddings: the Qwen2-VL-2B text backbone and the
encoder-only HuBERT X-Large.  ``PORT_ARCHS`` are the port's own, which the
reference package lacks: Granite 4.0-H Small, Mamba-2 and NoPE attention
mixers each followed by routed and shared experts, at one chip's
expert-parallel share.
"""
from . import (  # noqa: F401
    arctic_480b,
    granite_4p0_h_small,
    hubert_xlarge,
    mamba2_2p7b,
    minitron_8b,
    mixtral_8x7b,
    qwen1p5_0p5b,
    qwen2_72b,
    qwen2_vl_2b,
    recurrentgemma_2b,
    yi_6b,
)
from .base import (
    SHAPES,
    InputShape,
    ModelConfig,
    PortConfig,
    config_names,
    get_config,
    reduced,
    shape_applicable,
)

ALL_ARCHS = [
    "mixtral-8x7b", "arctic-480b", "mamba2-2.7b", "recurrentgemma-2b",
    "yi-6b", "qwen1.5-0.5b", "qwen2-72b", "minitron-8b", "qwen2-vl-2b",
    "hubert-xlarge",
]
PORT_ARCHS = ["granite-4.0-h-small"]
