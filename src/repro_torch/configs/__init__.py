"""Model configurations the port can build (a copy of ``repro.configs``).

Listed: the two MoE models (Mixtral 8x7B and Arctic 480B), the
attention-free Mamba-2 stack, the RG-LRU + local-attention hybrid
RecurrentGemma-2B and the four dense attention models (Yi-6B,
Qwen1.5-0.5B, Qwen2-72B and Minitron-8B).  The other configurations of
the reference need a modality frontend, which a later slice of the port
brings.
"""
from . import (arctic_480b, mamba2_2p7b, minitron_8b,  # noqa: F401
               mixtral_8x7b, qwen1p5_0p5b, qwen2_72b, recurrentgemma_2b,
               yi_6b)
from .base import (
    SHAPES,
    InputShape,
    ModelConfig,
    config_names,
    get_config,
    reduced,
    shape_applicable,
)

ALL_ARCHS = ["mixtral-8x7b", "arctic-480b", "mamba2-2.7b",
             "recurrentgemma-2b", "yi-6b", "qwen1.5-0.5b", "qwen2-72b",
             "minitron-8b"]
