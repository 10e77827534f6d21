"""Model configurations the port can build (a copy of ``repro.configs``).

Listed: the attention-free Mamba-2 stack, the RG-LRU + local-attention
hybrid RecurrentGemma-2B and the four dense attention models (Yi-6B,
Qwen1.5-0.5B, Qwen2-72B and Minitron-8B).  The other configurations of
the reference need the MoE block or a modality frontend, which later
slices of the port bring.
"""
from . import (mamba2_2p7b, minitron_8b, qwen1p5_0p5b,  # noqa: F401
               qwen2_72b, recurrentgemma_2b, yi_6b)
from .base import (
    SHAPES,
    InputShape,
    ModelConfig,
    config_names,
    get_config,
    reduced,
    shape_applicable,
)

ALL_ARCHS = ["mamba2-2.7b", "recurrentgemma-2b", "yi-6b", "qwen1.5-0.5b",
             "qwen2-72b", "minitron-8b"]
