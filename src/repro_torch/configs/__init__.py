"""Model configurations the port can build (a copy of ``repro.configs``).

Only the attention-free Mamba-2 stack is listed: the other configurations
of the reference need attention (K5), RG-LRU or MoE blocks, which later
slices of the port bring.
"""
from . import mamba2_2p7b  # noqa: F401
from .base import (
    SHAPES,
    InputShape,
    ModelConfig,
    config_names,
    get_config,
    reduced,
    shape_applicable,
)

ALL_ARCHS = ["mamba2-2.7b"]
