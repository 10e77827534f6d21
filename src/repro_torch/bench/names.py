"""The reference's backend names and the port's.

The port registers its backends under names of its own, so its
``BENCH_*.json`` and ``TUNE_*.json`` never collide with the reference's
(whose ``auto`` planner already has artifacts).  This is the one table
that pairs them; a port artifact equals the reference's with its names
mapped through it.
"""
from __future__ import annotations

from typing import Dict

from ..backends.base import canonical_backend_spec, parse_backend_spec

PORT_NAMES: Dict[str, str] = {
    "xla-scan": "torch-scan",
    "xla-static": "cuda-graph",
    "host-dynamic": "torch-host",
    "pallas-fused": "cuda-fused",
    "shardmap-csp": "torch-csp",
    "shardmap-pipeline": "torch-pipeline",
    "auto": "torch-auto",
}


def port_spec(spec: str) -> str:
    """A reference backend spec with its name mapped, options kept:
    ``shardmap-csp[comm=onesided]`` -> ``torch-csp[comm=onesided]``."""
    base, _ = parse_backend_spec(spec)
    return canonical_backend_spec(PORT_NAMES[base] + spec[len(base):])


def port_label(name: str) -> str:
    """A dotted scenario name or label with every part that is a
    reference backend spec mapped: ``metg.xla-scan.stencil`` ->
    ``metg.torch-scan.stencil``."""
    return ".".join(port_spec(part) if part.split("[")[0] in PORT_NAMES
                    else part for part in name.split("."))
