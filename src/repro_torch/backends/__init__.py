"""Execution backends of the port — the 'n systems' axis of the paper.

| backend    | reference     | schedule              | dispatch cost   |
|------------|---------------|-----------------------|-----------------|
| torch-scan | xla-scan      | eager timestep loop   | O(ops) per step |
| cuda-fused | pallas-fused  | in-kernel, one launch | O(1) per GRAPH  |

Every backend runs every graph (pattern x kernel x payload x imbalance)
unchanged and is validated against the numpy oracle in ``core.validate``.
The registry is the port's own (``base._BACKENDS``).
"""
from .base import (Backend, StackedProgramBackend, backend_names,
                   backend_option_signature, get_backend, parse_backend_spec,
                   register_backend, resolve_device)
from .megakernel import MegakernelBackend
from .scanvec import ScanBackend

__all__ = [
    "Backend",
    "StackedProgramBackend",
    "backend_names",
    "backend_option_signature",
    "get_backend",
    "parse_backend_spec",
    "register_backend",
    "resolve_device",
    "MegakernelBackend",
    "ScanBackend",
]
