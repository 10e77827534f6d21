"""Execution backends of the port — the 'n systems' axis of the paper.

| backend        | reference         | schedule                   | dispatch cost              |
|----------------|-------------------|----------------------------|----------------------------|
| torch-host     | host-dynamic      | host loop, per task        | O(ops) per TASK            |
| torch-scan     | xla-scan          | eager timestep loop        | O(ops) per step            |
| cuda-graph     | xla-static        | unrolled, captured once    | O(1) host launches per RUN |
| cuda-fused     | pallas-fused      | in-kernel, one launch      | O(1) per GRAPH             |
| torch-csp      | shardmap-csp      | rank processes, msgs/step  | O(ops) per step per rank   |
| torch-pipeline | shardmap-pipeline | rank processes, ring/step  | O(ops) per step per rank   |
| torch-auto     | auto              | table-driven (the planner) | delegated                  |

Every backend runs every graph (pattern x kernel x payload x imbalance)
unchanged and is validated against the numpy oracle in ``core.validate``.
The registry is the port's own (``base._BACKENDS``).
"""
from .base import (Backend, StackedProgramBackend, backend_names,
                   backend_option_signature, canonical_backend_spec,
                   get_backend, parse_backend_spec, register_backend,
                   resolve_device, with_options)
from .auto import AutoBackend
from .csp import CSPBackend, PlannedSPMDBackend
from .dataflow import DataflowBackend
from .host import HostBackend
from .megakernel import MegakernelBackend
from .pipeline import PipelineBackend
from .scanvec import ScanBackend

__all__ = [
    "Backend",
    "StackedProgramBackend",
    "backend_names",
    "backend_option_signature",
    "canonical_backend_spec",
    "get_backend",
    "parse_backend_spec",
    "register_backend",
    "resolve_device",
    "with_options",
    "AutoBackend",
    "CSPBackend",
    "DataflowBackend",
    "HostBackend",
    "MegakernelBackend",
    "PipelineBackend",
    "PlannedSPMDBackend",
    "ScanBackend",
]
