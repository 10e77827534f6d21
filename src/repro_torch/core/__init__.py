"""Task Bench core, the port's own copy of the numpy-only ``repro.core``.

- graph: 2-D iteration space + dependence relation + self-validating body
- patterns: trivial/stencil/fft/sweep/tree/random/nearest/spread relations
- kernel_spec / kernel_ref: compute- and memory-bound task kernels
- validate: numpy oracle executor + backend output checks

The port imports nothing of the reference package; the tests hold these
copies equal to it.
"""
from .graph import CHECKSUM_MOD, TaskGraph, make_graph, replicate
from .kernel_spec import KernelSpec
from .patterns import get_pattern, pattern_names
from .validate import check_multi, check_outputs, execute_reference

__all__ = [
    "CHECKSUM_MOD",
    "TaskGraph",
    "make_graph",
    "replicate",
    "KernelSpec",
    "get_pattern",
    "pattern_names",
    "check_multi",
    "check_outputs",
    "execute_reference",
]
