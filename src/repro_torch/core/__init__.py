"""Task Bench core, the port's own copy of the numpy-only ``repro.core``.

- graph: 2-D iteration space + dependence relation + self-validating body
- patterns: trivial/stencil/fft/sweep/tree/random/nearest/spread relations
- kernel_spec / kernel_ref: compute- and memory-bound task kernels
- metg: minimum-effective-task-granularity metric (paper §IV) —
  re-exported from ``bench.metg``, where measurement lives
- schedule: wavefront scheduling models (static ownership vs work
  stealing), shared by the host executor and the synthetic fake clock
- validate: numpy oracle executor + backend output checks

The port imports nothing of the reference package; the tests hold these
copies equal to it.
"""
from .graph import CHECKSUM_MOD, TaskGraph, make_graph, replicate
from .kernel_spec import KernelSpec
from .metg import METGResult, SweepPoint, compute_metg, geometric_iterations, run_sweep
from .patterns import get_pattern, pattern_names
from .schedule import static_owners, steal_schedule, wavefront_makespan
from .validate import check_multi, check_outputs, execute_reference

__all__ = [
    "CHECKSUM_MOD",
    "TaskGraph",
    "make_graph",
    "replicate",
    "KernelSpec",
    "METGResult",
    "SweepPoint",
    "compute_metg",
    "geometric_iterations",
    "run_sweep",
    "get_pattern",
    "pattern_names",
    "static_owners",
    "steal_schedule",
    "wavefront_makespan",
    "check_multi",
    "check_outputs",
    "execute_reference",
]
