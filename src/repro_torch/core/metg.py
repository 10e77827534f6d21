"""METG metric — re-export of ``bench.metg``.

The port's copy of the reference's ``repro.core.metg`` shim: the metric
math lives in ``repro_torch.bench.metg`` with the rest of the measurement
layer, and this module keeps the ``repro_torch.core.metg`` /
``repro_torch.core`` import surface the reference offers.
"""
from __future__ import annotations

from ..bench.metg import (METGResult, SweepPoint, compute_metg,
                          efficiency_curve, geometric_iterations, run_sweep,
                          time_run)

__all__ = [
    "METGResult",
    "SweepPoint",
    "compute_metg",
    "efficiency_curve",
    "geometric_iterations",
    "run_sweep",
    "time_run",
]
