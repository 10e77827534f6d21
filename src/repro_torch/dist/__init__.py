"""Multi-rank layer of the port: communication planning.

- collectives: ``CommPlan`` and ``plan_comm``, the numpy planning half of
  the reference's ``repro.dist.collectives`` (placement, padding of ragged
  widths, per-pair slot layout, the one-sided put schedule)
"""
from .collectives import (MODES, CommPlan, dependency_reach,
                          directional_reach, plan_comm)

__all__ = [
    "MODES",
    "CommPlan",
    "dependency_reach",
    "directional_reach",
    "plan_comm",
]
