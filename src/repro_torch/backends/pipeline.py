"""Pipeline backend ``torch-pipeline``: stages over rank processes.

Counterpart of ``shardmap-pipeline``.  A pipeline schedule is a sweep task
graph: column = stage, timestep = clock tick, and the only cross-column
dependence reaches *left* — the activation arriving from the previous
stage.  This backend runs any such graph with one column block per rank
of a ``stage`` axis and the activation moved stage to stage by a
one-directional ppermute that does not wrap (``CommPlan`` mode ``ring``):
the point-to-point send a pipelined runtime would issue, with no reverse
link and no gather.

Because the planning is shared, graphs whose dependencies also reach
right fall back to the plan's ``halo`` exchange, and wide patterns to
``allgather``, so the backend runs every pattern.  ``run_many`` and
``comm_overlap=True`` are ``PlannedSPMDBackend``'s: every pipeline
advances one clock tick per loop step, and with overlap the transfer for
tick t+1 is posted right after tick t's stage body.
"""
from __future__ import annotations

from .base import register_backend
from .csp import PlannedSPMDBackend

AXIS = "stage"


@register_backend("torch-pipeline")
class PipelineBackend(PlannedSPMDBackend):
    paradigm = "pipeline stages over rank processes (ppermute ring)"
    axis = AXIS
    prefer_ring = True
