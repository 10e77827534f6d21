"""Multi-rank layer of the port: communication planning and rank processes.

- collectives: ``CommPlan`` and ``plan_comm``, a copy of the reference's
  ``repro.dist.collectives`` planning (placement, padding of ragged
  widths, per-pair slot layout, the one-sided put schedule), and its
  runtime half (``CommPlan.exchange``, ``onesided_push``/``onesided_wait``)
  run on a rank with that rank's communicator, and the MoE token
  all-to-all (``TokenA2APlan``, ``dispatch_capacity``)
- ranks: ``RankPool``, N rank processes in one gloo group and the
  controller's channel to them (the counterpart of a mesh axis plus
  ``shard_map``), and ``RankComm``, a rank's communicator, which stages
  every exchanged tensor through host buffers; ``RankComm.grid`` gives
  its communicators over the axes of a ``(data, model)`` grid
  (``GridComm``)
- compression: int8 error-feedback gradient compression on one device
  (``ef_compress``), which AdamW's ``compression="int8_ef"`` runs
"""
from .collectives import (MODES, CommPlan, TokenA2APlan, dependency_reach,
                          directional_reach, dispatch_capacity, plan_comm)
from .ranks import GridComm, RankComm, RankError, RankPool, get_pool

__all__ = [
    "MODES",
    "CommPlan",
    "dependency_reach",
    "directional_reach",
    "plan_comm",
    "TokenA2APlan",
    "dispatch_capacity",
    "GridComm",
    "RankComm",
    "RankError",
    "RankPool",
    "get_pool",
]
