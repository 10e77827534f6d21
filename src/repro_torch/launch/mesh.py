"""Mesh arithmetic of the port (a copy of the device-free part of
``repro.launch.mesh``)."""
from __future__ import annotations


def moe_dispatch_planes(mesh_shape, ep_mode: str) -> int:
    """How many identical copies of the MoE dispatch all-to-all run
    concurrently over the ``model`` axis.

    ``replicated`` tokens duplicate the dispatch per model plane
    (|model| copies of the same a2a); SP-aware EP (``ep_mode="sp"``)
    shards the sequence over ``model`` so each plane moves distinct rows
    — one logical dispatch, per-plane volume cut by |model|.  Used by the
    ``moe_dispatch`` scenario (``bench.moe``) to model comm volume
    without devices.  ``mesh_shape`` is any axis-name -> size mapping.
    """
    if ep_mode not in ("replicated", "sp"):
        raise ValueError(
            f"unknown ep_mode {ep_mode!r}; known: ('replicated', 'sp')")
    return 1 if ep_mode == "sp" else int(dict(mesh_shape).get("model", 1))
