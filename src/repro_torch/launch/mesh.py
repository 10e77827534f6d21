"""Production mesh construction (the port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.  ``make_production_mesh`` and
``make_debug_mesh`` build a ``torch.distributed.device_mesh.DeviceMesh``
over the process group the caller started, whose size must be the
mesh's; they start none themselves (the dry run starts a fake one,
``launch.dryrun.fake_group``).
"""
from __future__ import annotations

from typing import Optional, Tuple


def production_mesh_spec(
    *, multi_pod: bool = False, pipeline_stages: int = 1,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh, without touching devices.

    Base: 16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).
    ``pipeline_stages > 1`` grows a trailing ``stage`` axis carved out of
    the data axis (total chip count is preserved), giving the 4D
    ``(pod, data, model, stage)`` strategy that ``dist.pipeline`` and the
    ``torch-pipeline`` backend shard over.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if pipeline_stages <= 1:
        return shape, axes
    data = shape[-2]
    if data % pipeline_stages:
        raise ValueError(
            f"data axis {data} not divisible by {pipeline_stages} stages")
    shape = shape[:-2] + (data // pipeline_stages, shape[-1], pipeline_stages)
    return shape, axes + ("stage",)


def _device_mesh(shape, axes, device: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    size = 1
    for n in shape:
        size *= n
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {size} "
                           f"ranks; none is started")
    if dist.get_world_size() != size:
        raise RuntimeError(f"a {shape} mesh needs a process group of {size} "
                           f"ranks, the one started has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, pipeline_stages: int = 1,
                         device: Optional[str] = None):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks),
    optionally with a ``stage`` pipeline axis, on ``device``'s type
    (``cuda`` unless the caller asks for ``cpu``)."""
    shape, axes = production_mesh_spec(
        multi_pod=multi_pod, pipeline_stages=pipeline_stages)
    return _device_mesh(shape, axes, device)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device: Optional[str] = None):
    """A small mesh over the ranks of the caller's process group."""
    return _device_mesh(shape, axes, device)


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
