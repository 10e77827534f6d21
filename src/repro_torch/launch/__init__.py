"""Launch layer of the port (the port of ``repro.launch``).

- mesh: the production meshes' shapes (``production_mesh_spec``) and
  ``DeviceMesh``es over the caller's process group; the MoE dispatch's
  plane count
- specs: meta-device inputs of every dry-run cell, their logical axes and
  their layouts under the rules
- roofline: the H100's rates, ``CostCounter`` (a traced step's per-device
  FLOPs, HBM bytes and collective bytes) and the roofline terms
- dryrun: every (arch x shape x mesh) cell traced on a fake process group
  with fake tensors (``python -m repro_torch.launch.dryrun``)
- report: its roofline and dry-run tables
"""
