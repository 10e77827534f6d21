"""Launch helpers of the port.  Holds only ``mesh.moe_dispatch_planes``
for now, which the MoE dispatch scenario (``bench.moe``) needs; the rest
of the reference's ``repro.launch`` (meshes, specs, the dry run and its
roofline) comes with the sharding and launch slice."""
