"""k1_roofline: K1's (``kernels/csrc/compute.cu``) bound a launch over its
device time a launch, in %.  The time is K1's alone, launched with the
cell's arguments from a captured graph of its own nodes
(``trace.kernel_seconds``), read only where the runner's captured program
holds K1 as nodes; the bound is ``costs.k1``."""
from portbench import costs


def read(ctx):
    if not ctx.kernels or "k1" not in ctx.kernels:
        return None
    return 100.0 * costs.k1(ctx.graph).bound_s / ctx.kernels["k1"]
