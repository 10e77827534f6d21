"""k2_roofline: K2's (``kernels/csrc/memory.cu``) bound a launch over its
device time a launch, in %.  The time is K2's alone, launched with the
cell's arguments from a captured graph of its own nodes
(``trace.kernel_seconds``), read only where the runner's captured program
holds K2 as nodes; the bound is ``costs.k2``."""
from portbench import costs


def read(ctx):
    if not ctx.kernels or "k2" not in ctx.kernels:
        return None
    return 100.0 * costs.k2(ctx.graph).bound_s / ctx.kernels["k2"]
