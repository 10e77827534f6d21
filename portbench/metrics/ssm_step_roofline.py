"""ssm_step_roofline: one layer's Mamba-2 decode step
(``kernels.ops.ssd_decode_step``) at the batch's rows, its bound over its
device time alone, in %.  The time is the loop's ``ssm_step`` call,
captured and replayed alone (``trace.kernel_seconds``); the bound is
``model_costs.ssm_step_work``: the float32 state read and written and its
rows, at the HBM peak."""
from portbench import model_costs as mc


def read(ctx):
    if not ctx.kernels or "ssm_step" not in ctx.kernels:
        return None
    work = mc.ssm_step_work(ctx.graph, ctx.graph["slots"])
    return 100.0 * work.bound_s / ctx.kernels["ssm_step"]
