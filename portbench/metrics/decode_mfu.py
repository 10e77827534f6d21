"""decode_mfu: the model operations of the decode steps the traced window
completed (``model_costs.step_work``: the active weights each token uses,
with the (token, held expert) pairs each run's chunk counted, attention
over each slot's depth, the SSM update), over the window's length times
the published bfloat16 peak of 989.4 TFLOP/s, in %.  None where the loop
logs no traced runs."""
from portbench import model_costs as mc


def done(ctx, part: str) -> float:
    """The window's summed ``part`` (``ops`` or ``bytes``) of each step."""
    g, C = ctx.graph, ctx.graph["chunk"]
    total = 0.0
    for run in ctx.loop.split_runs:
        for t in range(C):
            w = mc.step_work(g, [d + t + 1 for d in run["depths"]],
                             run["held_pairs"] / C)
            total += getattr(w, part)
    return total


def read(ctx):
    if ctx.device.type != "cuda" or not getattr(ctx.loop, "split_runs", None):
        return None
    return 100.0 * done(ctx, "ops") / (ctx.window.seconds
                                       * mc.BF16_PEAK_FLOPS)
