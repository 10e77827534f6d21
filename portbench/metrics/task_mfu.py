"""task_mfu: the graphs' useful operations over the window (Task Bench's
compute work, ``costs.useful_flops``), over the window's length times the
published float32 peak of 67 TFLOP/s, in %: the paper's efficiency."""
from portbench import costs


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.loop.useful_flops:
        return None
    done = ctx.loop.useful_flops * ctx.window.runs
    return 100.0 * done / (ctx.window.seconds * costs.FP32_PEAK_FLOPS)
