"""task_mbu: the graphs' useful bytes over the window (Task Bench's memory
work, ``costs.useful_bytes``), over the window's length times the published
HBM3 rate of 3.35 TB/s, in %."""
from portbench import costs


def read(ctx):
    if ctx.device.type != "cuda" or not ctx.loop.useful_bytes:
        return None
    done = ctx.loop.useful_bytes * ctx.window.runs
    return 100.0 * done / (ctx.window.seconds * costs.HBM_PEAK_BYTES_S)
