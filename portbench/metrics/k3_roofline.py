"""k3_roofline: K3's (``kernels/csrc/fused.cu``) bound a run over the device
time of a run, in %.  A run of ``cuda-fused`` is K3's single launch (and
the memset of its signal words), so the time is the mean, over the traced
window's runs, of the time between the CUDA events recorded before and
after the runner's program; read only where ``taskbench_fused.launches``
counted one launch a graph in each run of the window.  The bound is
``costs.k3``."""
import statistics

from portbench import costs


def read(ctx):
    w, g = ctx.window, ctx.loop.ngraphs
    if not w.device_s or w.launches.get("k3", 0) != g * w.runs:
        return None
    return 100.0 * costs.k3(ctx.graph, g).bound_s \
        / statistics.fmean(w.device_s)
