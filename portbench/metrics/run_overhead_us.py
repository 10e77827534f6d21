"""run_overhead_us: what a graph run costs beyond its device program, in
us: for each run of the traced window, its host wall (the runner's call to
the outputs on the host) less the time between the CUDA events recorded on
the stream before and after the runner's program in that run
(``Loop.run_split``), averaged over the window's runs.  It is the copy to
the host, the wait and the host's own work around the program."""
import statistics


def read(ctx):
    w = ctx.window
    if not w.device_s:
        return None
    return 1e6 * statistics.fmean(
        wall - dev for wall, dev in zip(w.walls, w.device_s))
