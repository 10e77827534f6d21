"""device_idle_share: the share of the profiled slice of the run loop in
which no operation ran on the device (``trace.profile_runs``), in %."""


def read(ctx):
    s = ctx.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
