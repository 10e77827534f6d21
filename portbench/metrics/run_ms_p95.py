"""run_ms_p95: the 95th percentile of one graph run's wall time, from the
runner's call to the outputs on the host, over every run of the window
(host clock; Python's exclusive quantiles)."""
import statistics


def read(ctx):
    walls = ctx.window.walls
    if len(walls) < 20:
        return None  # fewer than one run beyond the percentile
    return 1e3 * statistics.quantiles(walls, n=20)[-1]
