"""decode_mbu: the bytes of the decode steps the traced window completed
(``model_costs.step_work``: every weight held, the SSM states read and
written, the K/V rows read at each slot's depth and written, the rows in
and the logits out), over the window's length times the published HBM3
rate of 3.35 TB/s, in %.  None where the loop logs no traced runs."""
from portbench import model_costs as mc
from portbench.metrics.decode_mfu import done


def read(ctx):
    if ctx.device.type != "cuda" or not getattr(ctx.loop, "split_runs", None):
        return None
    return 100.0 * done(ctx, "bytes") / (ctx.window.seconds
                                         * mc.HBM_PEAK_BYTES_S)
