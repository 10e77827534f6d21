"""expert_roofline: one layer's expert part (the held experts and the
shared expert, ``models/moe.py`` and ``layers.apply_mlp``) at the batch's
rows, its bound over its device time alone, in %.  The time is the loop's
``expert`` call, captured and replayed alone (``trace.kernel_seconds``);
the bound is ``model_costs.expert_work`` at the pairs the window's last
chunk served a layer a step, read from the program's counter
``moe.held_pairs`` in the recording of that run.  None where the program
keeps no such counter."""
from portbench import model_costs as mc


def read(ctx):
    runs = getattr(ctx.loop, "split_runs", None)
    if not ctx.kernels or "expert" not in ctx.kernels or not runs:
        return None
    pairs = [v for c in runs[-1]["recording"].counters
             if c.name == "moe.held_pairs" for v in c.values]
    if not pairs:
        return None
    g = ctx.graph
    a_layer_a_step = sum(pairs) / (g["chunk"] * len(g["model"]["layer_types"]))
    work = mc.expert_work(g, a_layer_a_step, g["slots"])
    return 100.0 * work.bound_s / ctx.kernels["expert"]
