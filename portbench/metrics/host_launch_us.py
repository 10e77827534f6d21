"""host_launch_us: the mean ``launch`` span of a run, in us, over a pass of
the run loop with the program's recorder on (``recorded.pass_a``,
unprofiled).  ``launch`` runs from the runner's call of its program to the
program's return, when the host has issued the run's work: on
``cuda-fused`` the wrapper's checks, its allocations and the library call
(``fused.check``, ``fused.alloc``, ``fused.launch``), on ``cuda-graph`` the
replay (``graph.replay``).  None where the program records no spans."""
from portbench import recorded


def read(ctx):
    p = recorded.pass_a(ctx)
    return None if p is None else recorded.launch_us(p.spans)
