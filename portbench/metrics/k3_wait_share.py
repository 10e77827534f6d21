"""k3_wait_share: K3's cycles in the dependency combine over its cycles from
each task's start to its signal store, in %, summed over every CTA of every
launch in a pass of the run loop with the program's recorder on
(``recorded.pass_a``, unprofiled).  K3's traced instance counts both with
each SM's ``clock64()`` (``k3.wait_cycles``: a CTA's warp 0 in the
dependency combine, its slowest lane's polls and the shuffle that sums
their values; ``k3.task_cycles``).  None where the program keeps no such
counters."""
from portbench import recorded


def read(ctx):
    p = recorded.pass_a(ctx)
    return None if p is None else recorded.wait_share(p.counters)
