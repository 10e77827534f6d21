"""idle_host_share: the device's idle time while the host was in a run's
``launch`` or ``copy``, elsewhere in a run outside ``wait``, or between
runs, over the window from the first run's start to the last run's end, in
%, in a pass of the run loop under the profiler (the device alone, as
``trace.profile_runs`` sets it up) with the program's recorder on
(``recorded.pass_b``).  Idle inside ``wait`` is not the host's: the device
itself left it.  None where the program records no spans."""
from portbench import recorded


def read(ctx):
    p = recorded.pass_b(ctx)
    if p is None:
        return None
    return recorded.host_share(recorded.idle_by_host(p.spans, p.events))
