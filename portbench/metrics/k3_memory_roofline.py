"""k3_memory_roofline: ``k3_roofline`` in the cells that run K3's memory
body (those that report ``tasks_per_s.memory``)."""
from portbench.metrics.k3_roofline import read  # noqa: F401
