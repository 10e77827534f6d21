"""The port's task kernels: plain PyTorch bodies and hand-written CUDA.

- bodies: plain step functions, the masked loop and ``run_kernel_columns``
- compute: K1, the compute kernel (``csrc/compute.cu``)
- memory: K2, the memory kernel (``csrc/memory.cu``)
- _build: the nvcc build of ``csrc/`` and the ctypes loader

K3, the fused megakernel (``csrc/fused.cu``), is wrapped in
``backends.megakernel``, beside the backend that runs it.
"""
from . import bodies
from .compute import taskbench_compute, taskbench_compute_plain
from .memory import taskbench_memory, taskbench_memory_plain

__all__ = [
    "bodies",
    "taskbench_compute",
    "taskbench_compute_plain",
    "taskbench_memory",
    "taskbench_memory_plain",
]
