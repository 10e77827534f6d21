"""The port's task kernels: plain PyTorch bodies and hand-written CUDA.

- bodies: the MXU step and ``run_kernel_columns`` (it re-exports the
  compute and memory steps and the masked loop)
- compute: K1, the compute kernel (``csrc/compute.cu``), with the compute
  step and the masked loop
- memory: K2, the memory kernel (``csrc/memory.cu``), with the memory step
- flash_attention: K5, the FlashAttention-2 forward (bf16:
  ``csrc/flash_attention_sm90.cuh`` on wgmma and TMA; float32:
  ``csrc/flash_attention.cu``; a module, its wrapper of the same name)
- ssd: K6, the Mamba-2 SSD chunked forward (``csrc/ssd.cu``)
- ssd_decode: K7, one Mamba-2 SSD decode step, the state updated in place
  (``csrc/ssd_decode.cu``)
- ops / ref: the LM dispatch (``attention``, ``ssd``, ``ssd_decode_step``)
  and its oracles
- _build: the nvcc build of ``csrc/``, the ctypes loader and the launch
  registry every wrapper K1-K7 registers in (``kernel``, ``launch``,
  ``launch_counts``)

K3, the fused megakernel (``csrc/fused.cu``), and K4, its one-sided
multi-rank form (``csrc/onesided.cu``), are wrapped in
``backends.megakernel``, beside the backend that runs them.
"""
from . import bodies
from .compute import taskbench_compute, taskbench_compute_plain
from .memory import taskbench_memory, taskbench_memory_plain
from .ssd import ssd_chunked, ssd_chunked_plain

__all__ = [
    "bodies",
    "ssd_chunked",
    "ssd_chunked_plain",
    "taskbench_compute",
    "taskbench_compute_plain",
    "taskbench_memory",
    "taskbench_memory_plain",
]
