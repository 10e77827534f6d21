"""Task Bench on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The main path is the paper's METG pipeline, as in the reference package:

    g = core.make_graph(...)                      # a TaskGraph
    out = backends.get_backend("cuda-fused").run([g])
    core.check_outputs(g, out[0])                 # against the numpy oracle
    bench.run_scenario(bench.ScenarioSpec(...))   # granularity sweep -> METG

Backends run on ``cuda`` unless the spec asks for the CPU
(``"torch-scan[device=cpu]"``); with no device given and no card present
they raise.  The task kernels are hand-written CUDA for ``sm_90a``
(``kernels/csrc``), built with ``nvcc`` at first use.

Since slice 3 the port also serves Mamba-2 (``configs``, ``models``,
``serve``): ``serve.ServeEngine`` over ``models.model.init_model(cfg)``, the
SSD of every prefill on K6 (``kernels/csrc/ssd.cu``).

The numerics contract has no TF32 anywhere and accumulates bf16 matmuls in
float32 throughout: the switches are set here, whatever the process
default.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
