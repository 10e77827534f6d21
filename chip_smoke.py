"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, end to end.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels K1-K6 from ``src/repro_torch/kernels/
csrc`` (nvcc, sm_90a, one process per source), then, in phases that each
raise on failure:

1. the card: name and power limit (nvidia-smi), SMs, max SM clock, versions;
2. the build, timed, with ptxas's registers, spills and warnings for every
   kernel (K5's ten instantiations and K6's nine among them), the HGMMA
   (wgmma) and UTMALDG (TMA load) instructions in the SASS of K5's five
   bf16 ones, and the HGMMA instructions of K6's (failing on none in the
   four tensor-core passes);
3. every kernel against its plain PyTorch version on the card, at the
   shapes of ``tests/test_kernels.py`` and at the main paths' full-size
   shapes: K1, K2, K3 and K4 bitwise for the empty, compute and memory
   kinds, K3 and K4 compute_mxu within check_outputs' rtol 1e-5 / atol
   1e-6; K3 at full size also with more tasks than its grid has CTAs
   (nearest[radix=5] graphs stacked past ``taskbench_fused_blocks``, several
   tasks a CTA a timestep); K4 on every pattern at 2, 4 and 8 ranks
   (ragged widths included)
   and at full size on stencil (4 and 132 ranks), nearest[radix=5] (132),
   memory with 1 MiB of scratch per column (132) and spread[radix=5] (8
   ranks, puts to every rank); K6 (SSD) at the shapes of
   ``tests/test_kernels.py``, chunk 1 and 37, a ragged S=100 through
   ``ops.ssd`` and the full-width Mamba-2 2.7B prefill shape, in float32
   (its SIMT kernel) and in the model's bf16 (its tensor-core kernel; also
   at every length serving gives it, 37, 128, 384, 1024 and 1536 tokens,
   and past the tensor-core sizes on the SIMT kernel),
   within the tolerance ``PERF.md`` states; K5
   (flash attention) in float32 (its SIMT kernel) and bf16 (its wgmma/TMA
   kernel) at ``tests/test_kernels.py``'s attention cases, at ragged
   lengths 37, 100 and 300, with fully masked rows (a causal q_offset < 0),
   at shapes the tensor-core kernel's tiles can get wrong (ragged GQA at
   D=128, a chunked-prefill offset off the tile grid, non-causal MQA with
   Skv no multiple of 64) and at the full-width RecurrentGemma-2B prefill
   (Hq 10, Hkv 1, D 256, window 2048, S 1000 and 3000);
4. the structural pin, over ``PIN_RUNS`` runs: the launch counter reads
   exactly one K3 launch a ``cuda-fused`` run, for 1 graph and for 3
   stacked graphs, and one K4 launch a graph of a
   ``cuda-fused[comm=onesided]`` run; ``torch.profiler`` records at least
   one CUDA kernel, none but the expected kernel and no more than those
   launches (it can miss whole launches, see ``timed``); the memsets with
   which K3 and K4 zero their signal words are not kernels.  For
   ``cuda-graph``, for 1 graph and for 4 stacked graphs: the capture
   records HEIGHT K1 nodes a program (the counters count at capture), and
   over the runs the profiler's host side records one ``cudaGraphLaunch``
   a run and no kernel launch, its device side K1 kernels and no more than
   those nodes;
5. the main paths at full size, each with the launch counts zeroed just
   before it and read just after: stencil / compute, width 132 (one task
   column per SM), height 1000, on ``torch-scan``, ``cuda-graph`` and
   ``cuda-fused``, one graph and ``run_many`` of 4 concurrent
   nearest[radix=5] graphs, plus the memory kind with 1 MiB of scratch per
   column; and the stencil and memory graphs on
   ``cuda-fused[comm=onesided,ranks=132]`` (one rank per column); every
   output checked against the numpy oracle and all backends bitwise equal;
   ``cuda-graph``'s capture and instantiation times, its graph pool, its
   K1/K2 nodes and its first and later run walls printed; then
   ``torch-host`` (per-task host dispatch), static and stealing with 4
   workers, on the same three cases cut to HOST_HEIGHT timesteps (a task
   is 13 PyTorch launches from the host, 260-370 us on an H100 host, so
   the full height would take ~40 s a run on stencil and ~160 s on 4 x
   nearest): each output against
   the oracle of the cut graphs and bitwise against ``torch-scan`` on
   them, K1 (or K2) launched exactly H x W times a graph, the wall a task,
   and from one profiled window the PyTorch kernels, host launches and
   kernel time a task;
6. METG on the card: ``run_scenario`` with the wall clock over iterations
   4096 -> 1 for the four backends above and ``torch-host`` (at
   HOST_METG_HEIGHT timesteps), self-normalised and against the best rate
   of the five;
7. the serving path: ``mamba2-2.7b`` at full width (64 layers, bf16,
   random weights from seed 0) served by ``ServeEngine(batch_slots=4,
   chunk_size=8)`` on six requests in three ways: chunked and host with
   the decode step captured as a CUDA graph (capture and instantiation
   times, graph pool printed) and chunked eager; the launch counts zeroed
   just before the chunked captured serve and read just after; all three
   give the same tokens (the chunked ones the same stats), a request
   served alone the same tokens as in the batch, K6 runs once a layer for
   every prefill of more than one token, and the last prefill logits with
   K6 agree with the same forward on ``ssd_chunked_plain`` (in float32
   within 1e-4; in bf16 only a guard, see LOGITS_BF16_RTOL); time to first
   token, the decode rate at 4 live slots captured beside eager (in
   turns), one profiled tick of each captured engine (exactly ``steps``
   ``cudaGraphLaunch`` calls, one in host mode, and no kernel launch from
   the host) and the profiles of one eager decode step, one replayed step
   and the 1000-token prefill are printed;
8. the same for ``recurrentgemma-2b`` at full width (26 layers: 18 RG-LRU
   and 8 local-attention, bf16, random weights from seed 0) with
   ``max_len=4096``, so every local-attention layer has a ring cache and
   its prefill runs K5: prompts of 1, 2, 37, 300, 1000 and 3000 tokens, K5
   once a local-attention layer for every prefill of more than one token,
   the 3000-token prefill logits with K5 against the same forward on the
   plain version, and the time to first token of the 1000- and 3000-token
   prompts alone;
9. the load-imbalance study (paper §V-G) on the card: every cell of
   ``imbalance_study_specs()`` (``torch-host`` static and stealing,
   imbalance 0 to 2) through ``run_scenario`` with the wall clock, each
   result written by ``write_bench_json`` into ``build/bench`` and read
   back through the schema check, and the elapsed times and mitigation
   curve printed;
10. the message-passing backends with RANKS (4) rank processes sharing
   the card, rows staged through pinned host buffers over gloo: whether an
   MPS daemon runs, the host's CPUs and the ranks' affinity, the ranks'
   start time and context memory; ``torch-csp`` in modes halo (auto),
   ``comm_overlap``, ``a2a`` and ``onesided`` on the three main cases at
   full size (the 4 nearest graphs as one combined ``run_many``; in halo
   mode also against ``run`` of one of them), the
   ranks' K1/K2 counts zeroed just before each run and read just after
   (H a rank a graph), each output against the oracle and bitwise with
   ``torch-scan``, the one-sided mode
   bitwise with K4 at 4 ranks; ``torch-pipeline`` on a sweep graph (ring
   mode); each run's split a rank (body, waiting for the device, staging,
   gloo); the wall a timestep beside ``torch-scan``'s in turns; one
   profiled run a rank (kernel and copy time, idle share); METG of
   ``torch-csp[ranks=4]`` at CSP_METG_HEIGHT timesteps; and the payload
   study at 4 ranks;
11. the planner and the campaign, in PLANNER_BUDGET_S (120 s): ``python -m
   repro_torch.bench.run --tune --timer synthetic`` regenerates the
   committed ``TUNE_torch.json`` byte for byte; ``torch-auto`` on the three
   main cases at full size and on a stencil graph of 4096-byte payloads
   (resolved to ``torch-csp[comm=onesided]``, one rank process on one
   card), the counts zeroed just before its runs and read just after, each
   resolved spec printed, each output bitwise with its winner's own run
   and the oracle, the host time of a resolve and the walls of
   ``torch-auto`` and its winner in turns; METG of ``torch-auto`` beside
   ``cuda-fused``'s of phase 6; the runner on the wall clock
   (``bench_metg_patterns`` over ``torch-auto``, ``cuda-fused`` and
   ``cuda-graph``; ``bench_metg_scaling`` on ``torch-csp`` at SCALING_RANKS
   1, 2 and 4 ranks, cut from 1-8 for the budget), its artifacts read back
   through the schema check; and a two-family suite on the synthetic clock
   whose rollout is byte-equal to its first run;
12. dense serving and the serving family, in DENSE_BUDGET_S (150 s):
   ``bench_serve_load`` on the wall clock at ``--smoke`` (the reference's
   reduced ``qwen1.5-0.5b``, the decode step captured), its six artifacts
   read back through the schema check; the family's rate-2000 cells,
   chunked and host, with ``qwen1.5-0.5b`` at full width through
   ``run_engine_load``; ``yi-6b`` and ``minitron-8b`` at full width
   serving prompts of 5 to 1000 tokens, captured and eager decode giving
   the same tokens, the decode rate at 4 live slots captured beside eager;
   and ``qwen2-72b`` cut to QWEN72_LAYERS (32) of its 80 layers (61 GB of
   its 145 GB in bf16), one 1000-token prefill and a captured chunk
   against eager.  Dense prefill runs the attention oracle (a tensor
   cursor), as the reference does, so no kernel of K1-K6 runs here;
13. MoE serving, the a2a path and the dispatch family, in MOE_BUDGET_S
   (150 s): ``mixtral-8x7b`` cut to MIXTRAL_LAYERS (20) of its 32 layers
   (58.6 GB of its 93 GB in bf16) serving DENSE_REQS and a 4500-token
   prompt at ``max_len`` 6144, so every layer has a ring cache and every
   prefill runs K5 with the model's window of 4096; ``arctic-480b`` cut to
   ARCTIC_LAYERS (2) of its 35 (55 GB), one 1000-token prefill and a
   captured chunk; each captured and eager chunked, the same tokens, time
   to first token, decode at 4 live slots captured beside eager against
   the step's bytes bound (the dense path reads every expert), the prefill
   logits without a cache on K5 (Arctic's Hq 56 / Hkv 8, GQA group 7)
   against its plain version; the counts zeroed before and read after,
   K5 exactly once a layer a ring-cache prefill or cacheless forward and
   no other kernel; K5 timed at those shapes (ATTN_MOE, also checked in
   phase 3) beside its plain version and SDPA; the a2a path on one
   full-width Mixtral layer in float32 at capacity factor 8 over a new
   pool of 4 rank processes, as (data, model) = (2, 2) and (4, 1) in both
   ep_modes, each rank building its shard from the seed, against the
   dense path within the reference's 5e-4 max(scale, 1) and each rank's
   all-to-all bytes equal to ``analytic_a2a_bytes``; and
   ``bench_moe_dispatch`` through the runner;
14. training, in TRAIN_BUDGET_S (150 s): K5 at head size 80 (HuBERT X-Large's
   heads: its encoder's shape, a causal case and a ragged length, float32
   and bf16) against its plain version, timed at the encoder's shape beside
   its plain version and SDPA; the gradients through K5 and K6 (their
   autograd functions: the kernel forward, the plain version's graph
   backward) against the plain path's; ``hubert-xlarge`` whole (48 layers,
   full width, bf16, remat "full") trained HUBERT_STEPS steps at batch 8 x
   1024 frames of ``make_batch`` embeddings through ``make_train_step``,
   the counts zeroed before each step and read after (K5 twice a layer,
   nothing else), its first step against the same step on K5's plain
   version, the step's wall, tokens/s, peak memory, its share of the bf16
   peak at 6 N tokens and one profiled step; ``qwen2-vl-2b`` whole, a
   forward on 1024 embeddings on K5 and on its plain version, and
   DENSE_REQS served captured and eager; the ``Trainer`` on HuBERT cut to
   TRAINER_LAYERS layers at full width, a run failed at step 3 and
   restarted against an uninterrupted run, bit for bit; and a Mamba-2
   train step cut to MAMBA_TRAIN_LAYERS layers, K6 twice a layer under
   autograd, every SSD parameter's gradient non-zero, against the plain
   path;
15. data-parallel training and pipelines, in DP_BUDGET_S (150 s):
   ``qwen1.5-0.5b`` whole (bf16) trained at DP_BATCH (8 x 1024 tokens)
   through ``make_train_step`` on the whole batch in this process first
   (then freed), then over DP_RANKS (4) rank processes sharing the card,
   2 rows a rank, DP_STEPS steps with ``psum`` and DP_STEPS with
   ``compressed_psum`` from seed 0 (``train.dist_step.DataParallel``):
   every replica the controller's bits at the start and equal to the
   others after every step (fingerprints), the losses within the
   reference's 1e-4 / 2e-2 of the single-device step's (the last step's
   loss reads weights an earlier step moved), each mode held to its
   emulation in this process (each rank's gradients, the sync's formula,
   one AdamW step) within DP_EMU_RTOL and the other mode's emulation
   missing it, the ``psum`` update within DP_UPDATE_RTOL of the
   single-device one, each rank's
   split of a step (waiting for the device, staging, gloo), its staged
   bytes equal to the analytic count, K5 twice a layer a rank step, the
   walls a step beside the single-device step's; the ``Trainer`` with
   ``grad_sync="compressed_psum"`` on 2 ranks, qwen1.5-0.5b cut to
   DP_TRAINER_LAYERS layers, failed at step 3 and restarted, bit for bit;
   ``yi-6b`` whole pipelined (``dist.pipeline.pp_forward``, 4 stages x 8
   microbatches, 8 x 1024 tokens) against ``forward``, bit for bit, K5
   once a layer a microbatch (256), and the gradient of
   ``pp_loss_fn`` on a 4-layer cut reaching every stage; and
   ``bench_model_step`` at ``--smoke`` through the runner;
16. the dry-run cost model, in COST_BUDGET_S (40 s), reading the walls
   phases 6 and 15 measured (no model runs): the roofline constants of
   ``launch.roofline`` against the card's SMs and clock; (a) the
   parameter bytes of ``model_spec`` (the meta device) of qwen1.5-0.5b
   equal to the bytes ``init_model`` holds on the card, by the tensors
   and by the allocator; (b) ``DryRunTimer``'s seconds for every point of
   phase 6's stencil sweep on ``cuda-fused`` and ``torch-scan``, each at
   most that point's measured wall (a roofline is a lower bound), their
   ratio printed; (c) the dry run (``launch.dryrun.lower_cell``, fake
   tensors on the CPU, a one-rank mesh) of phase 15's qwen1.5-0.5b train
   step at DP_BATCH, its ``bound_step_s`` at most the single-device step
   phase 15 measured, its ``useful_ratio`` and ``roofline_fraction``
   printed.
Every kernel's bound comes from its wrapper's declared cost
(``kernels/_cost.py``), at the rate ``card_peaks`` computes.
The "kernel times" phase runs the plain K3 and K4 (1.13-1.44 s a call) one
call a window, a cut for the time phase 13 takes.  It also times K6 at the five shapes Mamba-2 serving
gives it (SSD_SERVE), each pass apart; K1 as a node of the replayed
``cuda-graph`` stencil run beside K1 alone; an empty kernel with K1's grid
(the launch floor K1's bound leaves out) alone and as a graph node; and the
replayed run's device time and wall a timestep beside ``torch-scan``'s wall.
The line before the last lists the kernels with their launches on the main
path (and the path they were counted on; ``planner_launches``: through
``torch-auto`` in phase 11, a rank's included; ``moe_launches``: on
phase 13's MoE serving; ``train_launches``: a train step of phase 14, K5's
on HuBERT, K6's on the Mamba-2 cut; ``dp_launches``: a rank's step of
phase 15's data-parallel training; ``pp_launches``: its pipelined
``yi-6b`` forward; K5's ``shapes``: its row at HuBERT's
D = 80), errors, times, bounds and
(K5) the time of one library call for the same function; for K5 and K6,
whose main paths are bf16, the bf16 kernel's (K6's summed over its three
passes, its bound at the bf16 tensor-core peak).  The
last line is the device record.  Exits non-zero,
printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.backends.megakernel import (  # noqa: E402
    MegakernelBackend, onesided_tables_from_numpy, tables_from_numpy,
    taskbench_fused, taskbench_fused_plain, taskbench_onesided,
    taskbench_onesided_plain)
from repro_torch.backends import csp  # noqa: E402
from repro_torch.bench import run as bench_run  # noqa: E402
from repro_torch.bench import suite as bench_suite  # noqa: E402
from repro_torch.bench import tuner  # noqa: E402
from repro_torch.bench import (DryRunTimer, ScenarioSpec,  # noqa: E402
                               SweepControls, compute_metg, elapsed_s, imbalance_study_specs,
                               mitigation_curve, payload_curve,
                               payload_study_specs, read_bench_json,
                               run_engine_load, run_scenario,
                               write_bench_json)
from repro_torch.bench.families import (  # noqa: E402
    bench_serve_load as serve_load_family)
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.core import (KernelSpec, check_outputs,  # noqa: E402
                              execute_reference, make_graph, pattern_names,
                              replicate)
from repro_torch.dist import plan_comm  # noqa: E402
from repro_torch.dist import pipeline as PP  # noqa: E402
from repro_torch.dist.ranks import close_pools, get_pool  # noqa: E402
from repro_torch.kernels import (_build, bodies,  # noqa: E402
                                 taskbench_compute, taskbench_compute_plain,
                                 taskbench_memory, taskbench_memory_plain)
from repro_torch.kernels import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.dryrun import lower_cell  # noqa: E402
from repro_torch.kernels.ssd import (ssd_chunked,  # noqa: E402
                                     ssd_chunked_plain, uses_tensor_cores)
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models.cache import init_caches  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.train import dist_step as DS  # noqa: E402
from repro_torch.train.trainer import LoopConfig, Trainer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_LANES_PER_SM = 128
WIDTH, HEIGHT = 132, 1000
MAIN_ITERS, MEM_ITERS = 16, 4
MEM_SCRATCH = 1 << 20
MXU_RTOL, MXU_ATOL = 1e-5, 1e-6
ONESIDED = f"cuda-fused[comm=onesided,ranks={WIDTH}]"  # a rank per column
PIN_RUNS = 4  # runs of each structural-pin case under one profiler window
GRAPH_NODES = 200  # empty kernels in the graph that times one as a node
WALL_RUNS = 5  # runs of cuda-graph and torch-scan, in turns, for the walls
# torch-host issues 13 PyTorch launches a task from the host (260-370 us a
# task on an H100 host), so its graphs are cut in height: the full H=1000
# would take ~40 s a run on stencil and ~160 s on 4 x nearest
HOST_HEIGHT = 100  # phase 5
HOST_METG_HEIGHT = 32  # phase 6
HOST_PROFILE_HEIGHT = 5  # the profiled window of phase 5 (660 tasks)
HOSTS = ("torch-host", "torch-host[schedule=steal,workers=4]")
# phase 10: the message-passing backends, 4 rank processes sharing the card
RANKS = 4
CSP_MODES = {"halo": f"torch-csp[ranks={RANKS}]",
             "overlap": f"torch-csp[comm_overlap=True,ranks={RANKS}]",
             "a2a": f"torch-csp[comm=a2a,ranks={RANKS}]",
             "onesided": f"torch-csp[comm=onesided,ranks={RANKS}]"}
PIPELINE = f"torch-pipeline[ranks={RANKS}]"
CSP_WALL_RUNS = 2  # later runs of the stencil, in turns with torch-scan
# a torch-csp[ranks=4] step takes ~1.6-2.1 ms on an H100 host, so its METG
# sweep (7 points x 4 runs) is cut in height: at H=1000 it took 52 s
CSP_METG_HEIGHT = 250
# phase 11: the planner and the campaign, in at most PLANNER_BUDGET_S.  Its
# cuts: the wall-clock scaling sweep stops at SCALING_RANKS on one card
# (the synthetic artifact keeps 1, 2, 4 and 8 ranks), and the walls of
# torch-auto against its winner are PLANNER_WALL_RUNS runs each
PLANNER_BUDGET_S = 120
SCALING_RANKS = "1,2,4"
PLANNER_WALL_RUNS = 2
PLANNER_RESOLVES = 100  # resolves timed for the host time of one
PROFILE_WINDOWS = 10  # ``timed``: 1 + the windows it may rerun when one
# misses kernels or disagrees with the others
TIMED_WINDOWS = 3  # profiled windows whose median ``timed`` reports; for a
WINDOW_SPREAD = 0.10  # kernel wrapper all within this fraction of the least
# K6: tests/test_kernels.py's SSD cases, chunk 1 and 37 (B, S, H, P, G, N,
# chunk), then the full-width Mamba-2 2.7B prefill of 1024 tokens
SSD_CASES = ((2, 128, 4, 16, 2, 8, 32), (1, 256, 8, 32, 1, 16, 64),
             (2, 64, 2, 64, 2, 32, 64), (1, 9, 2, 8, 1, 4, 1),
             (2, 74, 4, 16, 2, 8, 37))
SSD_FULL = (1, 1024, 80, 64, 1, 128, 128)
# K6 at a mamba2-2.7b prefill of 37, 128, 300, 1000 and 1500 tokens (ops.ssd
# pads a prompt to whole chunks of 128; a shorter one is one chunk)
SSD_SERVE = tuple((1, S, 80, 64, 1, 128, min(S, 128))
                  for S in (37, 128, 384, 1024, 1536))
# bf16 shapes past the tensor-core kernel's P <= 64, N <= 128
SSD_SIMT_BF16 = ((1, 128, 2, 128, 1, 16, 64), (1, 128, 2, 32, 1, 256, 64))
SSD_TOL = 1e-4  # float32: the same products summed in another order
# relative L2 of a served prefill's logits, the path's kernel (K6, K5)
# against its plain version: tight in a float32 forward; in the bf16
# forward a guard against gross error only, since any float32-level change
# of a block's output moves bf16 logits by ~5e-2
# (tests/test_torch_ssm.py::test_bf16_rounding_cascade_dwarfs_f32_drift)
LOGITS_F32_RTOL, LOGITS_BF16_RTOL = 1e-4, 0.25
SERVE_SLOTS, SERVE_CHUNK = 4, 8
# phase 12: the serving family and the dense configurations, in at most
# DENSE_BUDGET_S; qwen2-72b (145 GB in bf16) cut to QWEN72_LAYERS layers
# (61 GB), yi-6b and minitron-8b whole
DENSE_BUDGET_S = 150
QWEN72_LAYERS = 32
DENSE_REQS = ((1000, 16), (300, 24), (37, 16), (5, 20))
# phase 13: MoE serving, the a2a path and the dispatch family, in at most
# MOE_BUDGET_S.  Its cuts: mixtral-8x7b (93 GB in bf16) at MIXTRAL_LAYERS of
# its 32 layers (58.6 GB), arctic-480b (~960 GB) at ARCTIC_LAYERS of its 35
# (55 GB); the a2a path on one full-width Mixtral layer in float32 (the
# reference's tolerance is a float32 one) at capacity factor 8 (no drops,
# as the reference's a2a tests), A2A_TOKENS (batch, seq) = 64 tokens
MOE_BUDGET_S = 150
MIXTRAL_LAYERS, ARCTIC_LAYERS = 20, 2
MOE_REQS = DENSE_REQS + ((4500, 16),)  # 4500 tokens: past the window
MIXTRAL_MAX_LEN = 6144  # > the window of 4096: ring caches, K5's window
A2A_TOKENS = (4, 16)
A2A_GRIDS = ((2, 2), (4, 1))  # (data, model) over RANKS rank processes
A2A_SEED = 3
# K5: tests/test_kernels.py's ATTN_CASES, ragged lengths, fully masked rows
# (a causal q_offset < 0), shapes the tensor-core kernel's 128 x 64 tiles
# can get wrong, then the full-width RecurrentGemma-2B prefill
# (B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset)
ATTN_CASES = ((2, 128, 128, 4, 2, 64, True, None, 0),
              (1, 128, 256, 8, 8, 32, True, 64, 128),
              (2, 64, 64, 4, 1, 64, False, None, 0),
              (1, 256, 256, 2, 2, 128, True, 128, 0),
              (2, 128, 128, 6, 3, 64, True, None, 0),
              (2, 37, 37, 4, 2, 32, True, 16, 0),
              (1, 100, 100, 6, 2, 64, False, None, 0),
              (1, 300, 300, 10, 1, 256, True, 128, 0),
              (1, 100, 100, 4, 2, 64, True, None, -60),
              (2, 777, 777, 8, 2, 128, True, 256, 0),
              (1, 100, 357, 4, 4, 256, True, None, 257),
              (1, 130, 201, 10, 1, 256, False, None, 0))
ATTN_FULL = tuple((1, S, S, 10, 1, 256, True, 2048, 0) for S in (1000, 3000))
# K5 at the MoE prefills of phase 13: Mixtral's longest prompt against its
# window of 4096 (Hq 32, Hkv 8) and Arctic's 1000-token prompt (Hq 56, Hkv
# 8: GQA group 7)
ATTN_MOE = ((1, 4500, 4500, 32, 8, 128, True, 4096, 0),
            (1, 1000, 1000, 56, 8, 128, True, None, 0))
# float32: |o - o_plain| <= ATTN_TOL (1 + |o_plain|), the reference's own
# kernel-test tolerance; a bf16 output one bf16 ulp of o_plain more
ATTN_TOL = 2e-5
BF16_FLOP_PER_SM_CLOCK = 4096  # dense tensor cores: 989.4 TFLOP/s, 1830 MHz
# phase 14: training, in at most TRAIN_BUDGET_S.  K5 at HuBERT X-Large's
# heads (D = 80): its encoder's shape (B, S, H = 8, 1024, 16, non-causal),
# a causal case and a ragged length
TRAIN_BUDGET_S = 150
ATTN_D80 = ((8, 1024, 1024, 16, 16, 80, False, None, 0),
            (2, 1024, 1024, 16, 16, 80, True, None, 0),
            (3, 777, 777, 16, 16, 80, False, None, 0))
HUBERT_BATCH, HUBERT_STEPS = (8, 1024), 3  # (batch, frames), steps trained
# gradients through K5 and K6 against the plain path's: both backward
# passes run the same plain graph on the same inputs (the kernel path
# recomputes it), so they differ at most by the card's reduction order
GRAD_RTOL = 1e-5  # of each input's largest plain gradient
# the first bf16 training step on K5 against the same step on K5's plain
# version: the forward differs by a bf16 rounding a block, so the loss of
# ~ln(vocab) moves far less than a percent and the grad norm by less than
# a tenth
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-2, 0.1
TRAINER_LAYERS = 2  # of HuBERT's 48 for the save/restore run (~0.55 GB a
# checkpoint at full width, not 13 GB)
MAMBA_TRAIN_LAYERS, MAMBA_BATCH = 2, (4, 1024)  # of its 64 layers
QWEN_VL_FRAMES = 1024  # embeddings of one forward of qwen2-vl-2b
# phase 15: data-parallel training and pipelines, in at most DP_BUDGET_S.
# (a) qwen1.5-0.5b whole (0.46 B parameters, bf16) over DP_RANKS rank
# processes sharing the card.  A rank holds ~15 GB: ~7 GB of parameters
# with AdamW's float32 master weights and moments, ~4.5 GB of gradients and
# their float32 or int32 copies, ~3 GB of logits and their gradient; ~60 GB
# for four.  The global batch is DP_BATCH, 2 rows a rank as in the
# reference's DP test (tests/test_distributed.py), whose train config and
# loss tolerances these are.  Its learning rates are 0, 5e-4 and 1e-3, so
# DP_STEPS is 3: the last step's loss reads weights step 1 moved.  Its
# parameter bounds (1e-5 with psum, 1e-2 with compression) are float32
# ones, and AdamW's normalized update meets the second whatever the sync
# does.  So the float32 master weights' update (master - master at step
# 0) is held by its relative L2: each mode's against an emulation of the
# ranks in this process (each rank's gradients of its rows, the sync's
# formula, one AdamW step) within DP_EMU_RTOL (the H100 read 3.8e-8 with
# psum, 0 compressed, and 0.77-1.19 against the other mode's emulation;
# by estimate one element whose quantum flips reads ~3e-5), with the grad
# norms within DP_EMU_GNORM_RTOL (AdamW's update does not see a sync that
# scales the gradients) and the losses within DP_EMU_LOSS_TOL (the ranks'
# float32 mean), and against the other mode's emulation, which it must
# miss; and
# with psum against the single-device step's within DP_UPDATE_RTOL (in
# bf16 the ranks' 2-row gradients carry roundings the whole batch's do
# not).  Those roundings also move a loss that reads moved weights: with
# psum such a loss is held to the single device's within
# DP_MOVED_LOSS_TOL, a bf16 bound (the H100 read 6.3e-4 at step 2, the
# update 4.0e-3 from the single device's, while the ranks' losses equal
# the emulation's bit for bit); the reference's 1e-4 holds the losses that
# read the initial weights.
DP_BUDGET_S = 150
DP_RANKS, DP_BATCH, DP_STEPS = 4, (8, 1024), 3
DP_TCFG = dict(base_lr=1e-3, warmup_steps=2, total_steps=40)
# phase 16: the dry-run cost model against the walls phases 6 and 15 took
COST_BUDGET_S = 40
DP_LOSS_TOL = {"psum": 1e-4, "compressed_psum": 2e-2}
DP_UPDATE_RTOL, DP_MOVED_LOSS_TOL = 5e-2, 2e-3
DP_EMU_RTOL, DP_EMU_GNORM_RTOL, DP_EMU_LOSS_TOL = 1e-4, 1e-5, 1e-5
# (b) the DP Trainer on DP_TRAINER_RANKS ranks, qwen1.5-0.5b cut to
# DP_TRAINER_LAYERS of 24 layers at full width (a 2.5 GB checkpoint)
DP_TRAINER_RANKS, DP_TRAINER_LAYERS = 2, 2
# (c) yi-6b whole (32 layers) pipelined, PP_STAGES x PP_MICRO, against its
# forward on the same tokens, bit for bit: the only change is the GEMMs'
# row count (one row a microbatch against eight), and on the H100 the
# logits were equal in every run; the gradient on yi-6b cut to
# PP_GRAD_LAYERS layers, PP_GRAD_STAGES x PP_GRAD_MICRO
PP_STAGES, PP_MICRO, PP_BATCH = 4, 8, (8, 1024)
PP_GRAD_LAYERS, PP_GRAD_STAGES, PP_GRAD_MICRO = 4, 2, 4


class ServeCase(NamedTuple):
    """One serving phase: a model served at full width from seed 0."""
    model: str
    reqs: tuple  # (prompt tokens, new tokens) of the served requests
    max_len: int
    kernel: str  # the kernel the prefill runs ("K6", "K5")
    kind: str  # the block kind that launches it, once a prefill
    name: str  # a substring of its CUDA kernel's name
    ttft: tuple  # prompt lengths whose time to first token is taken alone
    logits_len: int  # the prompt whose prefill logits are checked


MAMBA = ServeCase("mamba2-2.7b", ((1, 8), (37, 16), (128, 24), (300, 32),
                                  (1000, 12), (1500, 20)), 2048, "K6", "ssd",
                  "ssd_chunked", (1000,), 1000)
GEMMA = ServeCase("recurrentgemma-2b", ((1, 8), (2, 12), (37, 16),
                                        (300, 24), (1000, 12), (3000, 32)),
                  4096, "K5", "local_attn", "flash_attention", (1000, 3000),
                  3000)


def metg_spec(be_name: str, height: int, sms: int) -> ScenarioSpec:
    """Phase 6's METG scenario: stencil / compute, WIDTH columns."""
    return ScenarioSpec(
        name=f"metg.{be_name}.stencil", backend=be_name, pattern="stencil",
        kernel="compute", width=WIDTH, height=height, cores=sms,
        sweep=SweepControls(iterations_hi=4096, n_points=7, repeats=3,
                            warmup=1))


def card_peaks(sms: int, max_mhz: float) -> tuple:
    """(fp32 peak, bf16 tensor-core peak) in FLOP/s: SMs x 128 lanes x 2
    x clock, and SMs x 4096 x clock."""
    return (sms * FP32_LANES_PER_SM * 2 * max_mhz * 1e6,
            sms * BF16_FLOP_PER_SM_CLOCK * max_mhz * 1e6)


def bound_of(flops: float, nbytes: float, peak: float) -> tuple:
    """(seconds, "operations" or "bytes"): the larger of the operations
    at ``peak`` and the bytes at HBM_BYTES_PER_S."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes"))


def phase(title: str):
    print(f"\n== {title}", flush=True)
    return time.perf_counter()


def done(t0: float) -> None:
    print(f"   phase time {time.perf_counter() - t0:.3f} s", flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_kernels(prof, only: str = "") -> list:
    """The CUDA kernels a ``torch.profiler`` run recorded (no copies), those
    whose name holds ``only`` where it is given."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))
            and only in e.name]


def host_calls(prof, what: str) -> list:
    """The host-side events (CUDA API calls among them) whose name holds
    ``what``."""
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and what in e.name]


class Timing(NamedTuple):
    """Per-call times in ms of one ``timed`` measurement."""
    device: float  # the profiler's kernel time (see ``timed``)
    stream: float  # CUDA events around the calls, not profiled
    memset: float  # memsets the profiler records
    span: float  # first kernel or memset's start to the last one's end
    recorded: int  # kernel launches the profiler recorded
    reps: int
    windows: int  # profiled windows run
    parts: tuple = ()  # (kernel, mean ms) of a wrapper's several kernels
    readings: tuple = ()  # device ms of every window that counted, in order
    agree: bool = True  # the median's windows lie within WINDOW_SPREAD

    def describe(self) -> str:
        parts = "".join(f"; {name} {ms:.6f} ms" for name, ms in self.parts)
        each = (f", each window's device ms "
                f"{', '.join(f'{r:.6f}' for r in self.readings)}"
                + ("" if self.agree else
                   f" (more than {WINDOW_SPREAD:.0%} apart)")
                if len(self.readings) > 1 else "")
        return (f"device {self.device:.6f} ms (stream {self.stream:.6f} ms; "
                f"profiler: {self.recorded} kernels recorded over {self.reps} "
                f"calls, {self.windows} windows{each}, span {self.span:.6f} "
                f"ms, memsets {self.memset:.6f} ms a call{parts})")


def profiled(fn, reps: int, only: str = ""):
    """One profiled window of ``reps`` calls: the profiler and the CUDA
    kernels it recorded (whose name holds ``only``), by name, each with its
    durations in us."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in device_kernels(prof, only):
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return prof, by_name


def agreeing(readings: list, n: int):
    """The ``n`` readings closest together, sorted, if the largest is within
    WINDOW_SPREAD of the least; else None."""
    s = sorted(readings)
    groups = [s[i:i + n] for i in range(len(s) - n + 1)
              if s[i + n - 1] <= s[i] * (1 + WINDOW_SPREAD)]
    return min(groups, key=lambda g: g[-1] / g[0], default=None)


def timed(fn, reps: int, kernels_a_call: int = 0, only: str = "") -> Timing:
    """Times a call of ``fn`` over ``reps`` back-to-back calls, after one
    warm call: under ``torch.profiler``, then with CUDA events alone
    (stream ms, which also counts the gaps where the host has not issued
    the next launch yet).  With ``only``, the profiler's readings keep the
    kernels whose name holds it (K1's nodes among a graph replay's).

    Device ms is the profiler's kernel time a call.  The profiler on the
    H100 does not record every launch: some windows miss whole launches of
    a long kernel (K3, K4), the ones it records being consecutive and of
    the right length, and one window recorded none of 20 K5 launches.  So
    a window that records no kernel, or for a kernel wrapper fewer than
    its ``kernels_a_call`` distinct CUDA kernels (K6's bf16 path: three
    passes), does not count.  A window's device ms is, for a kernel
    wrapper, the sum over its kernels of the mean duration of the launches
    recorded, otherwise the recorded kernel time over ``reps``.  Device ms
    is the median of TIMED_WINDOWS windows that count, and every window's
    reading is kept and printed: the profiler has read every K6 pass at
    under half its duration in one window (the windows before and after
    agreeing), and a plain version's kernels likewise.  For a kernel
    wrapper, whose device ms the kernels line reports, the median's
    windows must also agree, all within WINDOW_SPREAD of the least of
    them; for a plain version or a library call, which the line reports
    beside it, a disagreement is printed.  Windows are run again while too
    few count or (a wrapper's) agree, PROFILE_WINDOWS - 1 times at most;
    then ``timed`` fails.  Span and memset ms are per call, of the median
    window, span from the first kernel or memset's start to the last
    one's end."""
    fn()
    torch.cuda.synchronize()
    runs, windows = [], 0
    while len(runs) < TIMED_WINDOWS or (
            kernels_a_call
            and agreeing([r[0] for r in runs], TIMED_WINDOWS) is None):
        if windows == TIMED_WINDOWS + PROFILE_WINDOWS - 1:
            if len(runs) < TIMED_WINDOWS:
                raise AssertionError(
                    f"only {len(runs)} of {windows} profiled windows "
                    f"recorded {max(kernels_a_call, 1)} CUDA kernel(s)")
            raise AssertionError(
                f"no {TIMED_WINDOWS} of the profiled windows' device times "
                f"{[r[0] / 1e3 for r in runs]} ms lie within "
                f"{WINDOW_SPREAD:.0%} of one another")
        windows += 1
        prof, by_name = profiled(fn, reps, only)
        if not by_name or len(by_name) < kernels_a_call:
            continue
        if kernels_a_call and len(by_name) != kernels_a_call:
            raise AssertionError(f"expected {kernels_a_call} CUDA kernel(s) "
                                 f"a call, the profiler recorded "
                                 f"{sorted(by_name)}")
        device = (sum(sum(d) / len(d) for d in by_name.values())
                  if kernels_a_call
                  else sum(sum(d) for d in by_name.values()) / reps)
        runs.append((device, prof, by_name))
    readings = tuple(r[0] / 1e3 for r in runs)
    group = agreeing([r[0] for r in runs], TIMED_WINDOWS)
    median = (group or sorted(r[0] for r in runs))[TIMED_WINDOWS // 2]
    device, prof, by_name = next(r for r in runs if r[0] == median)
    kernels = device_kernels(prof, only)
    memsets = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith("Memset")]
    memset = sum(e.time_range.elapsed_us() for e in memsets)
    span = (max(e.time_range.end for e in kernels + memsets)
            - min(e.time_range.start for e in kernels + memsets))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    parts = (tuple((name.split("(")[0].removeprefix("void "),
                    sum(d) / len(d) / 1e3) for name, d in by_name.items())
             if kernels_a_call > 1 else ())
    return Timing(device / 1e3, start.elapsed_time(end) / reps,
                  memset / 1e3 / reps, span / 1e3 / reps, len(kernels), reps,
                  windows, parts, readings, group is not None)


def ssd_inputs(B, S, H, P, G, N, dev, dtype=torch.float32, seed=0):
    """Random SSD inputs (as tests/test_torch_gpu.py makes them)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g) * 0.5
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.5)
    Bm = torch.randn(B, S, G, N, generator=g) * 0.5
    Cm = torch.randn(B, S, G, N, generator=g) * 0.5
    return (x.to(dev, dtype), dt.to(dev), A.to(dev), Bm.to(dev, dtype),
            Cm.to(dev, dtype))


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2 ** -126)))
                      - 7)


def ssd_agree(name: str, got, want) -> float:
    """K6 against its plain version: y and state within SSD_TOL (float32),
    a bf16 y within SSD_TOL plus one bf16 ulp; returns the max abs error."""
    worst = 0.0
    for what, a, b in (("y", got[0], want[0]), ("state", got[1], want[1])):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        allowed = SSD_TOL * (1 + b.abs())
        if got[0].dtype == torch.bfloat16 and what == "y":
            allowed = allowed + bf16_ulp(b)
        err, rel = diff.max().item(), (diff / b.abs().clamp_min(1e-6)).max()
        print(f"   K6 {name} {what}: max abs err {err:.3e}, max rel err "
              f"{rel.item():.3e} (max |plain| {b.abs().max().item():.3f})")
        if not bool((diff <= allowed).all()) or not bool(a.isfinite().all()):
            raise AssertionError(f"K6 {name}: {what} differs from its plain "
                                 f"version beyond the tolerance")
        worst = max(worst, err)
    return worst


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def ssd_bound(B, S, H, P, N, chunk, in_bytes):
    """(operations, bytes) K6 needs: its declared cost (``ssd_chunked.
    cost``: the causal half of the score and intra products, the inter
    and state products; inputs read, outputs written once, x, B, C and y
    in ``in_bytes``, dt, A and the state in f32)."""
    dt = {2: torch.bfloat16, 4: torch.float32}[in_bytes]
    c = ssd_chunked.cost(meta(B, S, H, P, dtype=dt), meta(B, S, H), meta(H),
                         meta(B, S, 1, N, dtype=dt), meta(B, S, 1, N, dtype=dt),
                         None, chunk)
    return c.flops, c.bytes


def attn_inputs(B, Sq, Skv, Hq, Hkv, D, dev, dtype=torch.float32, seed=0):
    """Random q, k, v (as tests/test_torch_gpu.py makes them)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dev, dtype)
            for shape in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


def attn_agree(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """K5 against its plain version within ATTN_TOL (float32), a bf16
    output within ATTN_TOL plus one bf16 ulp; returns the max abs error."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    allowed = ATTN_TOL * (1 + b.abs())
    if got.dtype == torch.bfloat16:
        allowed = allowed + bf16_ulp(b)
    err = diff.max().item()
    print(f"   K5 {name}: max abs err {err:.3e} (max |plain| "
          f"{b.abs().max().item():.3f})")
    if got.dtype != want.dtype or not bool(a.isfinite().all()) or not bool(
            (diff <= allowed).all()):
        raise AssertionError(f"K5 {name}: differs from its plain version "
                             f"beyond the tolerance")
    return err


def attn_cost(B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset, in_bytes):
    """(operations, bytes) of the attention function: K5's declared cost
    (``flash_attention.cost``: 4 D flops a head for every allowed (query,
    key) pair, the score and its share of P V; q, k and v read and o
    written once)."""
    dt = {2: torch.bfloat16, 4: torch.float32}[in_bytes]
    kv = meta(B, Skv, Hkv, D, dtype=dt)
    c = flash_attention.cost(meta(B, Sq, Hq, D, dtype=dt), kv, kv, causal,
                             window, q_offset)
    return c.flops, c.bytes


def k5_tiles(Sq, Skv, causal, window, q_offset, block=64) -> int:
    """The 64 x 64 (query, key) tiles K5's bf16 kernel computes a head: for
    each 64-row half of a CTA, the key tiles from the window's start to the
    causal end (the Pallas kernel's grid visits all of them)."""
    tiles = 0
    for q0 in range(0, Sq, block):
        q_first, q_last = q_offset + q0, q_offset + min(q0 + block, Sq) - 1
        hi = min(Skv, q_last + 1) if causal else Skv
        lo = max(0, q_first - window + 1) if window is not None else 0
        if hi > lo:
            tiles += -(-(hi - (lo // block) * block) // block)
    return tiles


def k5_grid(Sq, Skv, Hq, causal, window, q_offset, sms) -> tuple:
    """The bf16 kernel's grid in 64 x 64 tile products (a tile of a
    warpgroup): the heaviest CTA's, an even share of all over ``sms`` SMs,
    and the makespan of the CTAs issued in the kernel's order (heads
    fastest, the last q blocks first when causal), each SM taking the next
    CTA when its last one ends: the share of the time load balance sets."""
    loads = []
    for q0 in range(0, Sq, 128):
        loads.append(sum(k5_tiles(min(64, Sq - r), Skv, causal, window,
                                  q_offset + r) for r in (q0, q0 + 64)
                         if r < Sq))
    order = loads[::-1] if causal else loads
    ends = [0] * sms
    for load in (x for x in order for _ in range(Hq)):
        i = ends.index(min(ends))
        ends[i] += load
    return max(loads), sum(loads) * Hq / sms, max(ends)


def sass_counts(lib_path: Path, kernel: str) -> dict:
    """{function: (HGMMA, UTMALDG)}: the wgmma and TMA-load instructions in
    the SASS of each function of the built library whose name holds
    ``kernel`` (``cuobjdump -sass``, beside nvcc)."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name is not None and kernel in name:
            hgmma, tma = counts.get(name, (0, 0))
            counts[name] = (hgmma + ("HGMMA" in line),
                            tma + ("UTMALDG" in line))
    return counts


def bitwise(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs diff {err})")
    return err


# the main paths' three full-size graphs (checked against the numpy
# oracle), and a graph whose puts reach every rank (K4 against its plain
# version only)
ORACLE_GRAPHS = ("stencil", "nearest", "memory")
GRAPHS = {
    "stencil": dict(pattern="stencil", kernel="compute",
                    iterations=MAIN_ITERS),
    "nearest": dict(pattern="nearest", kernel="compute",
                    iterations=MAIN_ITERS, radix=5),
    "memory": dict(pattern="stencil", kernel="memory", iterations=MEM_ITERS,
                   scratch_bytes=MEM_SCRATCH),
    "spread": dict(pattern="spread", kernel="compute", iterations=MAIN_ITERS,
                   radix=5),
    "sweep": dict(pattern="sweep", kernel="compute", iterations=MAIN_ITERS),
    # a payload that torch-auto sends to torch-csp[comm=onesided] (phase 11)
    "stencil_4096B": dict(pattern="stencil", kernel="compute",
                          iterations=MAIN_ITERS, output_bytes=4096),
}


def full_size(name: str, height: int = HEIGHT):
    return make_graph(width=WIDTH, height=height,
                      **{"output_bytes": 16, **GRAPHS[name]})


def oracle(name: str, height: int = HEIGHT) -> np.ndarray:
    return execute_reference(full_size(name, height))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    # the numpy oracle of the three graphs takes ~30 s of CPU: it runs in
    # worker processes while the card works
    with ProcessPoolExecutor(len(ORACLE_GRAPHS),
                             mp_context=get_context("spawn")) as pool:
        oracles = {name: pool.submit(oracle, name) for name in ORACLE_GRAPHS}
        oracles.update({(name, HOST_HEIGHT): pool.submit(oracle, name,
                                                         HOST_HEIGHT)
                        for name in ORACLE_GRAPHS})
        oracles["sweep"] = pool.submit(oracle, "sweep")
        oracles["stencil_4096B"] = pool.submit(oracle, "stencil_4096B")
        kernels = run_phases(full_size("stencil"), full_size("nearest"),
                             full_size("memory"), oracles)
    print(f"\ntotal time {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(stencil, nearest, memory, oracles: dict) -> list:
    dev = torch.device("cuda")

    # -- 1. the card ---------------------------------------------------
    t0 = phase("1. card")
    card = smi("name,power.limit")
    print(card)
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    peak_flops, peak_bf16 = card_peaks(sms, max_mhz)
    print(f"   SMs {sms}, max SM clock {max_mhz:.0f} MHz, fp32 peak "
          f"{peak_flops / 1e12:.3f} TFLOP/s (SMs x 128 lanes x 2 x clock), "
          f"bf16 tensor-core peak {peak_bf16 / 1e12:.3f} TFLOP/s (SMs x "
          f"{BF16_FLOP_PER_SM_CLOCK} x clock), HBM {HBM_BYTES_PER_S / 1e12} "
          f"TB/s (data sheet)")
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    done(t0)

    # -- 2. the build --------------------------------------------------
    t0 = phase("2. build")
    lib = _build.library()
    print(f"   {_build.library_path().name} built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in _build.log_path().read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "entry function",
                                   "Performance Loss", "warning")):
            print("   " + line.strip())
    print(f"   K3 grid for {WIDTH} tasks: "
          f"{lib.taskbench_fused_blocks(WIDTH, 0, 0)} blocks; K4 holds at "
          f"most {lib.taskbench_onesided_blocks(0)} co-resident ranks; K6 "
          f"uses {lib.ssd_chunked_smem_bytes(64, 128, 128)} bytes of shared "
          f"memory a CTA at P=64, N=128, chunk 128")
    for D in (32, 64, 80, 128, 256):  # dynamic, so ptxas does not count it
        print(f"   K5 at D={D}: {lib.flash_attention_bf16_smem_bytes(D)} "
              f"bytes of shared memory a CTA in bf16 (wgmma, TMA), "
              f"{lib.flash_attention_f32_smem_bytes(D)} in float32")
    for N in (64, 128):
        print(f"   K6 in bf16 at N={N}: "
              f"{lib.ssd_chunked_bf16_smem_bytes(N, 0)} bytes of shared "
              f"memory a CTA in pass (a), "
              f"{lib.ssd_chunked_bf16_smem_bytes(N, 1)} in pass (c)")
    sass = sass_counts(_build.library_path(), "flash_attention_sm90")
    for name, (hgmma, tma) in sorted(sass.items()):
        print(f"   {name}: {hgmma} HGMMA, {tma} UTMALDG instructions (SASS)")
    if len(sass) != 5 or not all(h and t for h, t in sass.values()):
        raise AssertionError(f"K5's bf16 kernels are not all on wgmma and "
                             f"TMA: {sass}")
    sass = sass_counts(_build.library_path(), "ssd_chunked")
    for name, (hgmma, _) in sorted(sass.items()):
        print(f"   {name}: {hgmma} HGMMA instructions (SASS)")
    tensor = {n: h for n, (h, _) in sass.items()
              if "ssd_chunked_state" in n or "ssd_chunked_scan" in n}
    if len(tensor) != 4 or not all(tensor.values()):
        raise AssertionError(f"K6's bf16 passes (a) and (c) are not all on "
                             f"wgmma: {sass}")
    done(t0)

    def bound(flops: float, nbytes: float, peak: float = peak_flops):
        return bound_of(flops, nbytes, peak)

    def declared(fn, *args, **kw):
        """A K1-K4 call's bound from its declared cost: its elementwise
        operations at the fp32 peak, its bytes at HBM's rate."""
        c = fn.cost(*args, **kw)
        return bound(c.ops, c.bytes)

    # -- 3. kernels against their plain versions -----------------------
    t0 = phase("3. kernels vs plain versions on the card")
    rng = np.random.RandomState(0)
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for w, mi in [(8, 12), (16, 40), (32, 7), (WIDTH, MAIN_ITERS),
                  (4 * WIDTH, MAIN_ITERS)]:
        tiles = torch.from_numpy(
            rng.uniform(-1.0, 0.5, (w, 8, 128)).astype(np.float32)).to(dev)
        its = torch.from_numpy(
            rng.randint(0, mi + 1, w).astype(np.int32)).to(dev)
        e = bitwise(f"K1 W={w}", taskbench_compute(tiles, its, mi),
                    taskbench_compute_plain(tiles, its, mi))
        errs["K1"] = max(errs["K1"], e)
        print(f"   K1 W={w} max_iters={mi}: max abs diff {e}")
    span, size, _ = bodies.memory_geometry(memory.kernel)
    for sz, sp, its in [(1024, 128, 7), (2048, 256, 0), (512, 512, 9)]:
        x = (torch.arange(sz, dtype=torch.float32) / sz).to(dev)
        e = bitwise(f"K2 {sz}/{sp}/{its}", taskbench_memory(x, its, sp),
                    taskbench_memory_plain(x, its, sp))
        errs["K2"] = max(errs["K2"], e)
        print(f"   K2 size={sz} span={sp} iterations={its}: max abs diff {e}")
    xm = torch.from_numpy(
        rng.uniform(0, 1, (WIDTH, size)).astype(np.float32)).to(dev)
    itm = torch.from_numpy(rng.randint(0, 40, WIDTH).astype(np.int32)).to(dev)
    e = bitwise("K2 rows", taskbench_memory(xm, itm, span),
                taskbench_memory_plain(xm, itm, span))
    errs["K2"] = max(errs["K2"], e)
    print(f"   K2 ({WIDTH}, {size}) span={span}, per-row iterations 0..39: "
          f"max abs diff {e}")

    def fused_pair(graphs):
        radix = max(1, max(gr.max_radix() for gr in graphs))
        tabs = tables_from_numpy(MegakernelBackend._tables(graphs, radix),
                                 dev)
        kw = dict(kernel=graphs[0].kernel, ngraphs=len(graphs),
                  height=graphs[0].height,
                  payload_elems=graphs[0].payload_elems)
        return tabs, kw, taskbench_fused(*tabs, **kw), \
            taskbench_fused_plain(*tabs, **kw)

    def onesided_pair(graph, ranks):
        plan = plan_comm(graph, ranks, "cols", comm="onesided")
        tabs = onesided_tables_from_numpy(
            *MegakernelBackend._onesided_tables(graph, plan), dev)
        kw = dict(kernel=graph.kernel, height=graph.height,
                  payload_elems=graph.payload_elems)
        return plan, tabs, kw, taskbench_onesided(*tabs, **kw), \
            taskbench_onesided_plain(*tabs, **kw)

    def agree(name, kind, got, want) -> float:
        if kind == "compute_mxu":
            torch.testing.assert_close(got, want, rtol=MXU_RTOL,
                                       atol=MXU_ATOL)
            return (got - want).abs().max().item()
        return bitwise(name, got, want)

    pkw = {"nearest": {"radix": 3}, "spread": {"radix": 3}}
    for kind in ("empty", "compute", "memory", "compute_mxu"):
        worst = 0.0
        for pat in pattern_names():
            extra = ({"scratch_bytes": 2048, "span_bytes": 512}
                     if kind == "memory" else {})
            gr = make_graph(width=6, height=8, pattern=pat, kernel=kind,
                            iterations=9, imbalance=0.5,
                            **pkw.get(pat, {}), **extra)
            for graphs in ([gr], replicate(gr, 3)):
                _, _, got, want = fused_pair(graphs)
                worst = max(worst, agree(f"K3 {kind} {pat}", kind, got, want))
        errs["K3"] = max(errs["K3"], worst)
        print(f"   K3 {kind}, every pattern, 1 and 3 graphs (W=6, H=8): "
              f"max abs diff {worst}")
    for name, graphs in (("stencil", [stencil]),
                         ("4 x nearest[radix=5]", replicate(nearest, 4)),
                         ("memory", [memory])):
        _, _, got, want = fused_pair(graphs)
        e = bitwise(f"K3 full size {name}", got, want)
        errs["K3"] = max(errs["K3"], e)
        print(f"   K3 full size {name} (W={WIDTH}, H={HEIGHT}): "
              f"max abs diff {e}")
    # the grid-stride case: more tasks than CTAs, several a CTA a timestep
    blocks = lib.taskbench_fused_blocks(1 << 20, 0, 0)
    stacked = blocks // WIDTH + 1
    _, _, got, want = fused_pair(replicate(nearest, stacked))
    e = bitwise(f"K3 full size {stacked} x nearest[radix=5]", got, want)
    errs["K3"] = max(errs["K3"], e)
    print(f"   K3 full size {stacked} x nearest[radix=5] ({stacked * WIDTH} "
          f"tasks on a grid of {blocks} CTAs): max abs diff {e}")
    for kind in ("empty", "compute", "memory", "compute_mxu"):
        worst = 0.0
        for pat in pattern_names():
            extra = ({"scratch_bytes": 2048, "span_bytes": 512}
                     if kind == "memory" else {})
            for width in (6, 10):
                gr = make_graph(width=width, height=8, pattern=pat,
                                kernel=kind, iterations=9, imbalance=0.5,
                                **pkw.get(pat, {}), **extra)
                for ranks in (2, 4, 8):
                    _, _, _, got, want = onesided_pair(gr, ranks)
                    worst = max(worst, agree(f"K4 {kind} {pat} W={width} "
                                             f"ranks={ranks}", kind, got,
                                             want))
        errs["K4"] = max(errs["K4"], worst)
        print(f"   K4 {kind}, every pattern, W=6 and 10, H=8, 2/4/8 ranks: "
              f"max abs diff {worst}")
    for name, ranks in (("stencil", 4), ("stencil", WIDTH),
                        ("nearest", WIDTH), ("memory", WIDTH), ("spread", 8)):
        plan, _, _, got, want = onesided_pair(full_size(name), ranks)
        e = bitwise(f"K4 full size {name} ranks={ranks}", got, want)
        errs["K4"] = max(errs["K4"], e)
        n_off = len(plan._onesided_offsets) if plan.a2a_cap else 0
        inbox = ranks * HEIGHT * n_off * plan.a2a_cap * 5 * 8
        print(f"   K4 full size {name} ranks={ranks} (W={WIDTH}, H={HEIGHT}"
              f", {n_off} ring offsets, cap {plan.a2a_cap}, inbox of tagged "
              f"words {inbox / 1e6:.3f} MB): max abs diff {e}")
    errs["K6"] = 0.0
    for case in SSD_CASES + (SSD_FULL,):
        *shape, chunk = case
        args = ssd_inputs(*shape, dev)
        errs["K6"] = max(errs["K6"], ssd_agree(
            f"{tuple(shape)} chunk {chunk} f32", ssd_chunked(*args, chunk=chunk),
            ssd_chunked_plain(*args, chunk=chunk)))
    args = ssd_inputs(1, 100, 4, 16, 2, 8, dev)  # ragged: padded to 128
    errs["K6"] = max(errs["K6"], ssd_agree(
        "ragged S=100 chunk 32 (ops.ssd)", ssd_ops.ssd(*args, chunk=32),
        ssd_ops.ssd(*args, chunk=32, impl="plain")))
    # bf16 x, B and C: the tensor-core kernel at every shape above and at
    # every shape serving gives it (SSD_SERVE, the full shape among them),
    # and past its sizes (P > 64, N > 128) the SIMT one
    for case in SSD_CASES + SSD_SERVE + SSD_SIMT_BF16:
        *shape, chunk = case
        args = ssd_inputs(*shape, dev, dtype=torch.bfloat16)
        kind = ("tensor cores" if uses_tensor_cores(args[0], args[3])
                else "SIMT")
        errs["K6"] = max(errs["K6"], ssd_agree(
            f"{tuple(shape)} chunk {chunk} bf16 x/B/C ({kind})",
            ssd_chunked(*args, chunk=chunk),
            ssd_chunked_plain(*args, chunk=chunk)))
    args = ssd_inputs(1, 100, 4, 16, 2, 8, dev, dtype=torch.bfloat16)
    errs["K6"] = max(errs["K6"], ssd_agree(
        "ragged S=100 chunk 32 (ops.ssd) bf16 x/B/C",
        ssd_ops.ssd(*args, chunk=32), ssd_ops.ssd(*args, chunk=32,
                                                  impl="plain")))
    errs["K5"] = 0.0
    for case in ATTN_CASES + ATTN_FULL + ATTN_MOE:
        *shape, causal, window, q_offset = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(*shape, dev, dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            o = flash_attention(q, k, v, **kw)
            errs["K5"] = max(errs["K5"], attn_agree(
                f"{tuple(shape)} causal={causal} window={window} q_offset="
                f"{q_offset} {str(dtype)[6:]}", o,
                flash_attention_plain(q, k, v, **kw)))
            if q_offset < 0 and o[:, :-q_offset].any():
                raise AssertionError("K5: fully masked rows are not 0")
    print(f"   launches so far: K1 {taskbench_compute.launches}, "
          f"K2 {taskbench_memory.launches}, K3 {taskbench_fused.launches}, "
          f"K4 {taskbench_onesided.launches}, K5 "
          f"{flash_attention.launches}, K6 {ssd_chunked.launches}")
    done(t0)

    # -- 4. the structural pin -----------------------------------------
    t0 = phase("4. one CUDA kernel per cuda-fused run, one per graph of a "
               "one-sided run, one graph launch per cuda-graph run "
               "(torch.profiler)")
    fused = get_backend("cuda-fused")
    onesided = get_backend(ONESIDED)
    for label, be, counter, per_graph, key in (
            ("cuda-fused", fused, taskbench_fused, False, "fused_kernel"),
            (ONESIDED, onesided, taskbench_onesided, True,
             "onesided_kernel")):
        for graphs in ([stencil], replicate(stencil, 3)):
            runner = be.prepare_many(graphs)
            runner()
            before = counter.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(PIN_RUNS):
                    runner()
            names = [e.name for e in device_kernels(prof)]
            counted = counter.launches - before
            want = (len(graphs) if per_graph else 1) * PIN_RUNS
            print(f"   {label}, {len(graphs)} graph(s), {PIN_RUNS} runs: "
                  f"profiler CUDA kernels {len(names)} "
                  f"{sorted(set(names))}, launch counter +{counted}")
            if not names:
                raise AssertionError("the profiler recorded no CUDA kernel")
            if len(names) > want or any(key not in n for n in names):
                raise AssertionError(f"expected at most {want} {key} "
                                     f"kernels, the profiler recorded "
                                     f"{names}")
            if counted != want:
                raise AssertionError(f"expected {want} launch(es), counted "
                                     f"{counted}")
    captured = get_backend("cuda-graph")
    for graphs in ([stencil], replicate(stencil, 4)):
        runner = captured.prepare_many(graphs)
        nodes = runner.program.nodes
        runner()
        before = taskbench_compute.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PIN_RUNS):
                runner()
        graph_launches = host_calls(prof, "cudaGraphLaunch")
        kernel_launches = host_calls(prof, "LaunchKernel")
        k1 = device_kernels(prof, "compute_kernel")
        print(f"   cuda-graph, {len(graphs)} graph(s): captured K1/K2 nodes "
              f"{nodes}; {PIN_RUNS} runs: host {len(graph_launches)} "
              f"cudaGraphLaunch, {len(kernel_launches)} kernel launches; "
              f"device {len(device_kernels(prof))} CUDA kernels, {len(k1)} "
              f"K1 {sorted({e.name for e in k1})}; launch counter "
              f"+{taskbench_compute.launches - before}")
        if nodes != {"taskbench_compute": HEIGHT, "taskbench_memory": 0}:
            raise AssertionError(f"expected {HEIGHT} K1 nodes captured a "
                                 f"program, got {nodes}")
        if len(graph_launches) != PIN_RUNS or kernel_launches:
            raise AssertionError(f"expected one cudaGraphLaunch a run and no "
                                 f"kernel launch from the host, got "
                                 f"{graph_launches} and {kernel_launches}")
        if not 1 <= len(k1) <= HEIGHT * PIN_RUNS:
            raise AssertionError(f"expected 1 to {HEIGHT * PIN_RUNS} K1 "
                                 f"kernels on the device, got {len(k1)}")
        if taskbench_compute.launches != before:
            raise AssertionError("a replay launched K1 through its wrapper")
        del runner
    done(t0)

    # -- 5. the main paths at full size --------------------------------
    t0 = phase(f"5. main paths: W={WIDTH}, H={HEIGHT}, torch-scan, "
               f"cuda-graph, cuda-fused, {ONESIDED}")
    scan = get_backend("torch-scan")
    counters = {"K1": taskbench_compute, "K2": taskbench_memory,
                "K3": taskbench_fused, "K4": taskbench_onesided,
                "K5": flash_attention, "K6": ssd_chunked}
    # the path whose launches the kernels line reports for each kernel
    launches_on = {"K1": "torch-scan", "K2": "torch-scan", "K3": "cuda-fused",
                   "K4": ONESIDED, "K5": f"{GEMMA.model} serving",
                   "K6": f"{MAMBA.model} serving"}
    cases = (("stencil", "stencil", [stencil]),
             ("4 x nearest[radix=5]", "nearest", replicate(nearest, 4)),
             ("memory 1 MiB", "memory", [memory]))
    paths = (("torch-scan", scan, ("K1", "K2"), cases),
             ("cuda-graph", captured, ("K1", "K2"), cases),
             ("cuda-fused", fused, ("K3",), cases),
             (ONESIDED, onesided, ("K4",), (cases[0], cases[2])))
    outs, launches = {}, {}
    for be_name, be, path_kernels, path_cases in paths:
        for fn in counters.values():
            fn.launches = 0
        for label, key, graphs in path_cases:
            t1 = time.perf_counter()
            runner = be.prepare_many(graphs)
            t2 = time.perf_counter()
            outs[label, be_name] = runner()
            t3 = time.perf_counter()
            print(f"   {label} on {be_name}: prepare {(t2 - t1) * 1e3:.3f} ms"
                  f", first run {(t3 - t2) * 1e3:.3f} ms")
            if be is captured:
                program = runner.program
                again = runner()
                later = time.perf_counter() - t3
                kernel = ("taskbench_memory" if key == "memory"
                          else "taskbench_compute")
                print(f"     later run {later * 1e3:.3f} ms; captured "
                      f"{program.nodes} kernel nodes; capture "
                      f"{program.capture_s * 1e3:.3f} ms, instantiation "
                      f"{program.instantiate_s * 1e3:.3f} ms; graph pool "
                      f"{program.pool_bytes / 2**20:.3f} MiB")
                if program.nodes[kernel] != HEIGHT:
                    raise AssertionError(f"{label}: expected {HEIGHT} "
                                         f"{kernel} nodes, captured "
                                         f"{program.nodes}")
                if any(not np.array_equal(a, b)
                       for a, b in zip(again, outs[label, be_name])):
                    raise AssertionError(f"{label}: a later replay gave "
                                         f"other outputs")
                if key == "stencil":
                    stencil_graph = runner
            del runner
        counts = {k: fn.launches for k, fn in counters.items()}
        print(f"   launches on the {be_name} path: {counts}"
              + (" (eager warm-up launches and captured nodes; a replay "
                 "counts none)" if be is captured else ""))
        for k in path_kernels:
            if counts[k] == 0:
                raise AssertionError(f"{k} was never launched on the "
                                     f"{be_name} path")
            if launches_on[k] == be_name:
                launches[k] = counts[k]
    for label, key, graphs in cases:
        ref = oracles[key].result()
        names = [p[0] for p in paths if (label, p[0]) in outs]
        for k in range(len(graphs)):
            first = outs[label, names[0]][k]
            for be_name in names:
                out = outs[label, be_name][k]
                check_outputs(graphs[k], out, expected=ref)
                if not np.array_equal(out, first):
                    raise AssertionError(f"{label}: {be_name} differs from "
                                         f"{names[0]}")
        print(f"   {label}: {', '.join(names)} pass check_outputs against "
              f"the oracle and agree bitwise")
    host_paths(scan, oracles, counters)
    done(t0)

    # -- kernel times at the main path's shapes -------------------------
    # the plain K3 and K4 take 1.13-1.44 s a call on the stream: one call a
    # window (five calls each with the warm call and the CUDA-event pass)
    t0 = phase("kernel times at the main path's shapes (cut: one call a "
               "window for the plain K3 and K4)")
    rows = []
    tiles = (0.5 + torch.zeros(WIDTH, 8, 128, device=dev))
    its = torch.full((WIDTH,), MAIN_ITERS, dtype=torch.int32, device=dev)
    rows.append(("K1", timed(lambda: taskbench_compute(tiles, its,
                                                       MAIN_ITERS), 200,
                             kernels_a_call=1),
                 timed(lambda: taskbench_compute_plain(tiles, its,
                                                       MAIN_ITERS), 20),
                 declared(taskbench_compute, tiles, its, MAIN_ITERS), None))
    xs = (1.0 + torch.zeros(WIDTH, size, device=dev))
    itm = torch.full((WIDTH,), MEM_ITERS, dtype=torch.int32, device=dev)
    rows.append(("K2", timed(lambda: taskbench_memory(xs, itm, span), 50,
                             kernels_a_call=1),
                 timed(lambda: taskbench_memory_plain(xs, itm, span), 5),
                 declared(taskbench_memory, xs, itm, span), None))
    tabs, kw, _, _ = fused_pair([stencil])
    rows.append(("K3", timed(lambda: taskbench_fused(*tabs, **kw), 10,
                             kernels_a_call=1),
                 timed(lambda: taskbench_fused_plain(*tabs, **kw), 1),
                 declared(taskbench_fused, *tabs, **kw), None))
    _, otabs, okw, _, _ = onesided_pair(stencil, WIDTH)
    rows.append(("K4", timed(lambda: taskbench_onesided(*otabs, **okw), 10,
                             kernels_a_call=1),
                 timed(lambda: taskbench_onesided_plain(*otabs, **okw), 1),
                 declared(taskbench_onesided, *otabs, **okw), None))
    rows.append(("K5",) + attention_times(dev, bound, peak_bf16, sms))
    rows.append(("K6",) + ssd_times(dev, bound, peak_bf16))
    for name, t, plain, (bs, by), library in rows:
        lib_text = ("" if library is None else
                    f"; library call {library.describe()}")
        print(f"   {name}: {t.describe()}; plain version {plain.describe()}; "
              f"bound {bs * 1e3:.6f} ms ({by}){lib_text}")
    (k3_ms, k3_s), (k4_ms, k4_s) = rows[2][1][:2], rows[3][1][:2]
    print(f"   same graph (stencil, W={WIDTH}, H={HEIGHT}): K3 {k3_ms:.6f} ms "
          f"device ({k3_ms / HEIGHT * 1e3:.4f} us a timestep, signal words), "
          f"K4 at {WIDTH} ranks {k4_ms:.6f} ms ({k4_ms / HEIGHT * 1e3:.4f} "
          f"us a timestep, tagged puts); stream {k3_s:.6f} / {k4_s:.6f} ms")
    # the synchronization floor: the same graph with the empty body
    empty = stencil.with_kernel(KernelSpec(kind="empty"))
    etabs, ekw, _, _ = fused_pair([empty])
    _, eotabs, eokw, _, _ = onesided_pair(empty, WIDTH)
    k3e = timed(lambda: taskbench_fused(*etabs, **ekw), 10,
                kernels_a_call=1)
    k4e = timed(lambda: taskbench_onesided(*eotabs, **eokw), 10,
                kernels_a_call=1)
    print(f"   empty body, same graph: K3 {k3e.device / HEIGHT * 1e3:.4f} us "
          f"a timestep, {k3e.describe()}; K4 at {WIDTH} ranks "
          f"{k4e.device / HEIGHT * 1e3:.4f} us a timestep, {k4e.describe()}")
    _, otabs4, okw4, _, _ = onesided_pair(stencil, 4)
    k4r4 = timed(lambda: taskbench_onesided(*otabs4, **okw4), 5,
                 kernels_a_call=1)
    print(f"   K4 at 4 ranks ({WIDTH // 4} tasks a CTA a timestep): "
          f"{k4r4.device / HEIGHT * 1e3:.4f} us a timestep, "
          f"{k4r4.describe()}")
    graph_times(stencil_graph, scan.prepare_many([stencil]),
                lambda: taskbench_compute(tiles, its, MAIN_ITERS), rows[0][1],
                rows[0][3][0])
    del stencil_graph
    print(f"   ({card})")
    for fn in counters.values():
        fn.launches = 0  # timing launches are not main-path launches
    done(t0)

    # -- 6. METG on the card --------------------------------------------
    t0 = phase(f"6. METG: stencil/compute W={WIDTH} H={HEIGHT} (torch-host "
               f"H={HOST_METG_HEIGHT}), iterations 4096 -> 1")
    results = {}
    for be_name in ("cuda-fused", ONESIDED, "cuda-graph", "torch-scan",
                    "torch-host"):
        height = HOST_METG_HEIGHT if be_name == "torch-host" else HEIGHT
        t1 = time.perf_counter()
        res = run_scenario(metg_spec(be_name, height, sms))
        results[be_name] = res
        metg = res.metg_s
        print(f"   {be_name} (H={height}, {time.perf_counter() - t1:.3f} s):"
              f" METG {metg * 1e6 if metg else None} us "
              f"(granularity = wall x {sms} SMs / tasks), peak "
              f"{res.peak_rate:.6e} FLOP/s")
        for p in sorted(res.points, key=lambda p: -p.iterations):
            print(f"     iterations {p.iterations:5d}: wall {p.wall_time:.6e} s"
                  f", granularity {p.granularity * 1e6:.6f} us, "
                  f"efficiency {p.efficiency:.4f}")
    common = max(r.peak_rate for r in results.values())
    for be_name, res in results.items():
        m = compute_metg(res.points, peak_rate=common).metg
        print(f"   {be_name} against the best rate of the five "
              f"({common:.6e} FLOP/s): METG {m * 1e6 if m else None} us")
    print(f"   ({card})")
    done(t0)

    launches["K6"] = serve_phase(MAMBA, "7", dev, card, counters)
    launches["K5"] = serve_phase(GEMMA, "8", dev, card, counters)
    study_phase(card)
    rank_launches = csp_phase(
        {"stencil": [stencil], "nearest": replicate(nearest, 4),
         "memory": [memory]}, oracles,
        {key: outs[label, "torch-scan"] for label, key, _ in cases},
        results, sms, card, counters)
    planner_launches = planner_phase(
        (("stencil", "stencil", [stencil]),
         ("4 x nearest[radix=5]", "nearest", replicate(nearest, 4)),
         ("memory 1 MiB", "memory", [memory]),
         ("stencil 4096 B", "stencil_4096B", [full_size("stencil_4096B")])),
        oracles, results, sms, card, counters)
    dense_phase(dev, card)
    moe_launches = moe_phase(dev, card, counters, bound, peak_bf16, sms)
    train = train_phase(dev, card, counters, bound, peak_bf16, sms)
    dp = dp_phase(dev, card, counters)
    cost_phase(dev, card, sms, max_mhz, results, dp["single_step_s"])

    meta = {
        "K1": ("taskbench_compute", "src/repro_torch/kernels/csrc/compute.cu",
               "src/repro/kernels/compute.py:23"),
        "K2": ("taskbench_memory", "src/repro_torch/kernels/csrc/memory.cu",
               "src/repro/kernels/memory.py:26"),
        "K3": ("taskbench_fused", "src/repro_torch/kernels/csrc/fused.cu",
               "src/repro/backends/megakernel.py:79"),
        "K4": ("taskbench_onesided",
               "src/repro_torch/kernels/csrc/onesided.cu",
               "src/repro/backends/megakernel.py:142"),
        "K5": ("flash_attention",  # timed in bf16, the main path's type
               "src/repro_torch/kernels/csrc/flash_attention_sm90.cuh",
               "src/repro/kernels/flash_attention.py:29"),
        "K6": ("ssd_chunked",  # timed in bf16, the main path's type
               "src/repro_torch/kernels/csrc/ssd_sm90.cuh",
               "src/repro/kernels/ssd.py:25"),
    }
    return [{"name": meta[k][0], "route": "cuda", "source": meta[k][1],
             "replaces": meta[k][2], "launches": launches[k],
             "launches_on": launches_on[k],
             "rank_launches": rank_launches.get(k, {}),
             "planner_launches": planner_launches.get(k, 0),
             "moe_launches": moe_launches[k],
             "train_launches": train["launches"][k],
             "dp_launches": dp["dp"][k], "pp_launches": dp["pp"][k],
             "max_abs_err": errs[k], "ms": ms, "plain_ms": pms,
             "bound_ms": bs * 1e3, "bound_by": by,
             "library_ms": None if lib is None else lib.device,
             **({"shapes": train["shapes"]} if k == "K5" else {})}
            for k, (ms, *_), (pms, *_), (bs, by), lib in rows]


def host_paths(scan, oracles: dict, counters: dict) -> None:
    """``torch-host``, static and stealing, on the three cases cut to
    HOST_HEIGHT: each output against the numpy oracle of the cut graph and
    bitwise against ``torch-scan`` on it; the launch counts, zeroed just
    before each run and read just after, K1 (or K2) once a task, H x W a
    graph; on stencil the wall a task of static and steal in turns
    (static, steal, steal, static: each first run and a later one); then
    one profiled window of a stencil run cut to HOST_PROFILE_HEIGHT: the
    PyTorch kernels, host launches and kernel time a task."""
    cases = (("stencil", "stencil", 1), ("4 x nearest[radix=5]", "nearest", 4),
             ("memory 1 MiB", "memory", 1))
    for label, key, n in cases:
        graphs = replicate(full_size(key, HOST_HEIGHT), n)
        tasks = sum(g.num_tasks for g in graphs)
        ref = oracles[key, HOST_HEIGHT].result()
        want = scan.prepare_many(graphs)()
        kernel = "K2" if key == "memory" else "K1"
        runners, walls = {}, {}
        for spec in HOSTS:
            runners[spec] = get_backend(spec).prepare_many(graphs)
            for fn in counters.values():
                fn.launches = 0
            t1 = time.perf_counter()
            outs = runners[spec]()
            walls[spec] = [(time.perf_counter() - t1) / tasks * 1e6]
            counts = {k: fn.launches for k, fn in counters.items()}
            expect = {k: tasks if k == kernel else 0 for k in counts}
            if counts != expect:
                raise AssertionError(f"{label} on {spec}: launches {counts}, "
                                     f"expected {expect} (one {kernel} a "
                                     f"task, H x W a graph)")
            for g, out, w in zip(graphs, outs, want):
                check_outputs(g, out, expected=ref)
                if not np.array_equal(out, w):
                    raise AssertionError(f"{label} on {spec}: differs from "
                                         f"torch-scan")
            print(f"   {label}, H={HOST_HEIGHT}, on {spec}: {tasks} tasks, "
                  f"launches {counts}")
        if key == "stencil":
            for spec in reversed(HOSTS):
                t1 = time.perf_counter()
                runners[spec]()
                walls[spec].append((time.perf_counter() - t1) / tasks * 1e6)
        for spec in HOSTS:
            print(f"   {label} on {spec}: wall a task (host clock) "
                  f"{', '.join(f'{w:.3f}' for w in walls[spec])} us")
        del runners
        print(f"   {label}: torch-host static and steal pass check_outputs "
              f"against the oracle of the cut graphs and agree bitwise with "
              f"torch-scan")
    g = full_size("stencil", HOST_PROFILE_HEIGHT)
    runner = get_backend(HOSTS[0]).prepare([g])
    runner()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        runner()
        wall = time.perf_counter() - t1
    kern = device_kernels(prof)
    launches = host_calls(prof, "LaunchKernel")
    busy = sum(e.time_range.elapsed_us() for e in kern)
    n = g.num_tasks
    print(f"   profiled window, stencil H={HOST_PROFILE_HEIGHT} on torch-host "
          f"({n} tasks): {len(kern) / n:.3f} CUDA kernels a task recorded, "
          f"{len(launches) / n:.3f} kernel launches a task from the host, "
          f"kernel time {busy / n:.3f} us a task in {wall / n * 1e6:.3f} us "
          f"of wall a task under the profiler (idle share "
          f"{1 - busy / 1e6 / wall:.3f})")
    by_name = {}
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    for name, d in sorted(by_name.items(), key=lambda kv: -len(kv[1])):
        print(f"     {len(d) / n:.3f} a task, mean {sum(d) / len(d):.4f} us: "
              f"{name[:110]}")


def study_phase(card: str) -> None:
    """The load-imbalance study (paper §V-G) on the card: every
    ``imbalance_study_specs()`` cell (``torch-host`` static and stealing,
    imbalance 0 to 2, the two schedules in turns) through ``run_scenario``
    with the wall clock, each
    result written by ``write_bench_json`` into ``build/bench`` and read
    back through the schema check; the elapsed times and
    ``mitigation_curve``."""
    t0 = phase("9. load-imbalance study on the card: torch-host static vs "
               "steal, wall clock")
    outdir = ROOT / "build" / "bench"
    results = {}
    # static and steal in turns at each imbalance, so the host's drift
    # over the phase falls on both schedules alike
    for spec in sorted(imbalance_study_specs(), key=lambda c: c.imbalance):
        res = run_scenario(spec)
        doc = read_bench_json(write_bench_json(res, str(outdir)))
        if doc["scenario"]["backend"] != spec.backend or \
                doc["points"][0]["wall_time_s"] != elapsed_s(res):
            raise AssertionError(f"{spec.name}: the artifact read back is "
                                 f"not the result written")
        results[spec.imbalance, spec.name.split(".")[2]] = res
        print(f"   {spec.name}: elapsed {elapsed_s(res):.6e} s "
              f"({spec.width} x {spec.height} tasks, best of "
              f"{spec.sweep.repeats}), artifact read back")
    for p in mitigation_curve(results):
        print(f"   {p.variant} imbalance {p.x}: elapsed {p.elapsed_s:.6e} s, "
              f"rate {p.rate:.6e}, mitigation factor {p.metric:.6f}")
    print(f"   ({card})")
    done(t0)


def mps_status() -> str:
    """Whether an MPS control daemon runs here (the process list), and the
    card's compute mode."""
    names = set()
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                comm = (d / "comm").read_text().strip()
            except OSError:
                continue
            if comm.startswith("nvidia-cuda-mps"):
                names.add(comm)
    found = (f"running ({', '.join(sorted(names))})" if names
             else "not running")
    return f"MPS control daemon {found}; compute mode {smi('compute_mode')}"


def split(stats: list) -> str:
    """Each rank's split of one run (host clock): body, waiting for the
    device, staging copies, gloo, the rest; with a profiled run's device
    kernel and copy time and the device's idle share."""
    lines = []
    for r, st in enumerate(stats):
        wall = st["wall_s"]
        parts = {k: st[k] for k in ("body_s", "sync_s", "stage_s", "gloo_s")}
        rest = wall - sum(parts.values())
        text = ", ".join(f"{k[:-2]} {v * 1e3:.3f} ms ({v / wall:.3f})"
                         for k, v in parts.items())
        line = (f"     rank {r}: wall {wall * 1e3:.3f} ms: {text}, rest "
                f"{rest * 1e3:.3f} ms ({rest / wall:.3f}, packing rows); {st['ops']} gloo "
                f"ops, {st['copies']} staging copies of {st['bytes']} bytes")
        prof = st.get("profile")
        if prof is not None:
            busy = prof["kernel_s"] + prof["copy_s"]
            line += (f"; profiler: {prof['kernels']} kernels "
                     f"{prof['kernel_s'] * 1e3:.3f} ms, {prof['copies']} "
                     f"copies {prof['copy_s'] * 1e3:.3f} ms, device idle "
                     f"share {1 - busy / wall:.3f}")
        lines.append(line)
    return "\n".join(lines)


def csp_phase(cases: dict, oracles: dict, scan_outs: dict, metg: dict,
              sms: int, card: str, counters: dict) -> dict:
    """``torch-csp`` and ``torch-pipeline`` with RANKS rank processes
    sharing the card, rows staged through host buffers over gloo: each
    mode of ``CSP_MODES`` on the three main cases (the 4 nearest graphs as
    one combined ``run_many`` program), the ranks' launch counts zeroed
    just before each run and read just after (K1 or K2 exactly H a rank a
    graph), every output against the oracle and bitwise against
    ``torch-scan``'s of phase 5, ``run_many`` against ``run`` (halo); the
    one-sided mode bitwise against K4 (``cuda-fused[comm=onesided,
    ranks=RANKS]``); ``torch-pipeline`` on the sweep graph (ring mode).
    Then the wall a timestep beside ``torch-scan``'s in turns, one
    profiled run split a rank, METG, and the payload study
    (``payload_study_specs("torch-csp")``, each spec's backend given
    ``ranks=RANKS``).  Returns the ranks' K1/K2 counts of the stencil and
    memory runs for the kernels line."""
    t0 = phase(f"10. message passing: torch-csp and torch-pipeline, {RANKS} "
               f"rank processes sharing the card over gloo")
    print(f"   {mps_status()}")
    print(f"   host: os.cpu_count() {os.cpu_count()}, this process's CPU "
          f"affinity {sorted(os.sched_getaffinity(0))}")
    free0 = torch.cuda.mem_get_info()[0]
    t1 = time.perf_counter()
    pool = get_backend(CSP_MODES["halo"]).pool()
    mems = pool.call(csp.rank_memory)
    started = time.perf_counter() - t1
    free1 = torch.cuda.mem_get_info()[0]
    print(f"   {RANKS} ranks started in {started:.3f} s: "
          + "; ".join(f"rank {r} pid {i['pid']} CPUs {i['affinity']}"
                      for r, i in enumerate(pool.info)))
    print(f"   the card's free memory fell {(free0 - free1) / 2**20:.1f} MiB "
          f"as the ranks started ({(free0 - free1) / RANKS / 2**20:.1f} MiB "
          f"a rank's context); each rank's allocator holds "
          f"{[m['reserved'] for m in mems]} bytes")
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                           "used_memory", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"   nvidia-smi compute apps (pid, memory): "
          f"{apps.splitlines() if apps else 'none listed'}")

    def zero():
        for fn in counters.values():
            fn.launches = 0
        pool.call(csp.reset_launch_counts)

    def read():
        return (pool.call(csp.launch_counts),
                {k: fn.launches for k, fn in counters.items()})

    def check(label, spec, key, graphs, got, ranks_counts, here, wall,
              prep):
        kernel = "K2" if key == "memory" else "K1"
        want = {k: HEIGHT * len(graphs) if k == kernel else 0
                for k in csp.COUNTERS}
        if ranks_counts != [want] * RANKS or any(here.values()):
            raise AssertionError(f"{label} on {spec}: launches {ranks_counts}"
                                 f" on the ranks, {here} here; expected "
                                 f"{want} a rank")
        ref = oracles[key].result()
        for g, out, w in zip(graphs, got, scan_outs[key]):
            check_outputs(g, out, expected=ref)
            if not np.array_equal(out, w):
                raise AssertionError(f"{label} on {spec}: differs from "
                                     f"torch-scan")
        print(f"   {label} on {spec}: prepare {prep * 1e3:.3f} ms, run "
              f"{wall * 1e3:.3f} ms, {wall / HEIGHT * 1e6:.3f} us a "
              f"timestep; launches a rank "
              f"{ranks_counts[0]}; passes check_outputs, bitwise with "
              f"torch-scan")

    labels = {"stencil": "stencil", "nearest": "4 x nearest[radix=5]",
              "memory": "memory 1 MiB"}
    rank_launches, outs, runners = {}, {}, {}
    for mode, spec in CSP_MODES.items():
        be = get_backend(spec)
        for key, graphs in cases.items():
            t1 = time.perf_counter()
            runner = be.prepare_many(graphs)
            prep = time.perf_counter() - t1
            zero()
            t1 = time.perf_counter()
            got = runner()
            wall = time.perf_counter() - t1
            counts, here = read()
            check(labels[key], spec, key, graphs, got, counts, here, wall,
                  prep)
            print(split(runner.stats[0]))
            outs[mode, key] = got
            if mode == "halo" and key != "nearest":
                rank_launches["K2" if key == "memory" else "K1"] = {
                    spec: [c["K2" if key == "memory" else "K1"]
                           for c in counts]}
            if key == "stencil":
                runners[mode] = runner
            del runner
        if mode == "halo":  # the other modes equal halo's outputs
            one = be.run(cases["nearest"][:1])[0]
            if any(not np.array_equal(one, o)
                   for o in outs[mode, "nearest"]):
                raise AssertionError(f"{spec}: run_many differs from run")
            print(f"   {spec}: run_many of the 4 nearest graphs equals run")
    t1 = time.perf_counter()
    k4 = get_backend(f"cuda-fused[comm=onesided,ranks={RANKS}]")
    for key in ("stencil", "memory"):
        if not np.array_equal(k4.run(cases[key])[0], outs["onesided", key][0]):
            raise AssertionError(f"{labels[key]}: {CSP_MODES['onesided']} "
                                 f"differs from K4 at {RANKS} ranks")
    print(f"   {CSP_MODES['onesided']} is bitwise with cuda-fused[comm="
          f"onesided,ranks={RANKS}] (K4) on stencil and memory "
          f"({time.perf_counter() - t1:.3f} s)")

    sweep = full_size("sweep")
    scan = get_backend("torch-scan")
    pipe = get_backend(PIPELINE)
    if pipe.plan(sweep).mode != "ring":
        raise AssertionError("the sweep graph is not in ring mode")
    t1 = time.perf_counter()
    runner = pipe.prepare([sweep])
    prep = time.perf_counter() - t1
    zero()
    t1 = time.perf_counter()
    got = runner()
    wall = time.perf_counter() - t1
    counts, here = read()
    scan_outs = dict(scan_outs, sweep=scan.run([sweep]))
    check("sweep (ring)", PIPELINE, "sweep", [sweep], got, counts, here,
          wall, prep)
    print(split(runner.stats[0]))
    del runner

    # the wall a timestep in turns with torch-scan, then a profiled run
    scan_runner = scan.prepare([cases["stencil"][0]])
    scan_runner()
    walls = {"torch-scan": [], CSP_MODES["halo"]: []}
    order = (["torch-scan"] + [CSP_MODES["halo"]] * CSP_WALL_RUNS
             + ["torch-scan"] * (CSP_WALL_RUNS - 1))
    for name in order:
        fn = scan_runner if name == "torch-scan" else runners["halo"]
        t1 = time.perf_counter()
        fn()
        walls[name].append((time.perf_counter() - t1) / HEIGHT * 1e6)
    for name, w in walls.items():
        print(f"   stencil wall a timestep, {name} (host clock, in turns): "
              f"{', '.join(f'{x:.3f}' for x in w)} us")
    for mode in ("halo", "onesided"):
        t1 = time.perf_counter()
        stats = runners[mode].profile()[0]
        print(f"   profiled run, stencil on {CSP_MODES[mode]} "
              f"({time.perf_counter() - t1:.3f} s), each rank's split:\n"
              f"{split(stats)}")
    del runners, scan_runner

    spec = ScenarioSpec(
        name=f"metg.{CSP_MODES['halo']}.stencil", backend=CSP_MODES["halo"],
        pattern="stencil", kernel="compute", width=WIDTH,
        height=CSP_METG_HEIGHT, cores=sms,
        sweep=SweepControls(iterations_hi=4096, n_points=7, repeats=3,
                            warmup=1))
    t1 = time.perf_counter()
    res = run_scenario(spec)
    metg_s = res.metg_s
    print(f"   METG {CSP_MODES['halo']} (H={CSP_METG_HEIGHT}, "
          f"{time.perf_counter() - t1:.3f} s): "
          f"{metg_s * 1e6 if metg_s else None} us self-normalised, peak "
          f"{res.peak_rate:.6e} FLOP/s")
    for p in sorted(res.points, key=lambda p: -p.iterations):
        print(f"     iterations {p.iterations:5d}: wall {p.wall_time:.6e} s, "
              f"granularity {p.granularity * 1e6:.6f} us, efficiency "
              f"{p.efficiency:.4f}")
    common = max([r.peak_rate for r in metg.values()] + [res.peak_rate])
    m = compute_metg(res.points, peak_rate=common).metg
    print(f"   against the best rate of phase 6 ({common:.6e} FLOP/s): METG "
          f"{m * 1e6 if m else None} us")

    outdir = ROOT / "build" / "bench"
    results = {}
    t1 = time.perf_counter()
    for spec in payload_study_specs("torch-csp"):
        spec = dataclasses.replace(
            spec, backend=f"{spec.backend[:-1]},ranks={RANKS}]")
        res = run_scenario(spec)
        doc = read_bench_json(write_bench_json(res, str(outdir)))
        if doc["scenario"]["backend"] != spec.backend or \
                doc["points"][0]["wall_time_s"] != elapsed_s(res):
            raise AssertionError(f"{spec.name}: the artifact read back is "
                                 f"not the result written")
        results[spec.output_bytes, spec.name.split(".")[2]] = res
        print(f"   {spec.name} on {spec.backend}: elapsed "
              f"{elapsed_s(res):.6e} s (best of {spec.sweep.repeats}), "
              f"artifact read back")
    for p in payload_curve(results):
        print(f"   {p.variant} {int(p.x)} bytes: elapsed {p.elapsed_s:.6e} s,"
              f" overlap efficiency {p.metric:.6f}")
    print(f"   payload study {time.perf_counter() - t1:.3f} s")
    close_pools()
    print(f"   ({card})")
    done(t0)
    return rank_launches


def quietly(main, argv: list) -> str:
    """Run a CLI ``main(argv)`` in this process; its standard output, or
    an AssertionError naming it and its exit code."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    except SystemExit as e:
        raise AssertionError(f"{' '.join(argv)} exited {e.code}:\n"
                             f"{buf.getvalue()[-2000:]}") from None
    return buf.getvalue()


def planner_phase(cases: tuple, oracles: dict, metg: dict, sms: int,
                  card: str, counters: dict) -> dict:
    """``torch-auto`` and the tuner, the runner and the suite: (a) ``--tune
    --timer synthetic`` regenerates the committed table byte for byte; (b)
    ``torch-auto`` at full size on the main cases and a stencil graph of
    4096-byte payloads (a ``torch-csp[comm=onesided]`` winner, one rank
    process on one card), the counts zeroed just before its runs and read
    just after, each output bitwise with its winner's own run and the
    oracle, the host time of a resolve, and the walls of ``torch-auto``
    and of its winner in turns; (c) METG of ``torch-auto`` beside
    ``cuda-fused``'s of phase 6; (d) the runner on the wall clock
    (``bench_metg_patterns`` and ``bench_metg_scaling`` at SCALING_RANKS),
    its artifacts read back through the schema check; (e) a two-family
    suite on the synthetic clock whose rollout byte-compare passes.
    Returns each kernel's launches through ``torch-auto`` (a rank's
    included)."""
    t0 = phase(f"11. planner and campaign (budget {PLANNER_BUDGET_S} s): "
               f"--tune, torch-auto at W={WIDTH} H={HEIGHT}, its METG, the "
               f"runner on the wall clock, a suite")
    out = ROOT / "build" / "planner"
    shutil.rmtree(out, ignore_errors=True)

    # -- (a) the table --------------------------------------------------
    t1 = time.perf_counter()
    quietly(bench_run.main, ["--tune", "--timer", "synthetic",
                             "--artifacts", str(out / "tune")])
    fresh = out / "tune" / "TUNE_torch.json"
    if not filecmp.cmp(fresh, tuner.default_table_path(), shallow=False):
        raise AssertionError("--tune --timer synthetic wrote a table other "
                             "than the committed TUNE_torch.json")
    table = tuner.load_tuning_table(None)
    print(f"   (a) --tune --timer synthetic: {len(table.keys())} entries, "
          f"byte-equal to the committed table "
          f"({time.perf_counter() - t1:.3f} s)")

    # -- (b) torch-auto at full size -------------------------------------
    auto = get_backend("torch-auto")
    for fn in counters.values():
        fn.launches = 0
    runs, rank_k1 = {}, 0
    for label, key, graphs in cases:
        spec = auto.resolve_spec(graphs)
        t1 = time.perf_counter()
        for _ in range(PLANNER_RESOLVES):
            auto.resolve_spec(graphs)
        resolve_us = (time.perf_counter() - t1) / PLANNER_RESOLVES * 1e6
        t1 = time.perf_counter()
        runner = auto.prepare_many(graphs)
        be = auto.delegate(graphs)
        if hasattr(be, "pool"):
            be.pool().call(csp.reset_launch_counts)
        t2 = time.perf_counter()
        got = runner()
        t3 = time.perf_counter()
        if hasattr(be, "pool"):
            ranks = be.pool().call(csp.launch_counts)
            rank_k1 += sum(r["K1"] for r in ranks)
            print(f"     {spec}: {len(ranks)} rank(s), launches {ranks}")
        runs[label] = (spec, runner, got)
        print(f"   (b) {label}: torch-auto resolves to {spec} "
              f"({resolve_us:.3f} us of host a resolve, mean of "
              f"{PLANNER_RESOLVES}); prepare {(t2 - t1) * 1e3:.3f} ms, first "
              f"run {(t3 - t2) * 1e3:.3f} ms")
    counts = {k: fn.launches for k, fn in counters.items()}
    counts["K1"] += rank_k1
    print(f"   launches on the torch-auto path: {counts} (K1 in the ranks: "
          f"{rank_k1})")
    winners = {spec for spec, _, _ in runs.values()}
    for spec, k in (("cuda-fused", "K3"), ("torch-csp[comm=onesided]",
                                           "K1")):
        if spec not in winners:
            raise AssertionError(f"no case resolved to {spec}: {winners}")
        if counts[k] == 0:
            raise AssertionError(f"{k} was never launched on the torch-auto "
                                 f"path (winner {spec})")
    for label, key, graphs in cases:
        spec, runner, got = runs[label]
        winner = get_backend(spec).prepare_many(graphs)
        want = winner()
        ref = oracles[key].result()
        for g, a, b in zip(graphs, got, want):
            check_outputs(g, a, expected=ref)
            if not (np.array_equal(a, b) and np.array_equal(a, ref)):
                raise AssertionError(f"{label}: torch-auto differs from its "
                                     f"winner {spec} or the oracle")
        walls = {"torch-auto": [], spec: []}
        for _ in range(PLANNER_WALL_RUNS):
            for name, fn in (("torch-auto", runner), (spec, winner),
                             (spec, winner), ("torch-auto", runner)):
                t1 = time.perf_counter()
                fn()
                walls[name].append(time.perf_counter() - t1)
        a, w = (float(np.median(walls[n])) * 1e3 for n in walls)
        print(f"     {label}: bitwise with {spec}'s own run and the oracle; "
              f"wall a run (median of {2 * PLANNER_WALL_RUNS}, in turns): "
              f"torch-auto {a:.3f} ms, {spec} {w:.3f} ms ({a / w:.4f}x)")
        del winner
    del runs

    # -- (c) METG of torch-auto ------------------------------------------
    t1 = time.perf_counter()
    spec = ScenarioSpec(
        name="metg.torch-auto.stencil", backend="torch-auto",
        pattern="stencil", kernel="compute", width=WIDTH, height=HEIGHT,
        cores=sms, sweep=SweepControls(iterations_hi=4096, n_points=7,
                                       repeats=3, warmup=1))
    res = run_scenario(spec)
    fused = metg["cuda-fused"]
    resolved = sorted({auto.resolve_spec(spec.graphs(it))
                       for it in spec.sweep.iteration_schedule()})
    m = res.metg_s
    print(f"   (c) METG of torch-auto (every point resolves to {resolved}): "
          f"{m * 1e6 if m else None} us; cuda-fused's of phase 6 "
          f"{fused.metg_s * 1e6 if fused.metg_s else None} us "
          f"({time.perf_counter() - t1:.3f} s)")
    for p in sorted(res.points, key=lambda p: -p.iterations):
        print(f"     iterations {p.iterations:5d}: wall {p.wall_time:.6e} s, "
              f"granularity {p.granularity * 1e6:.6f} us, efficiency "
              f"{p.efficiency:.4f}")
    common = max(res.peak_rate, fused.peak_rate)
    m = compute_metg(res.points, peak_rate=common).metg
    print(f"     against the better peak of the two ({common:.6e} FLOP/s): "
          f"METG {m * 1e6 if m else None} us")

    # -- (d) the runner on the wall clock --------------------------------
    for family, backends, extra in (
            ("bench_metg_patterns", "torch-auto,cuda-fused,cuda-graph", []),
            ("bench_metg_scaling", "torch-csp", ["--ranks", SCALING_RANKS])):
        t1 = time.perf_counter()
        arts = out / family
        text = quietly(bench_run.main, [
            "--only", family, "--smoke", "--timer", "wallclock",
            "--backends", backends, "--artifacts", str(arts)] + extra)
        names = sorted(os.listdir(arts))
        for name in names:
            doc = read_bench_json(str(arts / name))
            if doc["kind"] == "metg_scaling" and \
                    [c["devices"] for c in doc["cells"]] != \
                    [int(n) for n in SCALING_RANKS.split(",")]:
                raise AssertionError(f"{name}: cells ran on "
                                     f"{[c['devices'] for c in doc['cells']]}"
                                     f" rank processes")
        argv = " ".join(["--backends", backends] + extra)
        print(f"   (d) --only {family} --smoke --timer wallclock {argv}: "
              f"{len(names)} artifacts, each read back through the schema "
              f"check ({time.perf_counter() - t1:.3f} s)")
        for line in text.splitlines()[1:]:
            if not line.startswith("artifact,"):
                print(f"     {line}")
    close_pools()

    # -- (e) a two-family suite, rollouts byte-compared ------------------
    t1 = time.perf_counter()
    toml = out / "two.toml"
    toml.write_text('name = "two"\nparallel = 3\ntimer = "synthetic"\n'
                    '[[tasks]]\nfamily = "bench_metg_patterns"\n'
                    'rollouts = 2\n[[tasks]]\nfamily = "bench_metg_payload"\n')
    text = quietly(bench_suite.main, [str(toml), "--smoke", "--artifacts",
                                      str(out / "suite")])
    summary = [ln for ln in text.splitlines() if ln.startswith("suite,")]
    if "all ok" not in summary[-1]:
        raise AssertionError(f"suite: {summary}")
    print(f"   (e) suite of bench_metg_patterns (rollouts = 2) and "
          f"bench_metg_payload on the synthetic clock: "
          f"{summary[-1].split(',', 2)[2]}, the rollout byte-equal "
          f"({time.perf_counter() - t1:.3f} s)")
    print(f"   ({card})")
    took = time.perf_counter() - t0
    print(f"   phase time {took:.3f} s of its {PLANNER_BUDGET_S} s budget"
          + ("" if took <= PLANNER_BUDGET_S else " (OVER BUDGET)"),
          flush=True)
    return counts


def graph_times(runner, scan_runner, k1_call, k1_alone: Timing,
                k1_bound: float):
    """K1 as a node of the replayed ``cuda-graph`` stencil run (the median
    of profiled windows, as ``timed`` takes it) beside K1 alone and beside
    K1 as a node of a graph of GRAPH_NODES K1 launches; an empty kernel with
    K1's grid alone and as a node of such a graph, the launch floor K1's
    bytes bound leaves out; the replayed run's device time a timestep and
    its kernels by time; its wall a timestep (replay and the copy to
    numpy, host clock) beside ``torch-scan``'s, WALL_RUNS runs each in
    turns."""
    replay = runner.program.graph.replay
    node = timed(replay, 1, kernels_a_call=1, only="compute_kernel")
    step = timed(replay, 2)
    lib = _build.library()

    def empty():
        _build.check(lib.taskbench_empty_launch(
            WIDTH, torch.cuda.current_device(),
            torch.cuda.current_stream().cuda_stream), "taskbench_empty")

    def as_nodes(fn) -> Timing:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_NODES):
                fn()
        return timed(graph.replay, 1, kernels_a_call=1)

    alone = timed(empty, GRAPH_NODES, kernels_a_call=1)
    empty_node = as_nodes(empty)
    k1_node = as_nodes(k1_call)
    _, by_name = profiled(replay, 1)
    walls = {"cuda-graph": [], "torch-scan": []}
    for _ in range(WALL_RUNS):
        for name, run in (("cuda-graph", runner), ("torch-scan", scan_runner)):
            t = time.perf_counter()
            run()
            walls[name].append((time.perf_counter() - t) / HEIGHT * 1e6)
    print(f"   K1 as a node of the replayed cuda-graph stencil run: "
          f"{node.device * 1e3:.6f} us ({node.describe()}); as a node of a "
          f"{GRAPH_NODES}-node graph of K1 {k1_node.device * 1e3:.6f} us "
          f"({k1_node.stream / GRAPH_NODES * 1e3:.6f} us a node on the "
          f"stream; {k1_node.describe()}); K1 alone "
          f"{k1_alone.device * 1e3:.6f} us; bound {k1_bound * 1e6:.6f} us")
    print(f"   empty kernel with K1's grid ({WIDTH} CTAs of 256 threads): "
          f"alone {alone.device * 1e3:.6f} us ({alone.describe()}); as a node "
          f"of a {GRAPH_NODES}-node graph {empty_node.device * 1e3:.6f} us "
          f"({empty_node.describe()}), "
          f"{empty_node.stream / GRAPH_NODES * 1e3:.6f} us a node on the "
          f"stream")
    print(f"   replayed cuda-graph stencil run: "
          f"{step.recorded / step.reps / HEIGHT:.3f} kernels a timestep, "
          f"kernel time {step.device / HEIGHT * 1e3:.6f} us a timestep, "
          f"on the stream (not profiled) {step.stream / HEIGHT * 1e3:.6f} "
          f"us, first kernel to last under the profiler "
          f"{step.span / HEIGHT * 1e3:.6f} us ({step.describe()})")
    for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1])):
        print(f"     {len(d) / HEIGHT:.3f} a timestep, mean "
              f"{sum(d) / len(d):.4f} us: {name[:110]}")
    for name, w in walls.items():
        print(f"   {name} run wall a timestep (host clock, {WALL_RUNS} runs "
              f"in turns): min {min(w):.6f} us, median "
              f"{float(np.median(w)):.6f} us, each {[round(x, 3) for x in w]}")
    print(f"   torch-scan / cuda-graph wall, medians: "
          f"{np.median(walls['torch-scan']) / np.median(walls['cuda-graph']):.3f}")


def attention_times(dev, bound, peak_bf16: float, sms: int,
                    cases: tuple = ATTN_FULL):
    """K5 at full-width prefill shapes (``cases``; by default
    RecurrentGemma-2B's), bf16, its tensor-core kernel: its device time,
    its plain version's, one scaled_dot_product_attention call computing
    the same function (the yardstick; the port never calls it), the bound
    and the rates reached.  Returns the last case's row (timing, plain,
    bound, library)."""
    for case in cases:
        *shape, causal, window, q_offset = case
        S = shape[1]
        q, k, v = attn_inputs(*shape, dev, torch.bfloat16)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if window is not None and S > window:  # it cuts into the triangle
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, is_causal=mask is None and causal,
                enable_gqa=True)

        plain = flash_attention_plain(q, k, v, **kw).float()
        lib_err = (sdpa().transpose(1, 2).float() - plain).abs().max().item()
        t = timed(lambda: flash_attention(q, k, v, **kw), 20,
                  kernels_a_call=1)
        pt = timed(lambda: flash_attention_plain(q, k, v, **kw), 3)
        lt = timed(sdpa, 20)
        flops, nbytes = attn_cost(*shape, causal, window, q_offset, 2)
        how = ("window mask" if mask is not None else "is_causal" if causal
               else "no mask")
        b16, by = bound(flops, nbytes, peak_bf16)
        B, Sq, Skv, Hq, _, D = shape
        # the products the kernel issues: for each 64-row half of a CTA and
        # each 64-key tile in its band, S = Q K^T over D and P_hi V + P_lo V
        # over D padded to whole 64-column boxes (128 at D = 80)
        tiles = k5_tiles(Sq, Skv, causal, window, q_offset)
        cols = D if D < 64 else -(-D // 64) * 64
        issued = B * Hq * tiles * 2 * 64 * 64 * (D + 2 * cols)
        heavy, even, makespan = k5_grid(Sq, Skv, Hq, causal, window,
                                        q_offset, sms)
        print(f"   K5 at S={S} (B={B}, Hq={Hq}, Hkv={shape[4]}, D={D}, "
              f"window {window}, bf16): {t.describe()}; plain version "
              f"{pt.describe()}; "
              f"scaled_dot_product_attention ({how}, enable_gqa; max abs "
              f"diff from plain {lib_err:.3e}) {lt.describe()}; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB: bound "
              f"{b16 * 1e3:.6f} ms ({by}, bf16 tensor-core peak), K5 reaches "
              f"{b16 * 1e3 / t.device:.3f} of it and is "
              f"{t.device / lt.device:.3f}x the library call; "
              f"{flops / t.device / 1e9:.3f} TFLOP/s of the function, "
              f"{1.5 * flops / t.device / 1e9:.3f} of its 1.5x products "
              f"(P as two bf16 terms); it issues {issued / 1e9:.3f} GFLOP "
              f"({tiles} 64x64 tiles a head, {(D + 2 * cols) / (3 * D):.3f}x "
              f"the products of the exact head size), "
              f"{issued / t.device / 1e9:.3f} TFLOP/s; grid: "
              f"{-(-Sq // 128) * Hq} CTAs, the heaviest {heavy} tile "
              f"products, an even share {even:.1f} an SM, the in-order "
              f"makespan {makespan} ({makespan / even:.3f}x the even share)")
    return t, pt, (b16, by), lt


def ssd_times(dev, bound, peak_bf16: float):
    """K6 at the shapes a ``mamba2-2.7b`` prefill gives it (SSD_SERVE, bf16:
    its tensor-core kernel, three CUDA kernels a call): device time, each
    pass's, the CTAs of each pass and the bound, at the bf16 tensor-core
    peak and at the fp32 rate (the SIMT kernel's).  Returns the
    full-shape row (timing, plain, bound, library): no PyTorch call
    computes the SSD."""
    for case in SSD_SERVE:
        *shape, chunk = case
        B, S, H, P, _, N = shape
        args = ssd_inputs(*shape, dev, dtype=torch.bfloat16)
        t = timed(lambda: ssd_chunked(*args, chunk=chunk), 20,
                  kernels_a_call=3)
        flops, nbytes = ssd_bound(B, S, H, P, N, chunk, 2)
        b16, by = bound(flops, nbytes, peak_bf16)
        b32, by32 = bound(flops, nbytes)
        ctas = B * H * (S // chunk)  # pass (a); (c) has one a 64-row half
        print(f"   K6 at S={S} (chunk {chunk}; B=1, H=80, P=64, G=1, N=128, "
              f"bf16): {t.describe()}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB: bound {b16 * 1e3:.6f} ms ({by}, bf16 "
              f"tensor cores; {b32 * 1e3:.6f} ms, {by32}, at the fp32 rate), "
              f"K6 reaches {b16 * 1e3 / t.device:.3f} of it; grid: {ctas} "
              f"CTAs in pass (a), {B * H * -(-P * N // 4 // 256)} in (b), "
              f"{ctas * -(-chunk // 64)} in (c)")
        if case == SSD_FULL:
            row = (t, timed(lambda: ssd_chunked_plain(*args, chunk=chunk), 3),
                   (b16, by), None)
    return row


def to_float32(tree):
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float32(v) for v in tree]
    return tree.float()


def leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def served(eng, batch):
    """Submit ``batch`` to ``eng`` and drain it; (tokens a request, the
    finished requests, the stats this serve added, wall s)."""
    before = dict(eng.stats)
    rids = [eng.submit(p, max_new_tokens=m) for p, m in batch]
    results, finished = {}, []
    t = time.perf_counter()
    while eng.has_work:
        finished += eng.step(results)
    wall = time.perf_counter() - t
    by_rid = {r.rid: r for r in finished}
    return ([results[r] for r in rids], [by_rid[r] for r in rids],
            {k: v - before[k] for k, v in eng.stats.items()}, wall)


def serve_engines(cfg, params, max_len: int) -> dict:
    """The three engines a serving phase runs: chunked and host with the
    decode step captured, chunked eager (the baseline); the captures'
    times, pools and K5/K6 nodes printed."""
    engines = {}
    for label, mode, graphs in (("chunked captured", "chunked", True),
                                ("host captured", "host", True),
                                ("chunked eager", "chunked", False)):
        t = time.perf_counter()
        engines[label] = eng = ServeEngine(
            cfg, params, batch_slots=SERVE_SLOTS, max_len=max_len,
            chunk_size=SERVE_CHUNK, decode_mode=mode, graphs=graphs)
        p = eng.program
        if graphs:
            print(f"   {label}: engine built in "
                  f"{time.perf_counter() - t:.3f} s, capture "
                  f"{p.capture_s * 1e3:.3f} ms, instantiate "
                  f"{p.instantiate_s * 1e3:.3f} ms, graph pool "
                  f"{p.pool_bytes / 2**20:.3f} MiB, K5/K6 nodes {p.nodes}")
    return engines


def pinned_tick(eng, mode: str) -> int:
    """One decode tick with no admission or completion under the
    profiler: exactly ``steps`` ``cudaGraphLaunch`` calls (one in host
    mode) and no kernel launch from the host; returns the steps."""
    before = eng.stats["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if eng.step() != []:
            raise AssertionError("the pinned tick completed a request")
    steps = eng.stats["decode_steps"] - before
    graphs = len(host_calls(prof, "cudaGraphLaunch"))
    kernels = host_calls(prof, "LaunchKernel")
    copies = len(host_calls(prof, "cudaMemcpy"))
    if graphs != steps or kernels or steps != (
            SERVE_CHUNK if mode == "chunked" else 1):
        raise AssertionError(f"{mode} tick: {steps} steps, {graphs} graph "
                             f"launches, kernel launches {kernels}")
    print(f"   {mode} captured, one tick profiled: {steps} decode steps, "
          f"{graphs} cudaGraphLaunch, no kernel launch from the host, "
          f"{copies} cudaMemcpy calls")
    return steps


def decode_rate(eng, cfg, rng, label: str, pin: str = "") -> float:
    """Tokens/s with every slot live: SERVE_SLOTS 128-token requests
    admitted in one tick, the next tick profiled for the launch pin when
    ``pin`` names the mode, then the rest timed on the host clock (each
    tick ends in a host sync)."""
    for _ in range(SERVE_SLOTS):
        eng.submit(rng.randint(0, cfg.vocab_size, 128).astype(np.int32),
                   max_new_tokens=1 + 6 * SERVE_CHUNK)
    eng.step()
    if pin:
        pinned_tick(eng, pin)
    before = dict(eng.stats)
    t = time.perf_counter()
    while eng.has_work:
        eng.step()
    wall = time.perf_counter() - t
    toks = eng.stats["tokens_generated"] - before["tokens_generated"]
    steps = eng.stats["decode_steps"] - before["decode_steps"]
    print(f"   decode at {SERVE_SLOTS} live slots, {label}: {toks} tokens "
          f"in {steps} steps, {wall:.6f} s, {toks / wall:.3f} tokens/s "
          f"({wall / steps * 1e3:.3f} ms a step)")
    return toks / wall


def serve_phase(case: ServeCase, number: str, dev, card: str,
                counters: dict) -> int:
    """Serve ``case.model`` at full width; returns its kernel's launches on
    the serving path."""
    K = case.kernel
    t0 = phase(f"{number}. serving {case.model} at full width: ServeEngine("
               f"batch_slots={SERVE_SLOTS}, max_len={case.max_len}, "
               f"chunk_size={SERVE_CHUNK}) chunked and host with the decode "
               f"step captured, chunked eager; prompts "
               f"{[n for n, _ in case.reqs]}")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(case.model)
    t1 = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    per_prefill = cfg.pattern_for_depth().count(case.kind)
    print(f"   {case.model}: {cfg.num_layers} layers ({per_prefill} "
          f"{case.kind}), d_model {cfg.d_model}, {n_params} parameters in "
          f"{cfg.dtype}, made from seed 0 in {time.perf_counter() - t1:.3f} s")
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in case.reqs]
    lengths = [len(p) for p, _ in reqs]
    engines = serve_engines(cfg, params, case.max_len)
    chunked = engines["chunked captured"]

    for fn in counters.values():
        fn.launches = 0
    tokens, done_reqs, stats, wall = served(chunked, reqs)
    counts = {k: fn.launches for k, fn in counters.items()}
    print(f"   chunked captured: stats {stats}, {wall:.3f} s; launches on "
          f"the serving path: {counts}")
    longer = sum(n > 1 for n in lengths)
    want = longer * per_prefill
    if counts[K] != want or counts[K] == 0:
        raise AssertionError(f"{K} launched {counts[K]} times on the "
                             f"serving path, expected {want} (one a "
                             f"{case.kind} layer for each prefill of more "
                             f"than one token)")
    print(f"   {K} launches {counts[K]} = {per_prefill} {case.kind} layers x "
          f"{longer} prefills of more than one token ({stats['prefills']} "
          f"prefills; a one-token prompt is a decode step, as in the "
          f"reference)")
    if stats["prefills"] != len(reqs) or stats["tokens_generated"] != sum(
            m for _, m in reqs):
        raise AssertionError(f"unexpected stats {stats}")
    for (p, m), out in zip(reqs, tokens):
        if len(out) != m or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"prompt of {len(p)}: bad output {out}")
    for label in ("host captured", "chunked eager"):
        other, _, other_stats, other_wall = served(engines[label], reqs)
        print(f"   {label}: stats {other_stats}, {other_wall:.3f} s")
        if other != tokens:
            raise AssertionError(f"{label} decode gave other tokens than "
                                 f"chunked captured")
        if label == "chunked eager" and other_stats != stats:
            raise AssertionError(f"chunked eager stats {other_stats}, "
                                 f"captured {stats}")
    print("   chunked captured, host captured and chunked eager give the "
          "same tokens (and the chunked engines the same stats)")
    for n in case.ttft:  # on a warm engine: everything built and loaded
        k = lengths.index(n)
        alone, alone_reqs, _, _ = served(chunked, [reqs[k]])
        if n == 1000 and alone[0] != tokens[k]:
            raise AssertionError("the 1000-token request served alone gave "
                                 "other tokens than in the batch")
        r, b = alone_reqs[0], done_reqs[k]
        same = " gives the batch's tokens;" if n == 1000 else ":"
        print(f"   the {n}-token request alone{same} time to first token "
              f"alone {(r.t_first - r.t_submit) * 1e3:.3f} ms, in the batch "
              f"{(b.t_first - b.t_submit) * 1e3:.3f} ms from submission")

    # decode rate with every slot live, captured beside eager in turns;
    # the captured engines' launches pinned over one tick
    rates = {}
    for label, pin in (("chunked eager", ""),
                       ("chunked captured", "chunked"),
                       ("host captured", "host"),
                       ("chunked captured", ""),
                       ("chunked eager", "")):
        rates.setdefault(label, []).append(
            decode_rate(engines[label], cfg, rng, label, pin))
    cap, eag = (max(rates[k]) for k in ("chunked captured", "chunked eager"))
    print(f"   decode rate captured / eager (best of 2 each): "
          f"{cap:.3f} / {eag:.3f} tokens/s = {cap / eag:.3f}x ({card})")

    # one decode step at 4 slots eager, the same step replayed, and the
    # 1000-token prefill under the profiler: launches, kernel time (the
    # kernel's share), wall, idle share
    k = lengths.index(1000)
    prompt = torch.from_numpy(reqs[k][0].astype(np.int64))[None].to(dev)
    eager = engines["chunked eager"]
    chunked._dev.zero_()  # a chunk's first step (index 0), every slot dead
    for what, fn in (
            (f"one decode step at {SERVE_SLOTS} slots, eager",
             lambda: lm.forward(params, cfg, eager.cur, caches=eager.caches,
                                last_token_only=True)),
            (f"one decode step at {SERVE_SLOTS} slots, replayed",
             chunked.program),
            ("the 1000-token prefill",
             lambda: lm.forward(params, cfg, prompt, caches=init_caches(
                 cfg, 1, case.max_len, device=dev), last_token_only=True))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        kern = device_kernels(prof)
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        mine = [e for e in kern if case.name in e.name]
        mine_ms = sum(e.time_range.elapsed_us() for e in mine) / 1e3
        print(f"   {what}, profiled: {len(kern)} CUDA kernels "
              f"({len(kern) / cfg.num_layers:.1f} a layer), {busy:.3f} ms of "
              f"kernel time ({len(mine)} {K} recorded, {mine_ms:.3f} ms) in "
              f"{wall:.3f} ms of wall (idle share {1 - busy / wall:.3f})")
        if "replayed" in what:
            for line in top_kernels(kern):
                print("     " + line)
    del engines, chunked, eager

    # the prefill logits of the checked prompt, the kernel against its plain
    # version, in the served bf16 forward and in a float32 forward of the
    # same weights
    k = lengths.index(case.logits_len)
    prompt = torch.from_numpy(reqs[k][0].astype(np.int64))[None].to(dev)

    def logits_pair(c, p):
        lg_k, _ = lm.forward(p, c, prompt, last_token_only=True)
        lg_p, _ = lm.forward(p, dataclasses.replace(c, kernel_impl="plain"),
                             prompt, last_token_only=True)
        lg_k, lg_p = lg_k.float(), lg_p.float()
        rel = ((lg_k - lg_p).norm() / lg_p.norm()).item()
        print(f"   {case.logits_len}-token prefill logits, {c.dtype}: {K} "
              f"against its plain version relative L2 {rel:.3e}, max abs "
              f"diff {(lg_k - lg_p).abs().max().item():.6f}, max |logit| "
              f"{lg_p.abs().max().item():.4f}; argmax "
              f"{int(lg_k[0, -1].argmax())} / {int(lg_p[0, -1].argmax())}")
        if lg_k.shape != (1, 1, cfg.vocab_size) or not bool(
                lg_k.isfinite().all()):
            raise AssertionError(f"prefill logits with {K}: shape "
                                 f"{tuple(lg_k.shape)} or not finite")
        return lg_k, rel

    lg_k, rel = logits_pair(cfg, params)
    if rel > LOGITS_BF16_RTOL:
        raise AssertionError(f"bf16 prefill logits with {K} are {rel} "
                             f"(relative L2) from the plain version's, above "
                             f"{LOGITS_BF16_RTOL}")
    if int(lg_k[0, -1].argmax()) != tokens[k][0]:
        raise AssertionError("the served first token is not the argmax of "
                             "the prefill logits")
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = to_float32(params)
    _, rel = logits_pair(c32, p32)
    del p32
    if rel > LOGITS_F32_RTOL:
        raise AssertionError(f"float32 prefill logits with {K} are {rel} "
                             f"(relative L2) from the plain version's, above "
                             f"{LOGITS_F32_RTOL}")
    print(f"   peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB ({card})")
    del params
    release()
    done(t0)
    return counts[K]


def top_kernels(kern: list, n: int = 6) -> list:
    """The ``n`` CUDA kernel names with the most time among the profiler
    events ``kern``: launches, ms and share of the kernel time each."""
    total = sum(e.time_range.elapsed_us() for e in kern) or 1.0
    by_name = {}
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:n]
    return [f"{len(d)} x {sum(d) / 1e3:.3f} ms ({sum(d) / total:.1%}): "
            f"{name[:90]}" for name, d in top]


def release() -> None:
    """Free what a phase's models held on the card: an engine and its
    captured step refer to each other, so only the cycle collector frees
    them."""
    gc.collect()
    torch.cuda.empty_cache()


def dense_phase(dev, card: str) -> None:
    """The serving family and the dense configurations, in at most
    DENSE_BUDGET_S: (a) ``bench_serve_load`` on the wall clock at
    ``--smoke`` (reduced qwen1.5-0.5b), its artifacts read back through
    the schema check; (b) one serve_load cell pair, chunked and host, with
    ``qwen1.5-0.5b`` at full width through ``run_engine_load``; (c)
    ``yi-6b`` and ``minitron-8b`` at full width serving DENSE_REQS, the
    captured and eager chunked engines giving the same tokens, the
    1000-token prompt's time to first token alone and the decode rate at
    4 live slots captured beside eager; (d) ``qwen2-72b`` cut to
    QWEN72_LAYERS of its 80 layers (the whole model does not fit the
    card), one 1000-token prefill and a captured chunk, against eager."""
    t0 = phase(f"12. dense serving and bench_serve_load (budget "
               f"{DENSE_BUDGET_S} s; cuts: the family at --smoke on the "
               f"reduced model, qwen2-72b at {QWEN72_LAYERS} of its 80 "
               f"layers)")
    outdir = ROOT / "build" / "bench" / "serve_load"
    shutil.rmtree(outdir, ignore_errors=True)
    t1 = time.perf_counter()
    quietly(bench_run.main, ["--only", "bench_serve_load", "--smoke",
                             "--artifacts", str(outdir)])
    names = sorted(os.listdir(outdir))
    if len(names) != 6:
        raise AssertionError(f"bench_serve_load wrote {names}")
    print(f"   (a) bench_serve_load --smoke on the wall clock "
          f"({time.perf_counter() - t1:.3f} s), {len(names)} artifacts read "
          f"back:")
    for name in names:
        doc = read_bench_json(str(outdir / name))
        m = doc["metrics"]
        if doc["timer"] != "wallclock" or m["completed"] != \
                doc["scenario"]["num_requests"]:
            raise AssertionError(f"{name}: {doc['timer']}, {m['completed']} "
                                 f"completed")
        print(f"     {doc['scenario']['name']}: {serve_line(m)}")

    t1 = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    print(f"   (b) qwen1.5-0.5b at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.dtype}), the family's rate-2000 "
          f"cells in full:")
    for mode in ("chunked", "host"):
        spec = next(s for s in serve_load_family.specs()
                    if s.name == f"serve_load.{mode}.rate2000")
        res = run_engine_load(spec, cfg, params)
        m = res.metrics
        if m["completed"] != spec.num_requests:
            raise AssertionError(f"{spec.name}: {m['completed']} completed")
        print(f"     {spec.name} ({spec.num_requests} requests): "
              f"{serve_line(m)}")
    print(f"     ({time.perf_counter() - t1:.3f} s)")
    del params
    release()

    for name in ("yi-6b", "minitron-8b"):
        t1 = time.perf_counter()
        dense_model(get_config(name), dev, DENSE_REQS, rates=True)
        print(f"     ({time.perf_counter() - t1:.3f} s)")
    t1 = time.perf_counter()
    cut = dataclasses.replace(get_config("qwen2-72b"),
                              num_layers=QWEN72_LAYERS)
    print(f"   (d) qwen2-72b cut to {cut.num_layers} of its 80 layers, "
          f"{QWEN72_LAYERS / 80:.0%} of its depth")
    dense_model(cut, dev, ((1000, 1 + SERVE_CHUNK),), rates=False)
    print(f"     ({time.perf_counter() - t1:.3f} s)")
    took = time.perf_counter() - t0
    print(f"   phase time {took:.3f} s of its {DENSE_BUDGET_S} s budget "
          f"({card})")
    if took > DENSE_BUDGET_S:
        raise AssertionError(f"phase 12 took {took:.3f} s, over its "
                             f"{DENSE_BUDGET_S} s budget")


def moe_phase(dev, card: str, counters: dict, bound, peak_bf16: float,
              sms: int) -> dict:
    """MoE serving, the a2a path and the dispatch family, in at most
    MOE_BUDGET_S: (a) ``mixtral-8x7b`` cut to MIXTRAL_LAYERS layers serving
    MOE_REQS (a 4500-token prompt past its window of 4096 among them) at
    ``max_len`` MIXTRAL_MAX_LEN, so every layer has a ring cache and every
    prefill runs K5 with the window, the captured and eager chunked engines
    giving the same tokens, time to first token, the decode rate at 4 live
    slots captured beside eager against the step's bytes bound, and the
    4500-token prefill logits with K5 against its plain version; (b)
    ``arctic-480b`` cut to ARCTIC_LAYERS layers: one 1000-token prefill
    and a captured chunk against eager, its decode rate, and the
    1000-token forward without a cache on K5 (GQA group 7) against its
    plain version; the launch counts zeroed just before (a) and read just
    after (b), K5 exactly as many times as those prefills ask and no other
    kernel; K5 timed at ATTN_MOE beside its plain version and SDPA; (c)
    the a2a path on one full-width Mixtral layer (float32, capacity factor
    8) over a pool of RANKS rank processes as (data, model) = (2, 2) and
    (4, 1) in both ep_modes, against the dense path within the reference's
    ``5e-4 max(scale, 1)``, each rank's all-to-all bytes equal to
    ``analytic_a2a_bytes``; (d) ``bench_moe_dispatch`` through the runner.
    Returns the launch counts of (a) and (b)."""
    from repro_torch.bench.moe import MoEDispatchSpec, analytic_a2a_bytes
    from repro_torch.dist.ranks import get_pool
    from repro_torch.models import moe as moe_layer

    t0 = phase(f"13. MoE serving, the a2a path and bench_moe_dispatch "
               f"(budget {MOE_BUDGET_S} s; cuts: mixtral-8x7b at "
               f"{MIXTRAL_LAYERS} of its 32 layers, arctic-480b at "
               f"{ARCTIC_LAYERS} of its 35, the a2a layer in float32 at "
               f"capacity factor 8 on {A2A_TOKENS[0] * A2A_TOKENS[1]} "
               f"tokens)")
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    cut = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=MIXTRAL_LAYERS)
    print(f"   (a) mixtral-8x7b cut to {cut.num_layers} of its 32 layers, "
          f"max_len {MIXTRAL_MAX_LEN}")
    want_k5 = dense_model(cut, dev, MOE_REQS, rates=True,
                          max_len=MIXTRAL_MAX_LEN, logits_len=4500)
    print(f"     ({time.perf_counter() - t1:.3f} s)")
    t1 = time.perf_counter()
    cut = dataclasses.replace(get_config("arctic-480b"),
                              num_layers=ARCTIC_LAYERS)
    print(f"   (b) arctic-480b cut to {cut.num_layers} of its 35 layers")
    want_k5 += dense_model(cut, dev, ((1000, 1 + SERVE_CHUNK),), rates=True,
                           logits_len=1000)
    print(f"     ({time.perf_counter() - t1:.3f} s)")
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"   launches on the MoE serving path: {launches}; K5 expected "
          f"{want_k5} (a layer for each prefill into a ring cache and for "
          f"each forward without a cache)")
    if launches["K5"] != want_k5 or any(
            n for k, n in launches.items() if k != "K5"):
        raise AssertionError(f"MoE serving launched {launches}, K5 "
                             f"expected {want_k5} times and nothing else")
    attention_times(dev, bound, peak_bf16, sms, ATTN_MOE)
    for fn in counters.values():
        fn.launches = 0  # timing launches are not main-path launches

    # -- (c) the a2a path against the dense path --------------------------
    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), dtype="float32",
                              moe_capacity_factor=8.0)
    p = moe_layer.init_moe(torch.Generator(dev).manual_seed(A2A_SEED), cfg,
                           torch.float32, dev)
    B, S = A2A_TOKENS
    x = torch.randn(B, S, cfg.d_model, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    y_d, m_d = moe_layer.apply_moe(p, x, cfg, impl="dense")
    scale = y_d.abs().max().item()
    tol = 5e-4 * max(scale, 1.0)
    pool = get_pool(RANKS, dev)
    print(f"   (c) the a2a path: one mixtral-8x7b layer at full width "
          f"(experts {tuple(p['w_gate'].shape)} float32), {B} x {S} tokens, "
          f"capacity factor {cfg.moe_capacity_factor}; a pool of {RANKS} "
          f"rank processes started in {time.perf_counter() - t1:.3f} s with "
          f"the layer; dense output scale {scale:.4f}, tolerance {tol:.3e}")
    for data, model in A2A_GRIDS:
        t2 = time.perf_counter()
        grid = moe_layer.ExpertGrid(pool, data, model, cfg=cfg,
                                    seed=A2A_SEED)
        print(f"     ({data}, {model}) grid: each rank built the layer "
              f"from the seed and kept its shard in "
              f"{time.perf_counter() - t2:.3f} s")
        for mode in ("replicated", "sp"):
            t2 = time.perf_counter()
            y, m = moe_layer.apply_moe(p, x, cfg, ep_mode=mode, grid=grid)
            wall = time.perf_counter() - t2
            err = (y - y_d).abs().max().item()
            lb = abs(float(m["moe_lb_loss"]) - m_d["moe_lb_loss"].item())
            want = analytic_a2a_bytes(MoEDispatchSpec(
                batch=B, seq=S, data=data, model=model, ep_mode=mode,
                capacity_factor=cfg.moe_capacity_factor), cfg)
            moved = [st["data"]["a2a_bytes"] for st in grid.stats]
            print(f"     ({data}, {model}) {mode}: max abs diff from dense "
                  f"{err:.3e}, lb loss diff {lb:.3e}; all-to-all bytes a "
                  f"rank {moved}, analytic {want['a2a_bytes']:.0f} (cap "
                  f"{want['cap']:.0f}); {wall * 1e3:.3f} ms")
            if not err < tol or not lb < 1e-3 or any(
                    b != want["a2a_bytes"] for b in moved):
                raise AssertionError(f"a2a ({data}, {model}) {mode} "
                                     f"disagrees with dense or the bytes")
        del grid
    del p, x, y_d
    close_pools()
    release()
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    # -- (d) the dispatch family through the runner ------------------------
    t1 = time.perf_counter()
    outdir = ROOT / "build" / "bench" / "moe_dispatch"
    shutil.rmtree(outdir, ignore_errors=True)
    text = quietly(bench_run.main, ["--only", "bench_moe_dispatch",
                                    "--artifacts", str(outdir)])
    rows = [line for line in text.splitlines()
            if line.startswith("moe_dispatch.")]
    written = sorted(os.listdir(outdir)) if outdir.exists() else []
    for data, model in ((4, 2), (2, 4)):
        for mode in ("replicated", "sp"):
            want = analytic_a2a_bytes(MoEDispatchSpec(data=data, model=model,
                                                      ep_mode=mode))
            row = next(r for r in rows
                       if r.startswith(f"moe_dispatch.d{data}m{model}.{mode},"))
            if f"a2a_bytes={want['a2a_bytes']:.0f};" not in row:
                raise AssertionError(f"{row}: not the analytic bytes")
    if len(rows) != 6 or written:
        raise AssertionError(f"bench_moe_dispatch printed {rows}, wrote "
                             f"{written}")
    print(f"   (d) --only bench_moe_dispatch ({time.perf_counter() - t1:.3f}"
          f" s): {len(rows)} rows, the bytes analytic; no artifact (the "
          f"reference family writes none)")
    for row in rows:
        print(f"     {row}")
    took = time.perf_counter() - t0
    print(f"   phase time {took:.3f} s of its {MOE_BUDGET_S} s budget "
          f"({card})")
    if took > MOE_BUDGET_S:
        raise AssertionError(f"phase 13 took {took:.3f} s, over its "
                             f"{MOE_BUDGET_S} s budget")
    return launches


def serve_line(m: dict) -> str:
    return (f"TTFT p50 {m['ttft_s']['p50'] * 1e3:.3f} / p95 "
            f"{m['ttft_s']['p95'] * 1e3:.3f} / p99 "
            f"{m['ttft_s']['p99'] * 1e3:.3f} ms, TPOT p50 "
            f"{m['tpot_s']['p50'] * 1e3:.3f} / p95 "
            f"{m['tpot_s']['p95'] * 1e3:.3f} ms, latency p95 "
            f"{m['latency_s']['p95'] * 1e3:.3f} ms, "
            f"{m['throughput_tok_s']:.3f} tokens/s, "
            f"{m['goodput_rps']:.3f} requests/s, "
            f"{m['host_syncs_per_token']:.4f} syncs a token, makespan "
            f"{m['makespan_s']:.6f} s")


def dense_model(cfg, dev, shape: tuple, rates: bool,
                max_len: int = 0, logits_len: int = 0) -> int:
    """Serve ``shape`` ((prompt tokens, new tokens) a request) with ``cfg``
    at full width through the chunked engine captured and eager: the same
    tokens, the time to first token of the 1000-token prompt, and with
    ``rates`` the decode rate at 4 live slots captured beside eager, next
    to the decode step's bytes bound.  With ``logits_len``, that prompt's
    prefill logits without a cache (K5) against the same forward on K5's
    plain version.  Returns the K5 launches this run makes: one a layer
    for each prefill of more than one token into a ring cache (a full
    cache's prefill runs the attention oracle) and for the K5 forward."""
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    moe = (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok}"
           f"{f' + a dense MLP of {cfg.dense_residual_ff}' if cfg.dense_residual_ff else ''}"
           f", window {cfg.window}" if cfg.num_experts else "")
    print(f"   {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads} kv, d_ff {cfg.d_ff} "
          f"({'gated ' if cfg.mlp_gated else ''}{cfg.act}){moe}, vocab "
          f"{cfg.vocab_size}, {n_params} parameters in {cfg.dtype} "
          f"({torch.cuda.memory_allocated() / 1e9:.3f} GB), made from seed "
          f"0 in {time.perf_counter() - t:.3f} s")
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in shape]
    max_len = max_len or max(n + m for n, m in shape) + 8 * SERVE_CHUNK + 128
    ring = cfg.window is not None and cfg.window < max_len
    engines, served_tokens = {}, {}
    for label, graphs in (("captured", True), ("eager", False)):
        t = time.perf_counter()
        engines[label] = ServeEngine(
            cfg, params, batch_slots=SERVE_SLOTS, max_len=max_len,
            chunk_size=SERVE_CHUNK, graphs=graphs)
        tokens, done_reqs, stats, wall = served(engines[label], reqs)
        p = engines[label].program
        cap = ("" if p is None else
               f"; capture {p.capture_s * 1e3:.3f} ms, instantiate "
               f"{p.instantiate_s * 1e3:.3f} ms, graph pool "
               f"{p.pool_bytes / 2**20:.3f} MiB")
        r = done_reqs[[n for n, _ in shape].index(1000)]
        built = time.perf_counter() - t - wall
        print(f"     {label}: engine built in {built:.3f} s{cap}; served "
              f"in {wall:.3f} s, stats {stats}; the 1000-token request's "
              f"time to first token "
              f"{(r.t_first - r.t_submit) * 1e3:.3f} ms from submission")
        for (pr, m), out in zip(reqs, tokens):
            if len(out) != m or not all(0 <= v < cfg.vocab_size
                                        for v in out):
                raise AssertionError(f"{cfg.name}: prompt of {len(pr)}: bad "
                                     f"output {out}")
        served_tokens[label] = tokens
    if served_tokens["captured"] != served_tokens["eager"]:
        raise AssertionError(f"{cfg.name}: captured and eager decode gave "
                             f"other tokens")
    print("     captured and eager decode give the same tokens")
    k = [n for n, _ in shape].index(1000)
    _, alone, _, _ = served(engines["captured"], [reqs[k]])
    print(f"     the 1000-token request alone on the warm engine: time to "
          f"first token {(alone[0].t_first - alone[0].t_submit) * 1e3:.3f} "
          f"ms")
    if rates:
        got = {label: decode_rate(engines[label], cfg, rng, label)
               for label in ("eager", "captured")}
        # a step reads every parameter once, but for the embedding table
        # (its B rows); the K/V rows it reads are < 0.1 % of that here
        step_bytes = sum(t.numel() * t.element_size()
                         for t in leaves(params)) \
            - params["embed"]["table"].numel() * \
            params["embed"]["table"].element_size()
        bound_s = step_bytes / HBM_BYTES_PER_S
        print(f"     decode rate captured / eager: "
              f"{got['captured'] / got['eager']:.3f}x; the step's bytes "
              f"bound: {step_bytes / 1e9:.3f} GB read at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s = {bound_s * 1e3:.3f} ms, "
              f"{SERVE_SLOTS / bound_s:.3f} tokens/s at {SERVE_SLOTS} slots; "
              f"captured reaches {got['captured'] * bound_s / SERVE_SLOTS:.3f}"
              f" of it")
    eng = engines["captured"]
    eng._dev.zero_()  # a chunk's first step (index 0), every slot dead
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.program()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kern = device_kernels(prof)
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    print(f"     one decode step at {SERVE_SLOTS} slots replayed, profiled: "
          f"{len(kern)} CUDA kernels ({len(kern) / cfg.num_layers:.1f} a "
          f"layer), {busy:.3f} ms of kernel time in {wall:.3f} ms of wall; "
          f"the kernels that take most of it:")
    for line in top_kernels(kern):
        print("       " + line)
    del eng
    prefills = sum(e.stats["prefills"] for e in engines.values())
    del engines
    k5 = cfg.num_layers * prefills if ring else 0
    if logits_len:
        k = [n for n, _ in shape].index(logits_len)
        prompt = torch.from_numpy(reqs[k][0].astype(np.int64))[None].to(dev)
        lg_k, _ = lm.forward(params, cfg, prompt, last_token_only=True)
        lg_p, _ = lm.forward(params, dataclasses.replace(
            cfg, kernel_impl="plain"), prompt, last_token_only=True)
        k5 += cfg.num_layers
        lg_k, lg_p = lg_k.float(), lg_p.float()
        rel = ((lg_k - lg_p).norm() / lg_p.norm()).item()
        print(f"     {logits_len}-token prefill logits without a cache: K5 "
              f"against its plain version relative L2 {rel:.3e}, max abs "
              f"diff {(lg_k - lg_p).abs().max().item():.6f}, max |logit| "
              f"{lg_p.abs().max().item():.4f}; argmax "
              f"{int(lg_k[0, -1].argmax())} / {int(lg_p[0, -1].argmax())}, "
              f"served first token {served_tokens['captured'][k][0]}")
        if lg_k.shape != (1, 1, cfg.vocab_size) or not bool(
                lg_k.isfinite().all()) or rel > LOGITS_BF16_RTOL:
            raise AssertionError(f"{cfg.name}: prefill logits with K5 are "
                                 f"{rel} (relative L2) from the plain "
                                 f"version's, or not finite")
        if ring and int(lg_k[0, -1].argmax()) != \
                served_tokens["captured"][k][0]:
            raise AssertionError(f"{cfg.name}: the served first token is not "
                                 f"the argmax of the K5 prefill logits")
    print(f"     peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del params
    release()
    return k5


# ------------------------------------------------------------ 14. training
def grad_agree(name: str, kernel, plain, inputs: list, counter) -> float:
    """Gradients of a fixed linear function of ``kernel(*inputs)`` (its
    outputs dotted with seeded weights, summed) against the same through
    ``plain``: within GRAD_RTOL of each input's largest plain gradient,
    and not zero (the kernel's wrapper cut no graph).  Returns the max abs
    difference; ``counter`` must count one launch."""
    ins = [t.detach().requires_grad_(True) for t in inputs]
    gen = torch.Generator(ins[0].device).manual_seed(1)

    def scalar(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o.float() * torch.randn(o.shape, generator=gen,
                                            device=o.device)).sum()
                   for o in outs)

    n = counter.launches
    got = torch.autograd.grad(scalar(kernel(*ins)), ins)
    if counter.launches != n + 1:
        raise AssertionError(f"{name}: {counter.launches - n} launches, not 1")
    gen.manual_seed(1)
    want = torch.autograd.grad(scalar(plain(*ins)), ins)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = (g.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        print(f"   {name} d/d input {i} {tuple(w.shape)} {str(w.dtype)[6:]}: "
              f"max abs diff {err:.3e} of max |plain grad| {top:.3e}")
        if not top > 0 or err > GRAD_RTOL * top or not bool(
                g.isfinite().all()):
            raise AssertionError(f"{name}: gradient {i} through the kernel "
                                 f"is zero, not finite or not the plain "
                                 f"path's")
        worst = max(worst, err)
    return worst


def train_phase(dev, card: str, counters: dict, bound, peak_bf16: float,
                sms: int) -> dict:
    """Training on the card, in at most TRAIN_BUDGET_S: (1) K5 at D = 80
    (ATTN_D80, float32 and bf16) against its plain version, and timed at
    HuBERT's encoder shape beside its plain version and SDPA; (2) the
    gradients through K5 and K6 against the plain path's; (3)
    ``hubert-xlarge`` whole (48 layers, bf16, remat "full") trained
    HUBERT_STEPS steps through ``make_train_step`` on ``make_batch``
    embeddings, the counts zeroed before each step and read after, its
    first step against the same step on K5's plain version; (4)
    ``qwen2-vl-2b`` whole: a forward on embeddings, on K5 and on its plain
    version, and text requests served captured and eager; (5) the
    ``Trainer`` on HuBERT at TRAINER_LAYERS layers, full width: a run with
    a failure injected, restarted, against an uninterrupted run, bit for
    bit; (6) a Mamba-2 train step at MAMBA_TRAIN_LAYERS of its 64 layers,
    full width, K6 under autograd.  Returns {"launches": {K: a training
    step's launches}, "shapes": [K5's D = 80 row]}."""
    t0 = phase(f"14. training (budget {TRAIN_BUDGET_S} s; cuts: the Trainer "
               f"on hubert-xlarge at {TRAINER_LAYERS} of its 48 layers, "
               f"Mamba-2 at {MAMBA_TRAIN_LAYERS} of its 64)")

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    # (1) K5 at D = 80
    t1 = time.perf_counter()
    for case in ATTN_D80:
        *shape, causal, window, q_offset = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(*shape, dev, dtype)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            attn_agree(f"{tuple(shape)} causal={causal} {str(dtype)[6:]}",
                       flash_attention(q, k, v, **kw),
                       flash_attention_plain(q, k, v, **kw))
    t80, p80, (b80, by80), l80 = attention_times(dev, bound, peak_bf16, sms,
                                                 cases=ATTN_D80[:1])
    print(f"   (1) ({time.perf_counter() - t1:.3f} s)")

    # (2) gradients through K5 and K6
    t1 = time.perf_counter()
    *shape, causal, _, _ = ATTN_D80[0]
    grad_agree(f"K5 {tuple(shape)} bf16", lambda q, k, v: flash_attention(
        q, k, v, causal=causal), lambda q, k, v: flash_attention_plain(
        q, k, v, causal=causal), attn_inputs(*shape, dev, torch.bfloat16),
        flash_attention)
    grad_agree("K5 (2, 300, 300, 8, 2, 64) causal float32",
               flash_attention, flash_attention_plain,
               attn_inputs(2, 300, 300, 8, 2, 64, dev), flash_attention)
    *shape, chunk = SSD_FULL
    for dtype in (torch.bfloat16, torch.float32):
        args = ssd_inputs(*shape, dev, dtype=dtype)
        grad_agree(f"K6 {tuple(shape)} chunk {chunk} {str(dtype)[6:]}",
                   lambda *a: ssd_chunked(*a, chunk=chunk),
                   lambda *a: ssd_chunked_plain(*a, chunk=chunk), args,
                   ssd_chunked)
    print(f"   (2) ({time.perf_counter() - t1:.3f} s)")

    # (3) hubert-xlarge, whole
    t1 = time.perf_counter()
    cfg = get_config("hubert-xlarge")
    B, S = HUBERT_BATCH
    tcfg = TS.TrainConfig(warmup_steps=0, total_steps=100)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      embed_dim=cfg.d_model)
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_state(cfg, tcfg, torch.Generator(dev).manual_seed(0), dev)
    n_params = sum(t.numel() for t in leaves(state.params))
    print(f"   (3) {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, non-causal, remat {cfg.remat!r}, {n_params} "
          f"parameters in {cfg.dtype} (AdamW: float32 master, mu, nu), "
          f"state {torch.cuda.memory_allocated() / 1e9:.3f} GB; batch "
          f"{B} x {S} frames of make_batch embeddings")
    batch0 = TS.to_device(make_batch(dcfg, 0), dev)
    plain_cfg = dataclasses.replace(cfg, kernel_impl="plain")
    zero()
    grads, m = TS.compute_grads(state.params, batch0, plain_cfg, tcfg)
    plain_loss, plain_gnorm = float(m["loss"]), float(global_norm(grads))
    if read()["K5"]:
        raise AssertionError("the plain step launched K5")
    del grads, m
    step = TS.make_train_step(cfg, tcfg)
    walls, per_step = [], []
    for i in range(HUBERT_STEPS):
        batch = make_batch(dcfg, i)
        torch.cuda.synchronize()
        zero()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        walls.append(time.perf_counter() - t)
        got = read()
        per_step.append(got)
        gnorm = float(m["grad_norm"])
        print(f"     step {i}: loss {loss:.6f}, total {float(m['total_loss']):.6f}"
              f", grad norm {gnorm:.6f}, lr {float(m['lr']):.3e}, wall "
              f"{walls[-1] * 1e3:.3f} ms, launches {got}")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"{cfg.name}: step {i} loss {loss}, grad "
                                 f"norm {gnorm}")
        if i == 0:
            first = (loss, gnorm)
    # the forward and the remat recompute of every layer, nothing else
    want = dict.fromkeys(counters, 0) | {"K5": 2 * cfg.num_layers}
    if any(p != want for p in per_step):
        raise AssertionError(f"{cfg.name}: launches a step {per_step}, "
                             f"expected {want}")
    dl = abs(first[0] - plain_loss) / abs(plain_loss)
    dg = abs(first[1] - plain_gnorm) / plain_gnorm
    print(f"     step 0 on K5's plain version: loss {plain_loss:.6f}, grad "
          f"norm {plain_gnorm:.6f}; K5's step is {dl:.3e} (loss) and "
          f"{dg:.3e} (grad norm) from it, relative (tolerances "
          f"{TRAIN_LOSS_RTOL}, {TRAIN_GNORM_RTOL})")
    if dl > TRAIN_LOSS_RTOL or dg > TRAIN_GNORM_RTOL:
        raise AssertionError(f"{cfg.name}: the first step on K5 is not the "
                             f"plain version's")
    wall = float(np.median(walls[1:]))
    tokens = B * S
    flops = 6 * n_params * tokens
    print(f"     a step (median of steps 1..{HUBERT_STEPS - 1}): "
          f"{wall * 1e3:.3f} ms, {tokens / wall:.1f} tokens/s; "
          f"{want['K5']} K5 launches a step; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; 6 N tokens = "
          f"{flops / 1e12:.3f} TFLOP a step (N = {n_params}, attention and "
          f"the remat recompute not counted) at {flops / wall / 1e12:.3f} "
          f"TFLOP/s: {flops / wall / peak_bf16:.4f} of the bf16 dense peak "
          f"({peak_bf16 / 1e12:.1f} TFLOP/s: SMs x "
          f"{BF16_FLOP_PER_SM_CLOCK} x the max SM clock; NVIDIA's H100 SXM "
          f"data sheet gives 989 TFLOP/s at 700 W) ({card})")
    hubert_launches = per_step[0]
    batch = make_batch(dcfg, HUBERT_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t
    kern = device_kernels(prof)
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    k5 = sum(e.time_range.elapsed_us() for e in kern
             if "flash_attention" in e.name) / 1e3
    print(f"     one step profiled: {len(kern)} CUDA kernels, {busy:.3f} ms "
          f"of kernel time in {wall * 1e3:.3f} ms of wall (the device idle "
          f"{max(0.0, 1 - busy / (wall * 1e3)):.1%}); K5 {k5:.3f} ms "
          f"({k5 / busy:.1%}); the kernels that take most of it:")
    for line in top_kernels(kern, 10):
        print("       " + line)
    del state, step, batch0
    release()
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    # (4) qwen2-vl-2b, whole
    t1 = time.perf_counter()
    cfg = get_config("qwen2-vl-2b")
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    emb = torch.randn(1, QWEN_VL_FRAMES, cfg.d_model,
                      generator=torch.Generator(dev).manual_seed(1),
                      device=dev)
    zero()
    lg_k, _ = lm.forward(params, cfg, embeds=emb)
    if read()["K5"] != cfg.num_layers:
        raise AssertionError(f"{cfg.name}: {read()} launches, not one K5 a "
                             f"layer")
    lg_p, _ = lm.forward(params, dataclasses.replace(
        cfg, kernel_impl="plain"), embeds=emb)
    lg_k, lg_p = lg_k.float(), lg_p.float()
    rel = ((lg_k - lg_p).norm() / lg_p.norm()).item()
    print(f"   (4) {cfg.name}: {cfg.num_layers} layers, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} kv (GQA 6), D "
          f"{cfg.head_dim}, one forward on {QWEN_VL_FRAMES} embeddings: "
          f"logits {tuple(lg_k.shape)}, on K5 against its plain version "
          f"relative L2 {rel:.3e} (tolerance {LOGITS_BF16_RTOL})")
    if lg_k.shape != (1, QWEN_VL_FRAMES, cfg.vocab_size) or not bool(
            lg_k.isfinite().all()) or rel > LOGITS_BF16_RTOL:
        raise AssertionError(f"{cfg.name}: logits on embeddings are wrong")
    del params, lg_k, lg_p, emb
    release()
    dense_model(cfg, dev, DENSE_REQS, rates=False, logits_len=1000)
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    # (5) the Trainer: a failure injected, a restart, a bit-exact resume
    t1 = time.perf_counter()
    cut = dataclasses.replace(get_config("hubert-xlarge"),
                              num_layers=TRAINER_LAYERS)
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(d):
        return Trainer(cut, TS.TrainConfig(warmup_steps=1, total_steps=10),
                       DataConfig(vocab_size=cut.vocab_size, seq_len=S,
                                  global_batch=B, embed_dim=cut.d_model),
                       LoopConfig(num_steps=4, ckpt_dir=str(d), ckpt_every=2,
                                  log_every=0), device=dev)

    ref = trainer(root / "a")
    ref.run(0)
    crashed = trainer(root / "b")
    try:
        crashed.run(0, fail_at=3)
        raise AssertionError("the injected failure did not raise")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    saved = ckpt.latest_step(str(root / "b"))
    resumed = trainer(root / "b")
    resumed.run(0)
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}
    got = {m["step"]: m["loss"] for m in resumed.metrics_log}
    size = sum(f.stat().st_size for f in (root / "a" / "step_4").iterdir())
    print(f"   (5) Trainer on {cut.name} cut to {cut.num_layers} layers, "
          f"{B} x {S}: uninterrupted losses {ref_losses}; a run failed at "
          f"step 3 after its save of step {saved}, restarted: losses {got}; "
          f"a checkpoint {size / 1e9:.3f} GB; step times "
          f"{[round(m['time_s'] * 1e3, 3) for m in ref.metrics_log]} ms")
    if saved != 2 or min(got) != 2 or any(
            got[k] != ref_losses[k] for k in got):
        raise AssertionError("the resumed run is not bit-exact with the "
                             "uninterrupted one")
    shutil.rmtree(root, ignore_errors=True)
    del ref, crashed, resumed
    release()
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    # (6) a Mamba-2 train step, K6 under autograd
    t1 = time.perf_counter()
    cut = dataclasses.replace(get_config("mamba2-2.7b"),
                              num_layers=MAMBA_TRAIN_LAYERS)
    Bm_, Sm = MAMBA_BATCH
    tcfg = TS.TrainConfig(warmup_steps=0, total_steps=10)
    state = TS.init_state(cut, tcfg, torch.Generator(dev).manual_seed(0), dev)
    batch = TS.to_device(make_batch(DataConfig(
        vocab_size=cut.vocab_size, seq_len=Sm, global_batch=Bm_), 0), dev)
    zero()
    grads, m = TS.compute_grads(state.params, batch, cut, tcfg)
    k6 = read()
    ssd_grads = {k: float(v.float().abs().sum())
                 for k, v in tree.flatten(grads["blocks_scanned"]["ssd"])}
    gnorm = float(global_norm(grads))
    del grads
    pg, pm = TS.compute_grads(state.params, batch, dataclasses.replace(
        cut, kernel_impl="plain"), tcfg)
    pnorm = float(global_norm(pg))
    del pg
    zero()
    state, sm = TS.make_train_step(cut, tcfg)(state, batch)
    mamba_launches = read()
    print(f"   (6) {cut.name} cut to {cut.num_layers} layers, {Bm_} x {Sm} "
          f"tokens: loss {float(m['loss']):.6f} on K6, "
          f"{float(pm['loss']):.6f} on its plain version; grad norm "
          f"{gnorm:.6f} / {pnorm:.6f}; launches for the gradients {k6}, a "
          f"train step {mamba_launches}; |grad| summed over the SSD block's "
          f"parameters {ssd_grads}; the step's loss {float(sm['loss']):.6f}")
    if k6["K6"] != 2 * cut.num_layers or mamba_launches != k6 or not all(
            v > 0 for v in ssd_grads.values()) or abs(
            float(m["loss"]) - float(pm["loss"])) > TRAIN_LOSS_RTOL * abs(
            float(pm["loss"])) or abs(gnorm - pnorm) > TRAIN_GNORM_RTOL * \
            pnorm or not np.isfinite(float(sm["loss"])):
        raise AssertionError(f"{cut.name}: the train step on K6 is wrong")
    del state, batch
    release()
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    took = time.perf_counter() - t0
    print(f"   phase time {took:.3f} s of its {TRAIN_BUDGET_S} s budget "
          f"({card})")
    if took > TRAIN_BUDGET_S:
        raise AssertionError(f"phase 14 took {took:.3f} s, over its "
                             f"{TRAIN_BUDGET_S} s budget")
    for fn in counters.values():
        fn.launches = 0
    shape = ATTN_D80[0]
    return {"launches": {k: hubert_launches[k] + mamba_launches[k]
                         for k in counters},
            "shapes": [{"shape": dict(zip(
                ("B", "Sq", "Skv", "Hq", "Hkv", "D", "causal", "window",
                 "q_offset"), shape)), "model": "hubert-xlarge",
                "launches": hubert_launches["K5"], "ms": t80.device,
                "plain_ms": p80.device, "bound_ms": b80 * 1e3,
                "bound_by": by80, "library_ms": l80.device}]}


def emulate_dp(cfg, tcfg, batches, ranks: int, dev) -> dict:
    """The data-parallel steps of ``ranks`` ranks emulated in this process
    for both syncs, the ranks' arithmetic written out: each rank's
    gradients of its rows (``compute_grads``), their mean as the sync
    defines it (``psum``: a float32 sum / N in the gradient's dtype;
    ``compressed_psum``: the shared scale max|g| over the ranks / 127,
    round half to even, clamp to 127, an integer sum, one rescale to the
    gradient's dtype, / N), one AdamW step, from seed 0 -> {mode: (losses,
    grad norms, float32 master weights)}.  While both modes' parameters
    are equal (the warm-up's lr is 0 at step 0) they share the ranks'
    gradients."""
    out = {}
    for mode in ("psum", "compressed_psum"):
        gen = torch.Generator(dev).manual_seed(0)
        out[mode] = (TS.init_state(cfg, tcfg, gen, dev), [], [])
    for b in batches:
        shards, prints = None, None
        for mode, (state, losses, gnorms) in out.items():
            if shards is None or tree.fingerprint(state.params) != prints:
                shards = [TS.compute_grads(state.params,
                                           TS.to_device(rows, dev), cfg,
                                           tcfg)
                          for rows in DS.shard_rows(b, ranks)]
                prints = tree.fingerprint(state.params)
            losses.append(float(torch.stack(
                [m["loss"].float() for _, m in shards]).sum() / ranks))
            mean = []
            for gs in zip(*(tree.leaves(g) for g, _ in shards)):
                g32 = [g.float() for g in gs]
                if mode == "compressed_psum":
                    amax = torch.stack([g.abs().max() for g in g32]).max()
                    scale = amax / 127.0 if float(amax) > 0 else amax + 1.0
                    q = sum(torch.clamp(torch.round(g / scale), -127, 127)
                            .to(torch.int64) for g in g32)
                    mean.append((q.float() * scale).to(gs[0].dtype) / ranks)
                else:
                    mean.append((sum(g32) / ranks).to(gs[0].dtype))
            del gs, g32
            lr = warmup_cosine(state.step, tcfg.base_lr, tcfg.warmup_steps,
                               tcfg.total_steps)
            m = adamw.update_(tree.unflatten(state.params, mean), state.opt,
                              state.params, tcfg.adamw, lr=lr)
            gnorms.append(float(m["grad_norm"]))
            state.step.add_(1)
            del mean
        del shards
    return {mode: (losses, gnorms, tree.leaves(state.opt.master))
            for mode, (state, losses, gnorms) in out.items()}


def update_rel_l2(got, want, start, dev) -> float:
    """``|got - want| / |want - start|`` over every leaf (float32 master
    weights, ``start`` the parameters at step 0), a leaf at a time on the
    card."""
    num = den = 0.0
    for g, w, s0 in zip(got, want, start):
        w = w.to(dev)
        num += float((g.to(dev) - w).square().sum(dtype=torch.float64))
        den += float((w - s0.to(dev).float()).square().sum(
            dtype=torch.float64))
    return (num / den) ** 0.5


def dp_phase(dev, card: str, counters: dict) -> dict:
    """Data-parallel training and pipelines, in at most DP_BUDGET_S: (a)
    ``qwen1.5-0.5b`` whole at DP_BATCH over DP_RANKS rank processes, its
    single-device step first (the controller keeps its losses, the
    parameters' fingerprint at step 0, the parameters and float32 master
    weights after DP_STEPS steps, then frees it), both modes emulated in
    this process (``emulate_dp``), then DP_STEPS steps with ``psum`` and
    DP_STEPS with ``compressed_psum``, each from seed 0: the replicas
    start with the controller's bits and hold equal ones after every step,
    the losses, grad norms and updates within the bounds above, each
    rank's split of a step (waiting for the device, staging, gloo, bytes)
    and the bytes against the analytic count, K5's launches a rank step;
    (b) the ``Trainer`` with ``grad_sync="compressed_psum"`` on
    DP_TRAINER_RANKS ranks, qwen1.5-0.5b cut to DP_TRAINER_LAYERS layers: a
    run failed at step 3 and restarted against an uninterrupted one, bit
    for bit; (c) ``pp_forward`` of ``yi-6b`` whole against its
    ``forward``, bit for bit, K5 once a layer a microbatch, and
    ``pp_loss_fn``'s
    gradient on a PP_GRAD_LAYERS-layer cut reaching every stage; (d)
    ``bench_model_step`` at ``--smoke`` through the runner.  Returns
    {"dp": K5's (and the others') launches a rank step, "pp": the
    pipelined forward's}."""
    t0 = phase(f"15. data-parallel training and pipelines (budget "
               f"{DP_BUDGET_S} s; cuts: the DP Trainer on qwen1.5-0.5b at "
               f"{DP_TRAINER_LAYERS} of its 24 layers, the pipelined "
               f"gradient on yi-6b at {PP_GRAD_LAYERS} of its 32)")

    def zero():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counters.items()}

    # (a) the single-device step first, then the emulations, then the ranks
    t1 = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    B, S = DP_BATCH
    tcfg = TS.TrainConfig(**DP_TCFG)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    batches = [make_batch(dcfg, s) for s in range(DP_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_state(cfg, tcfg, torch.Generator(dev).manual_seed(0), dev)
    start_print = tree.fingerprint(state.params)
    start = [t.detach().clone() for t in tree.leaves(state.params)]
    n_params = sum(t.numel() for t in start)
    step = TS.make_train_step(cfg, tcfg)
    single, single_walls = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        single.append(float(m["loss"]))
        single_walls.append(time.perf_counter() - t)
    single_master = tree.leaves(state.opt.master)
    print(f"   (a) {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} parameters in "
          f"{cfg.dtype} (AdamW: float32 master, mu, nu); global batch {B} x "
          f"{S} tokens; train config {DP_TCFG}")
    print(f"     single device, the whole batch: losses {single}, walls "
          f"{[round(w * 1e3, 3) for w in single_walls]} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del state, step, m
    release()
    t2 = time.perf_counter()
    emulated = emulate_dp(cfg, tcfg, batches, DP_RANKS, dev)
    print(f"     emulated in this process ({time.perf_counter() - t2:.3f} "
          f"s): " + "; ".join(f"{k}: losses {v[0]}, grad norms {v[1]}"
                              for k, v in emulated.items()))
    release()
    t2 = time.perf_counter()
    pool = get_pool(DP_RANKS, dev)  # new: earlier phases closed theirs
    print(f"     a pool of {DP_RANKS} rank processes ready in "
          f"{time.perf_counter() - t2:.3f} s; {B // DP_RANKS} rows a rank")
    n_leaves, n_metrics = len(start), len(TS.METRICS)
    lrs = [float(warmup_cosine(torch.tensor(s), tcfg.base_lr,
                               tcfg.warmup_steps, tcfg.total_steps))
           for s in range(DP_STEPS)]
    moved = [any(lr > 0 for lr in lrs[:s]) for s in range(DP_STEPS)]
    dp_launches, walls = None, {}
    for mode in ("psum", "compressed_psum"):
        compress = mode == "compressed_psum"
        t2 = time.perf_counter()
        dp = DS.DataParallel(pool, cfg, tcfg, compress=compress, seed=0)
        if dp.fingerprint() != start_print:
            raise AssertionError(f"{mode}: the replicas built from seed 0 "
                                 f"are not the controller's state")
        print(f"     {mode}: the replicas built from seed 0 in "
              f"{time.perf_counter() - t2:.3f} s, every one the "
              f"controller's bits")
        losses, gnorms, walls[mode] = [], [], []
        for s, b in enumerate(batches):
            t = time.perf_counter()
            m = dp.run_step(b)
            walls[mode].append(time.perf_counter() - t)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            dp.fingerprint()  # raises unless every replica holds its bits
            want = 2 * 4 * (n_params + n_metrics
                            + (n_leaves if compress else 0))
            for r, st in enumerate(dp.stats):
                print(f"       step {s} rank {r}: wall "
                      f"{st['wall_s'] * 1e3:.3f} ms = waiting for the device "
                      f"{st['sync_s'] * 1e3:.3f} + staging "
                      f"{st['stage_s'] * 1e3:.3f} + gloo "
                      f"{st['gloo_s'] * 1e3:.3f} ms (gloo "
                      f"{st['gloo_s'] / st['wall_s']:.1%}) + the rest; "
                      f"{st['ops']} ops, {st['bytes']} bytes staged "
                      f"(analytic {want}); K5 {st['K5']}; peak "
                      f"{st.get('peak_bytes', 0) / 1e9:.3f} GB")
            if any(st["bytes"] != want for st in dp.stats):
                raise AssertionError(f"{mode}: staged bytes are not the "
                                     f"analytic count")
            launches = {k: 0 for k in counters} | {
                "K5": dp.stats[0]["K5"], "K6": dp.stats[0]["K6"]}
            if any(st["K5"] != 2 * cfg.num_layers for st in dp.stats):
                raise AssertionError(f"{mode}: K5 launches a rank step "
                                     f"{[st['K5'] for st in dp.stats]}")
            dp_launches = launches
        master = tree.leaves(dp.params(master=True))
        other = "psum" if compress else "compressed_psum"
        e_losses, e_gnorms, e_master = emulated[mode]
        upd = {k: update_rel_l2(master, v[2], start, dev)
               for k, v in emulated.items()}
        tols = [DP_MOVED_LOSS_TOL if mv and not compress
                else DP_LOSS_TOL[mode] for mv in moved]
        dl = [abs(a - b) for a, b in zip(losses, single)]
        de = max(abs(a - b) for a, b in zip(losses, e_losses))
        dg = max(abs(a - b) / b for a, b in zip(gnorms, e_gnorms))
        line = (f"     {mode}: losses {losses} against the single device's: "
                f"abs diffs {[f'{d:.3e}' for d in dl]} (tolerances {tols}; "
                f"weights moved: {moved}); "
                f"against the emulation's: losses {de:.3e} (tolerance "
                f"{DP_EMU_LOSS_TOL}), grad norms {gnorms} relative "
                f"{dg:.3e} (tolerance {DP_EMU_GNORM_RTOL}), the update's "
                f"relative L2 {upd[mode]:.3e} (tolerance {DP_EMU_RTOL}), "
                f"against {other}'s emulation {upd[other]:.3e} (must "
                f"exceed {DP_EMU_RTOL})")
        ok = (all(d <= t for d, t in zip(dl, tols))
              and de <= DP_EMU_LOSS_TOL and dg <= DP_EMU_GNORM_RTOL
              and upd[mode] <= DP_EMU_RTOL and upd[other] > DP_EMU_RTOL)
        if not compress:
            single_upd = update_rel_l2(master, single_master, start, dev)
            line += (f"; the update against the single device's: relative "
                     f"L2 {single_upd:.3e} (tolerance {DP_UPDATE_RTOL})")
            ok = ok and single_upd <= DP_UPDATE_RTOL
        print(line + f"; walls {[round(w * 1e3, 3) for w in walls[mode]]}"
              f" ms")
        if not ok:
            raise AssertionError(f"{mode}: the data-parallel steps are not "
                                 f"the single-device steps or their "
                                 f"emulation")
        del dp, master
        gc.collect()
    print(f"     a step (the last of {DP_STEPS}): single device "
          f"{single_walls[-1] * 1e3:.3f} ms, psum "
          f"{walls['psum'][-1] * 1e3:.3f} ms, compressed_psum "
          f"{walls['compressed_psum'][-1] * 1e3:.3f} ms ({card})")
    del start, single_master, emulated
    close_pools()
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    # (b) the DP Trainer: a failure injected, a restart, a bit-exact resume
    t1 = time.perf_counter()
    cut = dataclasses.replace(cfg, num_layers=DP_TRAINER_LAYERS)
    root = ROOT / "build" / "dp_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    pool = get_pool(DP_TRAINER_RANKS, dev)
    rows = 2 * DP_TRAINER_RANKS

    def trainer(d, every=100):
        return Trainer(cut, TS.TrainConfig(warmup_steps=1, total_steps=10),
                       DataConfig(vocab_size=cut.vocab_size, seq_len=S,
                                  global_batch=rows),
                       LoopConfig(num_steps=4, ckpt_dir=str(d),
                                  ckpt_every=every, log_every=0),
                       grad_sync="compressed_psum", pool=pool)

    # a save every 2 steps only in the run that fails (a checkpoint is
    # 2.5 GB): the others save their last step only
    ref = trainer(root / "a")
    ref.run(0)
    crashed = trainer(root / "b", every=2)
    try:
        crashed.run(0, fail_at=3)
        raise AssertionError("the injected failure did not raise")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    saved = ckpt.latest_step(str(root / "b"))
    resumed = trainer(root / "b")
    last = resumed.run(0)
    ref_losses = {m["step"]: m["loss"] for m in ref.metrics_log}
    got = {m["step"]: m["loss"] for m in resumed.metrics_log}
    size = sum(f.stat().st_size for f in (root / "a" / "step_4").iterdir())
    print(f"   (b) Trainer(grad_sync='compressed_psum') on {DP_TRAINER_RANKS}"
          f" ranks, {cut.name} cut to {cut.num_layers} layers, {rows} x {S}:"
          f" uninterrupted losses {ref_losses}; a run failed at step 3 after "
          f"its save of step {saved}, restarted: losses {got}; a checkpoint "
          f"{size / 1e9:.3f} GB (written by rank 0); step times "
          f"{[round(m['time_s'] * 1e3, 3) for m in ref.metrics_log]} ms")
    if saved != 2 or min(got) != 2 or last.step != 4 or any(
            got[k] != ref_losses[k] for k in got):
        raise AssertionError("the resumed DP run is not bit-exact with the "
                             "uninterrupted one")
    last.fingerprint()
    shutil.rmtree(root, ignore_errors=True)
    del ref, crashed, resumed, last
    gc.collect()
    close_pools()
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    # (c) yi-6b pipelined
    t1 = time.perf_counter()
    cfg = get_config("yi-6b")
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab_size, PP_BATCH, device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    with torch.no_grad():
        torch.cuda.synchronize()
        zero()
        t = time.perf_counter()
        pp = PP.pp_forward(PP.stack_params_by_stage(params, PP_STAGES), cfg,
                           toks, PP_STAGES, PP_MICRO)
        torch.cuda.synchronize()
        pp_wall = time.perf_counter() - t
        pp_launches = read()
        t = time.perf_counter()
        ref_logits, _ = lm.forward(params, cfg, tokens=toks)
        torch.cuda.synchronize()
        fwd_wall = time.perf_counter() - t
    rel = ((pp.float() - ref_logits.float()).norm()
           / ref_logits.float().norm()).item()
    same = bool(torch.equal(pp, ref_logits))
    print(f"   (c) {cfg.name} whole ({cfg.num_layers} layers, {cfg.dtype}), "
          f"tokens {PP_BATCH}: pp_forward over {PP_STAGES} stages x "
          f"{PP_MICRO} microbatches ({pp_wall * 1e3:.3f} ms) against forward "
          f"({fwd_wall * 1e3:.3f} ms): logits {tuple(pp.shape)}, relative L2 "
          f"{rel:.3e}, bitwise equal (required): {same}; launches "
          f"{pp_launches}")
    want = dict.fromkeys(counters, 0) | {"K5": cfg.num_layers * PP_MICRO}
    if pp_launches != want or not same or not bool(pp.isfinite().all()):
        raise AssertionError(f"{cfg.name}: the pipelined forward is not "
                             f"the forward, or K5 ran {pp_launches}")
    del params, pp, ref_logits
    release()
    cut = dataclasses.replace(cfg, num_layers=PP_GRAD_LAYERS)
    params = PP.stack_params_by_stage(
        lm.init_model(cut, torch.Generator(dev).manual_seed(0), dev),
        PP_GRAD_STAGES)
    pp = tree.tree_map(lambda x: x.detach().requires_grad_(True), params)
    zero()
    total, m = PP.pp_loss_fn(pp, cut, {"tokens": toks, "labels": toks},
                             PP_GRAD_STAGES, PP_GRAD_MICRO)
    grads = dict(zip((k for k, _ in tree.flatten(pp)),
                     torch.autograd.grad(total, tree.leaves(pp))))
    grad_launches = read()
    stage_sums = {k: [float(g[s].float().abs().sum())
                      for s in range(PP_GRAD_STAGES)]
                  for k, g in grads.items()
                  if k.startswith("['blocks_scanned']")}
    smallest = [min(v[s] for v in stage_sums.values())
                for s in range(PP_GRAD_STAGES)]
    print(f"     gradient of pp_loss_fn on {cut.num_layers} layers, "
          f"{PP_GRAD_STAGES} stages x {PP_GRAD_MICRO} microbatches: loss "
          f"{float(m['loss'].detach()):.6f}, launches {grad_launches}; "
          f"|grad| summed a stage, the smallest over the stacked blocks' "
          f"leaves: {smallest}")
    if grad_launches["K5"] != PP_GRAD_LAYERS * PP_GRAD_MICRO or not all(
            np.isfinite(x) and x > 0 for v in stage_sums.values()
            for x in v):
        raise AssertionError(f"{cut.name}: a stage got no gradient, or K5 "
                             f"ran {grad_launches}")
    del params, pp, grads, total, toks
    release()
    print(f"     ({time.perf_counter() - t1:.3f} s)")

    # (d) bench_model_step through the runner
    t1 = time.perf_counter()
    outdir = ROOT / "build" / "bench" / "model_step"
    shutil.rmtree(outdir, ignore_errors=True)
    text = quietly(bench_run.main, ["--only", "bench_model_step", "--smoke",
                                    "--artifacts", str(outdir)])
    rows = [line.split(",", 2) for line in text.splitlines()
            if line.startswith("model_step.")]
    written = sorted(os.listdir(outdir)) if outdir.exists() else []
    print(f"   (d) --only bench_model_step --smoke "
          f"({time.perf_counter() - t1:.3f} s), the wall clock on the card:")
    for name, us, derived in rows:
        print(f"     {name}: {us} us, {derived}")
    if [r[0] for r in rows] != ["model_step.qwen1.5-0.5b.seq16",
                                "model_step.qwen1.5-0.5b.dispatch_floor"] \
            or not all(float(r[1]) > 0 for r in rows) or written:
        raise AssertionError(f"bench_model_step printed {rows}, wrote "
                             f"{written} (the reference's family writes "
                             f"no artifact)")
    took = time.perf_counter() - t0
    print(f"   phase time {took:.3f} s of its {DP_BUDGET_S} s budget "
          f"({card})")
    if took > DP_BUDGET_S:
        raise AssertionError(f"phase 15 took {took:.3f} s, over its "
                             f"{DP_BUDGET_S} s budget")
    for fn in counters.values():
        fn.launches = 0
    return {"dp": dp_launches, "pp": pp_launches,
            "single_step_s": min(single_walls[1:])}


def cost_phase(dev, card: str, sms: int, max_mhz: float, metg: dict,
               single_step_s: float) -> None:
    """Phase 16: the dry-run cost model against the card (see the module
    doc); raises on a failed check or past COST_BUDGET_S."""
    t0 = phase(f"16. the dry-run cost model (budget {COST_BUDGET_S} s; no "
               f"model runs: the walls of phases 6 and 15)")
    _, peak_bf16 = card_peaks(sms, max_mhz)
    print(f"   launch.roofline: {roofline.SMS} SMs at "
          f"{roofline.MAX_SM_CLOCK_HZ / 1e6:.0f} MHz, bf16 peak "
          f"{roofline.PEAK_FLOPS / 1e12:.3f} TFLOP/s, HBM "
          f"{roofline.HBM_BW / 1e12} TB/s, link {roofline.LINK_BW / 1e9} "
          f"GB/s; the card: {sms} SMs at {max_mhz:.0f} MHz, bf16 peak "
          f"{peak_bf16 / 1e12:.3f} TFLOP/s")
    if roofline.SMS != sms or roofline.PEAK_FLOPS != peak_bf16:
        raise AssertionError("launch.roofline's constants are not this "
                             "card's")

    # (a) the meta device's parameter bytes against the card's
    cfg = get_config("qwen1.5-0.5b")
    spec_params, _ = lm.model_spec(cfg)
    meta_bytes = sum(t.numel() * t.element_size()
                     for t in tree.leaves(spec_params))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    params = lm.init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev) - before
    card_bytes = sum(t.numel() * t.element_size()
                     for t in tree.leaves(params))
    print(f"   (a) {cfg.name}: model_spec {meta_bytes} bytes on the meta "
          f"device; init_model holds {card_bytes} bytes of tensors on the "
          f"card, {held} bytes by the allocator")
    del params
    release()
    if not meta_bytes == card_bytes == held:
        raise AssertionError("model_spec's parameter bytes differ from "
                             "what init_model holds on the card")

    # (b) DryRunTimer beside phase 6's walls
    timer = DryRunTimer()
    for be_name in ("cuda-fused", "torch-scan"):
        res = metg[be_name]
        for p in sorted(res.points, key=lambda p: -p.iterations):
            est = timer.measure(be_name, res.spec.graphs(p.iterations))
            print(f"   (b) {be_name}, stencil, iterations {p.iterations:5d}:"
                  f" DryRunTimer {est:.6e} s, phase 6's wall "
                  f"{p.wall_time:.6e} s, ratio {est / p.wall_time:.4f}")
            if est > p.wall_time:
                raise AssertionError(f"{be_name}: the roofline estimate is "
                                     f"above the measured wall")

    # (c) the dry run of phase 15's single-device step
    B, S = DP_BATCH
    shape = InputShape("dp_batch", S, B, "train")
    r = lower_cell(cfg.name, shape, False, accum=1,
                   mesh_spec=((1,), ("data",)))
    terms = roofline.roofline_terms(
        {"flops": r["flops_per_device"], "hbm_bytes":
         r["hbm_bytes_per_device"], "attn_sq_bytes": r["attn_sq_bytes"],
         "collectives": r["collectives"]}, cfg, shape, chips=1)
    print(f"   (c) dry run of {cfg.name}'s train step at {B} x {S} on one "
          f"rank (traced in {r['compile_s']} s on the CPU): "
          f"{r['flops_per_device']:.6e} FLOPs, "
          f"{r['hbm_bytes_per_device']:.6e} HBM bytes (unfused); compute "
          f"{terms['compute_s'] * 1e3:.3f} ms, memory "
          f"{terms['memory_s'] * 1e3:.3f} ms; bound_step_s "
          f"{terms['bound_step_s'] * 1e3:.3f} ms ({terms['dominant']}) "
          f"against phase 15's step {single_step_s * 1e3:.3f} ms, ratio "
          f"{terms['bound_step_s'] / single_step_s:.4f}; useful_ratio "
          f"{terms['useful_ratio']:.4f}, roofline_fraction "
          f"{terms['roofline_fraction']:.4f}")
    if terms["bound_step_s"] > single_step_s:
        raise AssertionError("the dry run's bound_step_s is above the "
                             "measured step")
    took = time.perf_counter() - t0
    print(f"   phase time {took:.3f} s of its {COST_BUDGET_S} s budget "
          f"({card})")
    if took > COST_BUDGET_S:
        raise AssertionError(f"phase 16 took {took:.3f} s, over its "
                             f"{COST_BUDGET_S} s budget")


if __name__ == "__main__":
    sys.exit(main())
