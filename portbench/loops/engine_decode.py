"""Decode through the port's serving engine: every slot of the batch
decoding at once, one client, a closed loop.

The configuration gives the model (``reference.model_numbers``), the
traffic the slots, their prompts' lengths, ``max_len`` and the chunk.
Set-up makes the weights and the prompts from the seed
(``reference.inputs``, ``reference.prompts``), builds the port's
configuration from the file's numbers over its registered one
(``repro_torch.configs``), and hands the weights to
``repro_torch.serve.ServeEngine`` (on a card with ``graphs``: the decode
step captured once and replayed), which admits every slot through its
normal B=1 prefill and decodes one chunk.  A run is one engine chunk of
``chunk`` decode steps over every slot, the next started when the last
returned; it returns, for the checked slots, the position of the chunk's
last step, the chunk's tokens and that step's logits.  The witness run
returns every step's logits of its chunk and the logits of the first
decode step after each checked slot's prompt, kept from set-up; its state
is every token each checked slot has generated.  A run that would pass
``max_len`` raises.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Mapping

import numpy as np
import torch

from portbench import harness

# the port's fields set from the configuration file's keys
FIELDS = {"d_model": "hidden_size", "num_heads": "num_attention_heads",
          "num_kv_heads": "num_key_value_heads", "d_ff": "intermediate_size",
          "dense_residual_ff": "shared_intermediate_size",
          "vocab_size": "vocab_size",
          "num_experts_per_tok": "num_experts_per_tok",
          "ssm_state": "mamba_d_state", "ssm_headdim": "mamba_d_head",
          "ssm_expand": "mamba_expand", "ssm_ngroups": "mamba_n_groups",
          "ssm_conv": "mamba_d_conv", "norm_eps": "rms_norm_eps",
          "embedding_multiplier": "embedding_multiplier",
          "residual_multiplier": "residual_multiplier",
          "logits_scaling": "logits_scaling",
          "attention_scale": "attention_multiplier",
          "num_experts": "num_local_experts",
          "num_layers": "num_hidden_layers"}
KINDS = {"mamba": "ssd_moe", "attention": "moe"}


def port_config(registered, c: Mapping, precision: str):
    """The port's configuration of the model numbers ``c``, over the
    registered one (its name, its own settings)."""
    return dataclasses.replace(
        registered, **{f: c[k] for f, k in FIELDS.items()},
        head_dim=c["hidden_size"] // c["num_attention_heads"],
        block_pattern=tuple(KINDS[k] for k in c["layer_types"]),
        experts_held=tuple(c["experts_held"]), dtype=precision)


def same_tree(a, b, where="params") -> None:
    """Raise unless ``a`` and ``b`` hold tensors of one structure, shape
    and dtype."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            raise ValueError(f"{where}: keys {sorted(a)} != {sorted(b)}")
        for k in b:
            same_tree(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, list):
        if len(a) != len(b):
            raise ValueError(f"{where}: {len(a)} layers, not {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{where}[{i}]")
    elif a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"{where}: {tuple(a.shape)} {a.dtype}, the port "
                         f"builds {tuple(b.shape)} {b.dtype}")


class Loop:
    def __init__(self, config: Mapping, traffic: Mapping, seed: int,
                 device: torch.device):
        from repro_torch.configs import get_config
        from repro_torch.models.model import init_model
        from repro_torch.serve import ServeEngine

        registered = get_config(config["name"])
        self.ref = harness.load_module(
            Path(__file__).resolve().parents[1] / "reference"
            / f"{config['reference']}.py", "reference_" + config["reference"])
        self.graph = g = self.ref.graph_of(config, traffic, seed)
        self.cfg = port_config(registered, g["model"], g["precision"])
        self.device = device
        self.ngraphs = g["slots"]
        self.chunk = C = g["chunk"]
        self.tasks_per_run = g["slots"] * C
        self.params = self.ref.inputs(g, device)
        same_tree(self.params, init_model(self.cfg, None, "meta"))
        self.engine = ServeEngine(self.cfg, self.params,
                                  batch_slots=g["slots"],
                                  max_len=g["max_len"], chunk_size=C,
                                  keep_logits=True)
        prompts, self.slots = self.ref.prompts(g)
        for p in prompts:
            self.engine.submit(p, max_new_tokens=g["max_len"] - len(p))
        self.engine.step()  # every slot's prefill, then one chunk
        self.requests = self.engine.slot_requests
        self.checked = [self.requests[s] for s in self.slots]
        self._index = torch.tensor(self.slots, device=device)
        self.first_pos = np.array([[len(r.prompt)] for r in self.checked])
        self.first_logits = self._logits(0, 1)
        # the traced window's runs: each slot's depth before the chunk, the
        # held pairs it served, the recorder's spans and counters
        self.split_runs: List[Dict] = []

    def _logits(self, first: int, stop: int) -> np.ndarray:
        lg = self.engine.logits[self._index, first:stop]
        return lg.float().cpu().numpy()

    def _positions(self) -> np.ndarray:
        """Each checked slot's position of its last step's input."""
        return np.array([[len(r.prompt) + len(r.out) - 2]
                         for r in self.checked])

    def _step(self) -> None:
        C, most = self.chunk, self.graph["max_len"]
        deepest = max(len(r.prompt) + len(r.out) - 1 for r in self.requests)
        if deepest + C > most:
            raise RuntimeError(f"a run would pass max_len={most}: the "
                               f"deepest slot is at {deepest}")
        self.engine.step()

    def _outputs(self) -> List[np.ndarray]:
        tok = np.array([r.out[-self.chunk:] for r in self.checked])
        return [self._positions(), tok,
                self._logits(self.chunk - 1, self.chunk)]

    def run(self) -> List[np.ndarray]:
        self._step()
        return self._outputs()

    def run_split(self, before, after) -> List[np.ndarray]:
        from repro_torch import trace

        depths = [len(r.prompt) + len(r.out) - 1 for r in self.requests]
        with trace.recording() as rec:
            before.record()
            self._step()
            after.record()
        self.split_runs.append({"depths": depths,
                                "held_pairs": self.engine.held_pairs,
                                "recording": rec})
        return self._outputs()

    def launches(self) -> Dict[str, int]:
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.ssd import ssd_chunked

        return {"k5": flash_attention.launches, "k6": ssd_chunked.launches}

    def kernel_calls(self) -> Dict[str, object]:
        """One layer's expert part (its held experts and the shared
        expert) and one Mamba-2 decode step (``ops.ssd_decode_step``),
        each at the batch's rows, on inputs of the benchmark's own."""
        from repro_torch.kernels import ops
        from repro_torch.models import layers, moe

        cfg, B, dev = self.cfg, self.graph["slots"], self.device
        c = self.graph["model"]
        p = self.params["blocks"][0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.graph["seed"])
        dt = p["moe"]["w_gate"].dtype
        rows = torch.randn((B, 1, cfg.d_model), generator=gen,
                           device=dev).to(dt)
        H, P = c["mamba_n_heads"], c["mamba_d_head"]
        G, N = c["mamba_n_groups"], c["mamba_d_state"]
        x = torch.randn((B, 1, H, P), generator=gen, device=dev).to(dt)
        bm, cm = (torch.randn((B, 1, G, N), generator=gen,
                              device=dev).to(dt) for _ in range(2))
        dts = torch.rand((B, 1, H), generator=gen, device=dev) * 0.1
        a = -torch.exp(p["ssd"]["A_log"])
        state = torch.zeros((B, H, P, N), dtype=torch.float32, device=dev)

        def expert():
            return moe.apply_moe(p["moe"], rows, cfg)[0] \
                + layers.apply_mlp(p["mlp"], rows, cfg)

        def ssm_step():
            return ops.ssd_decode_step(x, dts, a, bm, cm, state,
                                       p["ssd"]["D"])

        return {"expert": expert, "ssm_step": ssm_step}

    def witness_run(self):
        self._step()
        C = self.chunk
        pos = self._positions()
        out = [np.concatenate([self.first_pos, pos - C + 1 + np.arange(C)],
                              axis=1),
               np.array([r.out[-C:] for r in self.checked]),
               np.concatenate([self.first_logits, self._logits(0, C)],
                              axis=1)]
        state = {"slots": list(self.slots),
                 "prompt_lengths": [len(r.prompt) for r in self.checked],
                 "history": [np.array(r.out, np.int64)
                             for r in self.checked]}
        return out, state
