"""Serving engine of the port: slot-granular continuous batching with
chunked decode (the port of ``repro.serve.engine``).

``ServeEngine`` owns a fixed pool of batch slots backed by ONE persistent
slotted cache, allocated at construction and updated in place.  The
request lifecycle is the reference's:

  submit -> (slot frees up) -> unpadded B=1 prefill -> ``write_prompt``
  copies the prefill cache into the freed slot -> slot decodes alongside
  requests admitted earlier -> completion (``max_new_tokens`` or
  ``eos_id``) -> ``reset_slot``.

Decode runs in one of two modes:

  ``"chunked"`` (default) — up to ``chunk_size`` decode steps run back to
    back with no host sync between them, carrying tokens, caches and
    per-slot budgets on the device; then the output buffer, the budgets
    and the count of steps at which some slot was live come back in ONE
    copy.  The host knows every budget, so it runs min(chunk_size, max
    budget) steps; an ``eos_id`` that ends all slots sooner leaves the
    later steps dead, and they are not counted (once every budget is 0 it
    stays 0).  So ``stats`` equal the reference's, whose on-device loop
    stops when every budget is 0.
  ``"host"`` — one step and one device round trip per token, the baseline.

The decode step of the engine's mode reads and writes fixed buffers: the
next token a slot (``cur``), one int64 block holding the RoPE positions,
budgets, eos ids, the chunk's (B, chunk_size) output, the step index, the
live-step count and the (token, held expert) pairs served (a model with
``cfg.experts_held``), and the slot pool; with ``keep_logits``, also each
step's last-token logits in a fixed (B, chunk_size, vocab) buffer
(``logits``) a caller reads after the chunk.  On a CUDA device the engine
captures that one step as a CUDA graph at construction (``program``, a
``backends.dataflow.CapturedProgram``), the counterpart of the reference's
one compiled program a mode.  A chunk is then one host-to-device copy of
the block (positions, budgets and eos ids, the output reset to -1, the
step index and count to 0: a copy, no kernel), ``steps`` replays of the
graph with no sync between them, and one copy back; host mode is one copy
of the positions, one replay and one copy back a token.  The capture runs
on the empty pool: its eager warm-up writes K/V rows, states and cursors,
so every slot is reset and the buffers zeroed after it, and a captured
engine starts as an eager one does.  A capture that fails raises; nothing
falls back to eager.  One graph a step count (1 to ``chunk_size``) would
save only ``steps - 1`` graph launches (microseconds each) a chunk of
milliseconds, at up to ``chunk_size`` captures an engine of ``steps``
times the step's nodes each; so the engine captures one step.

On the CPU the same step runs eagerly (``graphs=False``, the default
there; asking for graphs raises).  On the card ``graphs=False`` runs it
eagerly too, the baseline the captured engine is held to.  Prefill stays
eager: the reference compiles one program a prompt length, and a graph a
length is not worth its capture under random lengths.

Both modes run the same ``model.forward`` step.  The attention layers'
per-slot cursors stay on the device and advance in place each step; the
host keeps a mirror of the positions it uploads once a chunk.
``engine.stats`` counts prefills / decode steps / chunk launches / host
syncs / tokens generated; ``held_pairs`` is the last chunk's count of
(token, held expert) pairs, read back in the chunk's one copy.

While ``trace.recording()`` is on, a chunk is the span ``serve.chunk``
over ``serve.upload`` (the block to the device), ``serve.replay`` (the
steps) and ``serve.download`` (the one copy back), with the counter
``moe.held_pairs`` under it where the model holds experts; an admission
is ``serve.prefill``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import trace
from ..backends.dataflow import CapturedProgram
from ..dist.sharding import constrain
from ..models import model as M
from ..models.cache import (LayerCache, init_caches, reset_slot,
                            stack_caches, write_prompt)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None  # early-stop token (emitted, then stop)
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # wallclock marks (perf_counter seconds) for TTFT/TPOT measurement
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # under sharding rules the vocab is gathered first: DTensor's argmax
    # over a sharded dim reads values on the host
    return torch.argmax(constrain(logits[:, -1], "batch", None), dim=-1)


def serve_step(params, tokens, caches, pos, *, cfg):
    """One decode step for the whole batch: (B, 1) tokens -> (B, 1) next;
    ``caches`` are updated in place.  ``pos`` is an int, a 0-d tensor or
    (B,) per-slot positions."""
    logits, caches = M.forward(params, cfg, tokens, caches=caches, pos=pos,
                               last_token_only=True)
    return _greedy(logits)[:, None], caches


def _with_start(caches, start: torch.Tensor):
    """Attach per-slot start offsets (B,) to the attention layers of
    ``caches``, in place (K/V stay where they are); a stacked cache gets
    them broadcast over its layer dim."""
    def one(c: LayerCache, layer_dim: bool) -> None:
        if c.kind not in ("full", "ring"):
            return
        if layer_dim:  # pre-stacked: every tensor leads with the layer dim
            c.start = start.expand((c.k.shape[0],) + start.shape).clone()
        else:
            c.start = start

    if isinstance(caches, LayerCache):
        one(caches, layer_dim=True)
    else:
        for c in caches:
            one(c, layer_dim=False)
    return caches


def prefill(params, tokens, caches, pos=0, *, cfg, pad=None):
    """Batched prefill; returns ((B, 1) first greedy token, caches), the
    caches updated in place.

    ``pad`` (optional (B,) ints) gives the left-pad width of each row.
    When set, the attention layers store it as a per-slot ``start``: pad
    rows land at negative key positions and are masked out, and the RoPE
    positions are rebased so each row's first real token sits at position
    0, so a padded-batch prefill matches per-row unpadded prefills for
    attention layers.  Recurrent and SSM state still absorbs the pad rows,
    as in the reference; the engine prefills unpadded at B=1.
    """
    if pad is not None:
        pad = torch.as_tensor(np.asarray(pad), dtype=torch.int64,
                              device=tokens.device)
        caches = _with_start(caches, pad)
        pos = pos - pad  # (B,): rebased RoPE positions a row
    return serve_step(params, tokens, caches, pos, cfg=cfg)


def _new_caches(cfg, batch, max_len, device, per_slot_pos=False):
    """Zeroed caches in the layout the model runs: stacked for a scanned
    stack, else a per-layer list (as the reference's engine keeps them)."""
    caches = init_caches(cfg, batch, max_len, per_slot_pos=per_slot_pos,
                         device=device)
    return stack_caches(caches) if M.scanned(cfg) else caches


def _prefill_one(params, tokens, *, cfg, max_len):
    """Unpadded single-request prefill into fresh B=1 caches (scalar
    cursors); returns (the first token as a 0-d device tensor, the
    caches)."""
    caches = _new_caches(cfg, 1, max_len, tokens.device)
    nxt, caches = prefill(params, tokens, caches, cfg=cfg)
    return nxt[0, 0], caches


class ServeEngine:
    """Continuous-batching engine over a persistent slotted cache.

    Args:
      batch_slots: size of the fixed slot pool (the decode batch width).
      max_len: per-slot cache rows; submit() enforces
        len(prompt) + max_new_tokens <= max_len.
      chunk_size: decode steps per host sync in chunked mode.
      decode_mode: "chunked" (1 sync a chunk) or "host" (1 sync a token).
      graphs: capture the decode step as a CUDA graph and replay it
        (default: on a CUDA device, where ``False`` runs it eagerly; the
        CPU has no graphs, and asking for them there raises).
      keep_logits: write each chunked step's last-token logits into
        ``logits`` (B, chunk_size, vocab), in the model's logits dtype.

    The engine runs on the device of ``params``.  ``program`` is the
    captured step (``capture_s``, ``instantiate_s``, ``pool_bytes``), None
    when the step runs eagerly.
    """

    def __init__(self, cfg, params, batch_slots: int = 4, max_len: int = 512,
                 chunk_size: int = 8, decode_mode: str = "chunked",
                 graphs: Optional[bool] = None, keep_logits: bool = False):
        assert cfg.supports_decode, f"{cfg.name} is encoder-only"
        if decode_mode not in ("chunked", "host"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        M.check_supported(cfg)
        self.cfg, self.params = cfg, params
        self.slots = batch_slots
        self.max_len = max_len
        self.chunk_size = int(chunk_size)
        self.decode_mode = decode_mode
        self.device = params["embed"]["table"].device
        on_card = self.device.type == "cuda"
        graphs = on_card if graphs is None else bool(graphs)
        if graphs and not on_card:
            raise ValueError(f"CUDA graphs need a CUDA device; the "
                             f"parameters are on {self.device}")

        # ONE persistent slotted cache for the life of the engine; the
        # attention cursors live in it, on the device, and the layers
        # advance them in place
        self.caches = _new_caches(cfg, batch_slots, max_len, self.device,
                                  per_slot_pos=True)

        B, C = batch_slots, self.chunk_size
        self.cur = torch.zeros((B, 1), dtype=torch.int64, device=self.device)
        # the step's fixed buffers in one block, so that a chunk sets them
        # with one copy and reads them back with one:
        # [pos (B) | rem (B) | eos (B) | out (B*C) | t (1) | live steps (1)
        #  | held pairs (1)]
        n = 3 * B + B * C + 3
        self._host = torch.zeros(n, dtype=torch.int64, pin_memory=on_card)
        self._dev = torch.zeros(n, dtype=torch.int64, device=self.device)
        self._d_pos, self._d_rem, self._d_eos = (
            self._dev[i * B:(i + 1) * B] for i in range(3))
        self._d_out = self._dev[3 * B:3 * B + B * C].view(B, C)
        self._d_t, self._d_live, self._d_held = (
            self._dev[i:i + 1] for i in range(n - 3, n))
        self.held_pairs = 0
        self.logits = None
        if keep_logits:
            self.logits = torch.zeros(
                (B, C, cfg.vocab_size), dtype=params["embed"]["table"].dtype,
                device=self.device)

        step = self._chunk_step if decode_mode == "chunked" else \
            self._host_step
        self.program = None
        if graphs:
            self.program = CapturedProgram(step, self.device)
            for slot in range(B):  # undo the warm-up's writes
                reset_slot(self.caches, slot)
            self.cur.zero_()
            self._dev.zero_()
        self._decode = self.program or step

        self._pos = np.zeros((B,), np.int64)      # host mirror of the cursors
        self._rem = np.zeros((B,), np.int64)      # tokens still owed per slot
        self._eos = np.full((B,), -1, np.int64)   # eos id per slot (-1: none)
        self._slot_req: List[Optional[Request]] = [None] * B
        self._queue: List[Request] = []
        self._next_rid = 0
        self.stats = {"prefills": 0, "decode_steps": 0, "chunk_launches": 0,
                      "host_syncs": 0, "tokens_generated": 0}

    # ------------------------------------------------------- decode steps
    def _chunk_step(self) -> None:
        """One step of a chunk on the fixed buffers.  ``rem`` counts tokens
        still owed (0 = dead slot); emitting ``eos[b]`` (when >= 0) zeroes
        it.  Dead slots keep stepping harmlessly: batch rows are
        independent, and their writes land in rows that ``write_prompt``
        overwrites at the next admission."""
        logits, _ = M.forward(self.params, self.cfg, self.cur,
                              caches=self.caches, pos=self._d_pos,
                              last_token_only=True, held_pairs=self._d_held)
        if self.logits is not None:
            self.logits.index_copy_(1, self._d_t,
                                    logits.to(self.logits.dtype))
        nxt = _greedy(logits)
        rem, eos = self._d_rem, self._d_eos
        live = rem > 0
        self._d_live.add_(live.any())
        self._d_out.index_copy_(1, self._d_t,
                                torch.where(live, nxt, -1)[:, None])
        left = torch.where(live, rem - 1, 0)
        rem.copy_(torch.where(live & (eos >= 0) & (nxt == eos), 0, left))
        self.cur.copy_(nxt[:, None])
        self._d_pos.add_(1)
        self._d_t.add_(1)

    def _host_step(self) -> None:
        nxt, _ = serve_step(self.params, self.cur, self.caches, self._d_pos,
                            cfg=self.cfg)
        self.cur.copy_(nxt)

    # ------------------------------------------------------------- frontend
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"len(prompt)={len(prompt)} + max_new_tokens={max_new_tokens} "
                f"exceeds max_len={self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        r = Request(rid, prompt, max_new_tokens, eos_id=eos_id)
        r.t_submit = time.perf_counter()
        self._queue.append(r)
        return rid

    @property
    def slot_requests(self) -> List[Optional[Request]]:
        """The request each slot serves (None: a free slot)."""
        return list(self._slot_req)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(
            r is not None for r in self._slot_req)

    # ------------------------------------------------------------ lifecycle
    def _complete(self, slot: int, results: Dict[int, List[int]]) -> Request:
        r = self._slot_req[slot]
        r.done = True
        r.t_done = time.perf_counter()
        results[r.rid] = r.out
        self._slot_req[slot] = None
        self._rem[slot] = 0
        self._pos[slot] = 0
        reset_slot(self.caches, slot)
        return r

    def _admit(self, results: Dict[int, List[int]]) -> List[Request]:
        """Prefill queued requests into free slots; returns any that
        completed at prefill (max_new_tokens == 1 or instant eos)."""
        finished = []
        for slot in range(self.slots):
            if not self._queue or self._slot_req[slot] is not None:
                continue
            r = self._queue.pop(0)
            with trace.span("serve.prefill"):
                tokens = torch.from_numpy(r.prompt.astype(np.int64))[None, :]
                tok, pf_caches = _prefill_one(
                    self.params, tokens.to(self.device), cfg=self.cfg,
                    max_len=self.max_len)
                first = int(tok)  # host sync: first token of this request
                self.stats["prefills"] += 1
                self.stats["host_syncs"] += 1
                self.stats["tokens_generated"] += 1
                r.t_first = time.perf_counter()
                r.out.append(first)
                if len(r.out) >= r.max_new_tokens or (
                        r.eos_id is not None and first == r.eos_id):
                    r.done = True
                    r.t_done = r.t_first
                    results[r.rid] = r.out
                    finished.append(r)
                    continue
                write_prompt(self.caches, slot, pf_caches)
                self.cur[slot, 0] = first
                self._pos[slot] = len(r.prompt)
                self._rem[slot] = r.max_new_tokens - 1
                self._eos[slot] = -1 if r.eos_id is None else r.eos_id
                self._slot_req[slot] = r
        return finished

    def _harvest(self, slot_tokens, results) -> List[Request]:
        """Append per-slot tokens; complete slots whose budget hit 0."""
        finished = []
        for slot, toks in enumerate(slot_tokens):
            r = self._slot_req[slot]
            if r is None:
                continue
            for t in toks:
                r.out.append(int(t))
                self.stats["tokens_generated"] += 1
            if self._rem[slot] <= 0:
                finished.append(self._complete(slot, results))
        return finished

    def _step_chunked(self, results) -> List[Request]:
        B, C = self.slots, self.chunk_size
        with trace.span("serve.chunk"):
            with trace.span("serve.upload"):
                h = self._host.numpy()
                h[:B], h[B:2 * B], h[2 * B:3 * B] = \
                    self._pos, self._rem, self._eos
                h[3 * B:3 * B + B * C] = -1
                h[-3:] = 0
                self._dev.copy_(self._host, non_blocking=True)
            with trace.span("serve.replay"):
                for _ in range(min(C, int(self._rem.max()))):
                    self._decode()
            # ONE host sync for the whole chunk: tokens, budgets, step
            # count and held pairs
            with trace.span("serve.download"):
                back = self._dev.to("cpu", copy=True).numpy()
            self.held_pairs = int(back[-1])
            if getattr(self.cfg, "experts_held", None) is not None:
                trace.count("moe.held_pairs", self.held_pairs)
        out, rem = back[3 * B:3 * B + B * C].reshape(B, C), back[B:2 * B]
        steps = int(back[-2])
        self.stats["chunk_launches"] += 1
        self.stats["host_syncs"] += 1
        self.stats["decode_steps"] += steps
        self._pos += steps               # all slots advance together
        live = [s for s in range(self.slots) if self._slot_req[s] is not None]
        slot_tokens = [[] for _ in range(self.slots)]
        for s in live:
            row = out[s]
            slot_tokens[s] = [int(v) for v in row[row >= 0]]
        self._rem[:] = rem
        return self._harvest(slot_tokens, results)

    def _step_host(self, results) -> List[Request]:
        B = self.slots
        self._host.numpy()[:B] = self._pos
        self._d_pos.copy_(self._host[:B], non_blocking=True)
        self._decode()
        cur = self.cur.cpu().numpy()     # one host sync PER TOKEN
        self.stats["decode_steps"] += 1
        self.stats["host_syncs"] += 1
        self._pos += 1
        slot_tokens = [[] for _ in range(self.slots)]
        for s in range(self.slots):
            r = self._slot_req[s]
            if r is None:
                continue
            tok = int(cur[s, 0])
            slot_tokens[s] = [tok]
            self._rem[s] -= 1
            if r.eos_id is not None and tok == r.eos_id:
                self._rem[s] = 0
        return self._harvest(slot_tokens, results)

    def step(self, results: Optional[Dict[int, List[int]]] = None
             ) -> List[Request]:
        """One scheduler tick: admit into free slots, then decode one chunk
        (chunked mode) or one token (host mode).  Returns the requests that
        completed this tick."""
        results = results if results is not None else {}
        finished = self._admit(results)
        if any(r is not None for r in self._slot_req):
            if self.decode_mode == "chunked":
                finished += self._step_chunked(results)
            else:
                finished += self._step_host(results)
        return finished

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue with continuous batching; returns rid -> tokens."""
        results: Dict[int, List[int]] = {}
        while self.has_work:
            self.step(results)
        return results
