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

  ``"chunked"`` (default) — up to ``chunk_size`` decode steps are queued on
    the card back to back with no host sync between them, carrying tokens,
    caches and per-slot budgets on the device; then the output buffer, the
    budgets and the count of steps at which some slot was live come back in
    ONE copy.  The host knows every budget, so it queues
    min(chunk_size, max budget) steps; an ``eos_id`` that ends all slots
    sooner leaves the later steps dead, and they are not counted (once every
    budget is 0 it stays 0).  So ``stats`` equal the reference's, whose
    on-device loop stops when every budget is 0.
  ``"host"`` — one step and one device round trip per token, the baseline.

Both modes run the same ``model.forward`` step.  The attention layers'
per-slot cursors stay on the device and advance in place each step; the
host keeps a mirror of them only for the RoPE positions it hands
``forward`` once a chunk.  ``engine.stats`` counts prefills / decode steps
/ chunk launches / host syncs / tokens generated.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import model as M
from ..models.cache import init_caches, reset_slot, stack_caches, write_prompt


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
    return torch.argmax(logits[:, -1], dim=-1)


def serve_step(params, tokens, caches, pos, *, cfg):
    """One decode step for the whole batch: (B, 1) tokens -> (B, 1) next;
    ``caches`` are updated in place."""
    logits, caches = M.forward(params, cfg, tokens, caches=caches, pos=pos,
                               last_token_only=True)
    return _greedy(logits)[:, None], caches


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
    logits, caches = M.forward(params, cfg, tokens, caches=caches, pos=0,
                               last_token_only=True)
    return _greedy(logits)[0], caches


def _decode_chunk(params, tokens, caches, pos, remaining, eos, *, cfg, chunk,
                  steps):
    """Queue ``steps`` <= ``chunk`` decode steps with no host sync.

    Carries (B, 1) tokens, caches (in place), (B,) pos and (B,) remaining
    budgets.  ``remaining`` counts tokens still owed (0 = dead slot);
    emitting ``eos[b]`` (when >= 0) zeroes it.  Dead slots keep stepping
    harmlessly: batch rows are independent, and their writes land in rows
    that ``write_prompt`` overwrites at the next admission.

    Returns (out, tokens, caches, pos, remaining, live_steps): ``out`` is
    (B, chunk) with -1 where slot b was dead at step t, and ``live_steps``
    the number of steps at which some slot was live (a 0-d tensor).
    """
    B = tokens.shape[0]
    out = torch.full((B, chunk), -1, dtype=torch.int64, device=tokens.device)
    live_steps = torch.zeros((), dtype=torch.int64, device=tokens.device)
    for t in range(steps):
        logits, caches = M.forward(params, cfg, tokens, caches=caches,
                                   pos=pos, last_token_only=True)
        nxt = _greedy(logits)
        live = remaining > 0
        live_steps += live.any()
        out[:, t] = torch.where(live, nxt, -1)
        rem = torch.where(live, remaining - 1, 0)
        remaining = torch.where(live & (eos >= 0) & (nxt == eos), 0, rem)
        tokens, pos = nxt[:, None], pos + 1
    return out, tokens, caches, pos, remaining, live_steps


class ServeEngine:
    """Continuous-batching engine over a persistent slotted cache.

    Args:
      batch_slots: size of the fixed slot pool (the decode batch width).
      max_len: per-slot cache rows; submit() enforces
        len(prompt) + max_new_tokens <= max_len.
      chunk_size: decode steps per host sync in chunked mode.
      decode_mode: "chunked" (1 sync a chunk) or "host" (1 sync a token).

    The engine runs on the device of ``params``.
    """

    def __init__(self, cfg, params, batch_slots: int = 4, max_len: int = 512,
                 chunk_size: int = 8, decode_mode: str = "chunked"):
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

        # ONE persistent slotted cache for the life of the engine; the
        # attention cursors live in it, on the device, and the layers
        # advance them in place
        self.caches = _new_caches(cfg, batch_slots, max_len, self.device,
                                  per_slot_pos=True)

        B = batch_slots
        self.cur = torch.zeros((B, 1), dtype=torch.int64, device=self.device)
        self._pos = np.zeros((B,), np.int64)      # host mirror of the cursors
        self._rem = np.zeros((B,), np.int64)      # tokens still owed per slot
        self._eos = np.full((B,), -1, np.int64)   # eos id per slot (-1: none)
        self._slot_req: List[Optional[Request]] = [None] * B
        self._queue: List[Request] = []
        self._next_rid = 0
        self.stats = {"prefills": 0, "decode_steps": 0, "chunk_launches": 0,
                      "host_syncs": 0, "tokens_generated": 0}

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
            tokens = torch.from_numpy(r.prompt.astype(np.int64))[None, :]
            tok, pf_caches = _prefill_one(self.params,
                                          tokens.to(self.device),
                                          cfg=self.cfg, max_len=self.max_len)
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
        host = torch.from_numpy(np.stack([self._pos, self._rem, self._eos]))
        pos, rem, eos = host.to(self.device)
        out, self.cur, self.caches, _pos, rem, t = _decode_chunk(
            self.params, self.cur, self.caches, pos, rem, eos, cfg=self.cfg,
            chunk=C, steps=min(C, int(self._rem.max())))
        # ONE host sync for the whole chunk: tokens, budgets and step count
        back = torch.cat([out.reshape(-1), rem, t.reshape(1)]).cpu().numpy()
        out, rem, steps = back[:B * C].reshape(B, C), back[B * C:-1], \
            int(back[-1])
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
        self.cur, self.caches = serve_step(
            self.params, self.cur, self.caches,
            torch.from_numpy(self._pos).to(self.device), cfg=self.cfg)
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
