"""Deterministic synthetic LM data pipeline: a numpy copy of
``repro.data.pipeline`` (the port imports nothing of the reference), held
equal to it bit for bit by ``tests/test_torch_data.py``.

A seeded, host-side token stream (Philox counter-based: O(1) random access
by (seed, step, shard)) with a zipf-ish unigram distribution plus local
n-gram structure, so losses are learnable.  Sharded by data-parallel host
rank, background-prefetched, and restart-deterministic: batch(step) is a
pure function, so resuming from a checkpoint replays the exact stream (the
trainer's bit-exact resume relies on it).  For modality-frontend configs
(vision, audio) the stream emits precomputed frame or patch embeddings in
place of tokens.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure: tokens repeat with lag `ngram_lag` w.p. `ngram_p`
    ngram_p: float = 0.5
    ngram_lag: int = 2
    # modality stub
    embed_dim: int = 0  # >0 -> emit embeddings instead of tokens
    host_id: int = 0
    num_hosts: int = 1


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    key = (cfg.seed << 96) | (step << 32) | (shard << 8) | 0xD5
    return np.random.Generator(np.random.Philox(key=key))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function (cfg, step) -> host-local batch."""
    assert cfg.global_batch % cfg.num_hosts == 0
    local = cfg.global_batch // cfg.num_hosts
    rng = _rng(cfg, step, cfg.host_id)
    if cfg.embed_dim:
        emb = rng.standard_normal(
            (local, cfg.seq_len, cfg.embed_dim), dtype=np.float32)
        labels = rng.integers(0, cfg.vocab_size,
                              (local, cfg.seq_len), dtype=np.int32)
        return {"embeds": emb, "labels": labels}
    # zipf-ish unigram over vocab with n-gram copy structure
    raw = rng.zipf(1.3, size=(local, cfg.seq_len + 1)).astype(np.int64)
    toks = (raw % (cfg.vocab_size - 1)) + 1  # reserve 0 as BOS
    copy = rng.random((local, cfg.seq_len + 1)) < cfg.ngram_p
    lag = cfg.ngram_lag
    toks[:, lag:] = np.where(copy[:, lag:], toks[:, :-lag], toks[:, lag:])
    toks[:, 0] = 0
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch of make_batch(step) results."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
