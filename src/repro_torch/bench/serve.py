"""``serve_load`` scenario family on the port: open-loop serving traces ->
percentiles (the port of ``repro.bench.serve``).

TaPS-style declarative workload family for the serving engine: a
``ServeLoadSpec`` names a deterministic synthetic arrival trace (seeded
inter-arrival times + prompt/output-length distributions) and an engine
configuration (decode mode, slot pool, chunk size); running it yields
TTFT / TPOT / end-to-end latency percentiles, decode throughput and
goodput — the serve analogue of the METG sweep, reported as percentile
curves per the granularity-characterization methodology rather than
single means.

Two execution paths, selected by the context timer:

* ``wallclock`` — drive the port's REAL ``ServeEngine`` (reduced model,
  on the card unless the caller asks for the CPU; its decode step
  captured as a CUDA graph there) open loop: requests are submitted when
  the wall clock passes their arrival time, latencies come from the
  engine's per-request marks.  The weights are drawn from a torch
  generator seeded 0, not the reference's ``PRNGKey(0)``, and the times
  are the card's own.
* ``synthetic`` — a deterministic discrete-event simulator that replays
  the engine's exact scheduling (slot-granular admission between decode
  ticks, per-slot budgets, chunked ``while_loop`` semantics) in virtual
  time under a ``ServeCostParams`` cost model.  Zero noise, so the
  committed ``BENCH_serve_load.*.json`` baselines sit under the CI
  ``--baseline`` gate, and the host-sync arithmetic is exact: host mode
  pays ``launch + step + sync`` per TOKEN, chunked mode pays
  ``launch + steps*step + sync`` per CHUNK — the O(tokens) ->
  O(tokens/chunk) sync reduction the tentpole claims, in closed form.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import numpy as np

DEFAULT_MODEL = "qwen1.5-0.5b"


@dataclasses.dataclass(frozen=True)
class ServeCostParams:
    """Virtual-time costs for the deterministic serve simulator.

    Magnitudes follow the paper's §IV-B overhead anatomy: dispatch and
    device->host sync are tens of microseconds — the same order as (or
    larger than) a decode step's useful work on a small model, which is
    exactly why per-token syncing caps decode throughput.
    """

    prefill_launch_s: float = 50e-6   # dispatch overhead per prefill launch
    prefill_token_s: float = 2e-6     # per prompt token
    decode_launch_s: float = 30e-6    # dispatch overhead per decode launch
    decode_step_s: float = 20e-6      # per decode step (whole batch)
    sync_s: float = 40e-6             # per device->host round-trip

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ServeLoadSpec:
    """One serve_load cell: a seeded open-loop trace x engine config."""

    name: str
    mode: str = "chunked"            # "chunked" | "host"
    rate_rps: float = 50.0           # mean arrival rate (open loop)
    num_requests: int = 64
    batch_slots: int = 4
    chunk_size: int = 8
    max_len: int = 96
    prompt_len: tuple = (4, 12)      # uniform inclusive range
    out_tokens: tuple = (4, 24)      # uniform inclusive range
    seed: int = 0
    model: str = DEFAULT_MODEL       # wallclock mode only (reduced config)
    smoke: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("scenario name must be non-empty")
        if self.mode not in ("chunked", "host"):
            raise ValueError(f"unknown serve mode {self.mode!r}")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        for lo, hi, what in (self.prompt_len + ("prompt_len",),
                             self.out_tokens + ("out_tokens",)):
            if not (1 <= lo <= hi):
                raise ValueError(f"{what} range must satisfy 1 <= lo <= hi")
        if self.prompt_len[1] + self.out_tokens[1] > self.max_len:
            raise ValueError(
                f"prompt_len[1] + out_tokens[1] = "
                f"{self.prompt_len[1] + self.out_tokens[1]} exceeds "
                f"max_len={self.max_len}")

    @property
    def slug(self) -> str:
        """Filesystem-safe scenario key: BENCH_<slug>.json."""
        return re.sub(r"[^A-Za-z0-9_.-]+", "-", self.name)

    def resolved(self, smoke: Optional[bool] = None) -> "ServeLoadSpec":
        """The spec a run actually measures (smoke ceiling applied)."""
        smoke = self.smoke if smoke is None else smoke
        if not smoke:
            return dataclasses.replace(self, smoke=False)
        return dataclasses.replace(
            self, smoke=True, num_requests=min(self.num_requests, 16))


@dataclasses.dataclass(frozen=True)
class TracedRequest:
    rid: int
    arrival_s: float
    prompt_len: int
    out_tokens: int   # total tokens to generate (prefill token included)


def synth_trace(spec: ServeLoadSpec) -> List[TracedRequest]:
    """The deterministic open-loop trace for ``spec`` (seeded PRNG)."""
    rng = np.random.default_rng(spec.seed)
    out, t = [], 0.0
    for rid in range(spec.num_requests):
        t += float(rng.exponential(1.0 / spec.rate_rps))
        out.append(TracedRequest(
            rid=rid, arrival_s=t,
            prompt_len=int(rng.integers(spec.prompt_len[0],
                                        spec.prompt_len[1] + 1)),
            out_tokens=int(rng.integers(spec.out_tokens[0],
                                        spec.out_tokens[1] + 1))))
    return out


@dataclasses.dataclass
class ServeLoadResult:
    spec: ServeLoadSpec
    timer: str                 # "wallclock" | "synthetic"
    timer_config: Dict
    metrics: Dict


def _pcts(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    a = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean())}


def _metrics(trace, t_first, t_done, makespan_s, stats) -> Dict:
    ttft = [t_first[r.rid] - r.arrival_s for r in trace]
    latency = [t_done[r.rid] - r.arrival_s for r in trace]
    tpot = [(t_done[r.rid] - t_first[r.rid]) / (r.out_tokens - 1)
            for r in trace if r.out_tokens > 1]
    toks = stats["tokens_generated"]
    mk = max(makespan_s, 1e-12)
    return {
        "ttft_s": _pcts(ttft),
        "tpot_s": _pcts(tpot),
        "latency_s": _pcts(latency),
        "throughput_tok_s": toks / mk,
        "goodput_rps": len(trace) / mk,
        "makespan_s": makespan_s,
        "host_syncs": stats["host_syncs"],
        "host_syncs_per_token": stats["host_syncs"] / max(toks, 1),
        "decode_steps": stats["decode_steps"],
        "chunk_launches": stats["chunk_launches"],
        "prefills": stats["prefills"],
        "tokens_generated": toks,
        "completed": len(trace),
    }


# ----------------------------------------------------- deterministic model
def simulate_serve_load(spec: ServeLoadSpec,
                        cost: Optional[ServeCostParams] = None,
                        ) -> ServeLoadResult:
    """Replay the engine's scheduling in virtual time under ``cost``.

    Mirrors ``ServeEngine.step`` exactly: each tick admits arrived
    requests into free slots (one sequential B=1 prefill each, one sync
    for its first token), then advances one decode launch — ``chunk_size``
    steps in chunked mode (the while_loop stops early once every slot's
    budget is spent, so steps = min(chunk, max remaining)), one step in
    host mode — with one sync per launch.  Tokens materialize on the host
    at the launch's sync, which is when completions are observed.
    """
    spec = spec.resolved()
    cost = cost or ServeCostParams()
    trace = synth_trace(spec)
    pending = list(trace)
    slots: List[Optional[List]] = [None] * spec.batch_slots  # [req, rem]
    t = 0.0
    t_first: Dict[int, float] = {}
    t_done: Dict[int, float] = {}
    stats = {"prefills": 0, "decode_steps": 0, "chunk_launches": 0,
             "host_syncs": 0, "tokens_generated": 0}
    while pending or any(s is not None for s in slots):
        for i in range(spec.batch_slots):  # slot-granular admission
            if slots[i] is not None or not pending:
                continue
            if pending[0].arrival_s > t:
                break
            r = pending.pop(0)
            t += (cost.prefill_launch_s
                  + r.prompt_len * cost.prefill_token_s + cost.sync_s)
            stats["prefills"] += 1
            stats["host_syncs"] += 1
            stats["tokens_generated"] += 1
            t_first[r.rid] = t
            if r.out_tokens <= 1:
                t_done[r.rid] = t
            else:
                slots[i] = [r, r.out_tokens - 1]
        occupied = [i for i, s in enumerate(slots) if s is not None]
        if not occupied:
            if pending:
                t = max(t, pending[0].arrival_s)
            continue
        if spec.mode == "chunked":
            steps = min(spec.chunk_size, max(slots[i][1] for i in occupied))
            stats["chunk_launches"] += 1
        else:
            steps = 1
        t += cost.decode_launch_s + steps * cost.decode_step_s + cost.sync_s
        stats["decode_steps"] += steps
        stats["host_syncs"] += 1
        for i in occupied:
            r, rem = slots[i]
            emitted = min(rem, steps)
            stats["tokens_generated"] += emitted
            if rem - emitted == 0:
                t_done[r.rid] = t
                slots[i] = None
            else:
                slots[i][1] = rem - emitted
    return ServeLoadResult(
        spec=spec, timer="synthetic", timer_config=cost.as_dict(),
        metrics=_metrics(trace, t_first, t_done, t, stats))


# ------------------------------------------------------- real-engine path
def run_engine_load(spec: ServeLoadSpec, cfg=None, params=None,
                    device=None) -> ServeLoadResult:
    """Drive the port's ``ServeEngine`` open loop and measure wall-clock
    latencies.  ``cfg``/``params`` default to the spec's model reduced,
    on ``device`` (the card unless the caller asks for the CPU) — pass
    both to reuse weights across cells."""
    import time

    import torch

    from ..serve.engine import ServeEngine

    spec = spec.resolved()
    if cfg is None:
        from ..backends.base import resolve_device
        from ..configs import get_config, reduced
        from ..models.model import init_model

        dev = resolve_device(device)
        cfg = reduced(get_config(spec.model))
        params = init_model(cfg, torch.Generator(dev).manual_seed(0), dev)
    engine = ServeEngine(cfg, params, batch_slots=spec.batch_slots,
                         max_len=spec.max_len, chunk_size=spec.chunk_size,
                         decode_mode=spec.mode)
    trace = synth_trace(spec)
    prng = np.random.default_rng(spec.seed + 1)
    prompts = {r.rid: prng.integers(1, cfg.vocab_size,
                                    size=r.prompt_len).astype(np.int32)
               for r in trace}
    done: Dict[int, object] = {}
    rid_of: Dict[int, int] = {}
    nsub = 0
    t0 = time.perf_counter()
    while nsub < len(trace) or engine.has_work:
        now = time.perf_counter() - t0
        while nsub < len(trace) and trace[nsub].arrival_s <= now:
            r = trace[nsub]
            rid_of[engine.submit(prompts[r.rid],
                                 max_new_tokens=r.out_tokens)] = r.rid
            nsub += 1
        if not engine.has_work:
            time.sleep(min(max(trace[nsub].arrival_s - now, 0.0), 1e-3))
            continue
        for req in engine.step():
            done[rid_of[req.rid]] = req
    t_first = {rid: req.t_first - t0 for rid, req in done.items()}
    t_done = {rid: req.t_done - t0 for rid, req in done.items()}
    return ServeLoadResult(
        spec=spec, timer="wallclock", timer_config={},
        metrics=_metrics(trace, t_first, t_done,
                         max(t_done.values()), engine.stats))


def run_serve_load(spec: ServeLoadSpec, timer=None,
                   cost: Optional[ServeCostParams] = None,
                   device=None) -> ServeLoadResult:
    """Run one serve_load cell: real engine (timer None / wallclock, on
    ``device``) or the deterministic simulator (the synthetic fake
    clock)."""
    if timer is None or getattr(timer, "name", None) == "wallclock":
        return run_engine_load(spec, device=device)
    if getattr(timer, "name", None) == "synthetic":
        return simulate_serve_load(spec, cost=cost)
    raise ValueError(
        f"serve_load supports the wallclock and synthetic timers, "
        f"got {getattr(timer, 'name', timer)!r}")


def serve_artifact(result: ServeLoadResult) -> Dict:
    """The JSON-serializable ``kind="serve_load"`` artifact document
    (deep-copied: mutating it never reaches back into the result)."""
    import copy

    from .artifact import SCHEMA_VERSION

    spec = result.spec
    return {
        "schema": SCHEMA_VERSION,
        "kind": "serve_load",
        "scenario": {
            "name": spec.name,
            "mode": spec.mode,
            "rate_rps": float(spec.rate_rps),
            "num_requests": spec.num_requests,
            "batch_slots": spec.batch_slots,
            "chunk_size": spec.chunk_size,
            "max_len": spec.max_len,
            "prompt_len_lo": spec.prompt_len[0],
            "prompt_len_hi": spec.prompt_len[1],
            "out_tokens_lo": spec.out_tokens[0],
            "out_tokens_hi": spec.out_tokens[1],
            "seed": spec.seed,
            "model": spec.model,
            "smoke": spec.smoke,
        },
        "timer": result.timer,
        "timer_config": dict(result.timer_config),
        "metrics": copy.deepcopy(result.metrics),
    }


def write_serve_json(result: ServeLoadResult, outdir: str) -> str:
    """Write ``BENCH_<scenario>.json`` (validated); returns the path."""
    from .artifact import validate_artifact, write_artifact_doc

    return write_artifact_doc(validate_artifact(serve_artifact(result)),
                              result.spec.slug, outdir)
