"""serve_load family of the port: open-loop serving latency under
increasing load (the counterpart of ``benchmarks/bench_serve_load.py``).

Six cells: {host, chunked} decode x three arrival rates, one seeded
open-loop trace each (see ``repro_torch.bench.serve``).  Under the default
wall clock this drives the port's ``ServeEngine`` on a reduced model (on
the card unless ``--device cpu``); under
``--timer synthetic`` it runs the deterministic discrete-event cost model
— the committed-baseline path, where the host mode's one-sync-per-token
tax vs the chunked engine's one-sync-per-chunk is exact arithmetic.

The rates ladder from arrival-limited (both modes mostly idle between
requests) to saturated (the host mode queues hard, TTFT blows up), so the
artifact set traces how the sync floor caps decode throughput — the
serving rendition of the paper's §IV-B overhead wall.
"""
from __future__ import annotations

from typing import List

from ..serve import ServeLoadSpec

from .common import BenchContext, Row

RATES = (500.0, 2000.0, 8000.0)


def specs() -> List[ServeLoadSpec]:
    return [
        ServeLoadSpec(
            name=f"serve_load.{mode}.rate{int(rate)}",
            mode=mode, rate_rps=rate, num_requests=64,
            batch_slots=4, chunk_size=8, max_len=64,
            prompt_len=(4, 8), out_tokens=(4, 24), seed=0)
        for mode in ("host", "chunked")
        for rate in RATES
    ]


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    rows = []
    for spec in specs():
        m = ctx.run_serve(spec).metrics
        rows.append(Row(
            spec.name, m["tpot_s"]["p50"] * 1e6,
            f"thr={m['throughput_tok_s']:.0f}tok/s "
            f"ttft_p95={m['ttft_s']['p95'] * 1e3:.3f}ms "
            f"syncs/tok={m['host_syncs_per_token']:.3f}"))
    return rows
