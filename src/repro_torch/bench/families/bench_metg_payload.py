"""Study: communication hiding vs payload bytes (paper §V-F, Fig. 11/12).

Payload-bytes sweep at fixed task granularity for the SPMD backends over
the three-point communication-mode spectrum: ``comm_overlap`` off
(blocking, strict MPI-style compute/communicate alternation), on
(double-buffered: the next timestep's exchange is issued ahead of the
kernel body), and ``comm=onesided`` (put/signal: producers push straight
into consumer receive buffers, no rendezvous at all).  Derived metric:
overlap efficiency = ideal / observed elapsed, normalized per variant
against its smallest-payload cell — see ``repro_torch.bench.studies``.

On the synthetic timer the communication term is deterministic
(``ndeps * (rendezvous + bytes * SECONDS_PER_BYTE)``, where one-sided
skips the rendezvous surcharge) and both the overlapping and one-sided
backends pay ``max(compute, comm)`` instead of the sum, so the artifacts
show ``onesided <= overlap <= blocking`` elapsed at every payload, as the
reference's do.  Thin wrapper over
``repro_torch.bench.studies``.
"""
from __future__ import annotations

from typing import List

from ..studies import (PAYLOAD_BYTES, PAYLOAD_VARIANTS,
                                 SECONDS_PER_BYTE, SECONDS_PER_RENDEZVOUS,
                                 elapsed_s, payload_curve, payload_spec,
                                 study_timer)

from .common import BenchContext, Row

BACKENDS = ("torch-csp", "torch-pipeline")


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    timer = study_timer(ctx.timer, seconds_per_byte=SECONDS_PER_BYTE,
                        seconds_per_rendezvous=SECONDS_PER_RENDEZVOUS)
    rows: List[Row] = []
    for backend in BACKENDS:
        results = {}
        for variant in PAYLOAD_VARIANTS:
            for ob in PAYLOAD_BYTES:
                spec = payload_spec(backend=backend, output_bytes=ob,
                                    variant=variant)
                results[(ob, variant)] = ctx.run(spec, timer=timer)
        for pt in payload_curve(results):
            rows.append(Row(
                f"metg_payload.{backend}.{pt.variant}.bytes{int(pt.x)}",
                pt.elapsed_s * 1e6,
                f"overlap_eff={pt.metric:.3f}"))
        for ob in PAYLOAD_BYTES:
            blocking = elapsed_s(results[(ob, "blocking")])
            overlap = elapsed_s(results[(ob, "overlap")])
            onesided = elapsed_s(results[(ob, "onesided")])
            rows.append(Row(
                f"metg_payload.{backend}.hiding.bytes{ob}",
                (blocking - overlap) * 1e6,
                f"speedup={blocking / overlap:.3f}"))
            rows.append(Row(
                f"metg_payload.{backend}.onesided_gain.bytes{ob}",
                (blocking - onesided) * 1e6,
                f"speedup={blocking / onesided:.3f}"))
    return rows
