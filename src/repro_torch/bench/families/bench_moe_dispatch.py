"""MoE dispatch comm volume of the port: SP-aware EP vs token replication
(the counterpart of ``benchmarks/bench_moe_dispatch.py``).

The ``moe_dispatch`` scenario (``repro_torch.bench.moe``): per-plane
all-to-all bytes from the exact capacity math the a2a path uses, scored
against the interconnect roofline (``bench.moe.LINK_BW``, a data-sheet
figure for NVLink 4 on an H100 SXM).  The headline number is the
reduction ratio — SP-aware expert parallelism (``ep_mode="sp"``) moves
1/|model| of the replicated volume per plane.  The rows are the
reference family's, names, bytes and ratio alike; the microseconds
differ by the link constant.  The compiled program's bytes are not
reported: they need the port's HLO-walker counterpart.  The bytes the
ranks' all-to-alls move are held to these in
``tests/test_torch_moe_a2a.py`` and printed by ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import List

from ..moe import MoEDispatchSpec, moe_dispatch_report

from .common import BenchContext, Row

MESHES = [(4, 2), (2, 4)]          # (data, model)
SMOKE_MESHES = [(4, 2)]


def run(ctx: BenchContext = None) -> List[Row]:
    ctx = ctx or BenchContext()
    rows: List[Row] = []
    for data, model in (SMOKE_MESHES if ctx.smoke else MESHES):
        reports = {}
        for ep_mode in ("replicated", "sp"):
            spec = MoEDispatchSpec(data=data, model=model, ep_mode=ep_mode)
            rep = moe_dispatch_report(spec)
            reports[ep_mode] = rep
            derived = (f"a2a_bytes={rep['a2a_bytes']:.0f};"
                       f"cap={rep['cap']:.0f};"
                       f"planes={rep['dispatch_planes']:.0f}")
            rows.append(Row(f"moe_dispatch.d{data}m{model}.{ep_mode}",
                            rep["a2a_roofline_s"] * 1e6, derived))
        ratio = (reports["replicated"]["a2a_bytes"]
                 / reports["sp"]["a2a_bytes"])
        rows.append(Row(f"moe_dispatch.d{data}m{model}.reduction", 0.0,
                        f"a2a_ratio={ratio:.2f};model_axis={model}"))
    return rows
