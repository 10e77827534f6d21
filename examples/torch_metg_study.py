"""The paper's core experiment on the PyTorch port: METG(50%) across the
port's backends and four dependence patterns (the port's
``examples/metg_study.py``).

Reproduces the Figure 9 methodology on the port's backends (paper Table 4
analogues) x four dependence patterns, printing the METG table and one
efficiency-vs-granularity curve (Figure 3 analogue) of ``torch-scan``.
Runs on the card unless ``--device cpu`` is given; ``--timer synthetic``
runs it on the deterministic fake clock (no backend is built).  ``--fast``
also cuts the curve to 512 iterations.

Run: PYTHONPATH=src python examples/torch_metg_study.py [--fast]
     [--device cpu] [--timer synthetic] [--artifacts DIR]
"""
import argparse

from repro_torch.backends import backend_names
from repro_torch.bench import SyntheticTimer
from repro_torch.bench.families.common import BenchContext, metg_for

CASES = [("stencil", {}, 1), ("nearest", {"radix": 5}, 1),
         ("spread", {"radix": 5}, 1), ("nearest", {"radix": 5}, 4)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--artifacts", default=None,
                    help="directory for BENCH_<scenario>.json files")
    ap.add_argument("--device", default=None,
                    help="where the backends run (default: the card)")
    ap.add_argument("--timer", choices=("wallclock", "synthetic"),
                    default="wallclock")
    args = ap.parse_args(argv)
    n_points = 5 if args.fast else 7
    ctx = BenchContext(artifacts_dir=args.artifacts, device=args.device,
                       timer=SyntheticTimer() if args.timer == "synthetic"
                       else None)

    print(f"{'backend':14s} {'pattern':12s} {'METG(50%) us':>12s} "
          f"{'peak GFLOP/s':>13s}")
    table = {}
    for be in backend_names():
        hi = 512 if (args.fast or be == "torch-host") else 4096
        for pat, kw, ng in CASES:
            name = pat + ("_x4" if ng > 1 else "")
            res = metg_for(ctx, ctx.on_device(be), pat,
                           name=f"metg_study.{be}.{name}", num_graphs=ng,
                           iterations_hi=hi, n_points=n_points, **kw)
            table[be, name] = res
            metg = (res.metg or float("nan")) * 1e6
            print(f"{be:14s} {name:12s} {metg:12.2f} "
                  f"{res.peak_rate / 1e9:13.2f}")

    print("\nefficiency vs granularity (torch-scan, stencil) — Fig 3 "
          "analogue:")
    res = metg_for(ctx, ctx.on_device("torch-scan"), "stencil",
                   name="metg_study.curve",
                   iterations_hi=512 if args.fast else 4096, n_points=8)
    for p in sorted(res.points, key=lambda p: -p.granularity):
        bar = "#" * int(p.efficiency * 40)
        print(f"  {p.granularity * 1e6:10.2f} us  {p.efficiency * 100:5.1f}% "
              f"{bar}")
    print(f"  METG(50%) = {(res.metg or 0) * 1e6:.2f} us")
    return table, res


if __name__ == "__main__":
    main()
