"""The port's bench families, one module per paper table or figure.

Counterparts of the reference's ``benchmarks/bench_*.py`` over the port's
backends, run by ``python -m repro_torch.bench.run``.  Each module exposes
``run(ctx) -> List[Row]`` (``common.BenchContext``, ``common.Row``).
"""
