"""Serving on the port: the continuous-batching ``ServeEngine``, the
batched (optionally left-padded) ``prefill`` and the decode ``serve_step``."""
from .engine import Request, ServeEngine, prefill, serve_step

__all__ = ["Request", "ServeEngine", "prefill", "serve_step"]
