"""Serving on the port: the continuous-batching ``ServeEngine``."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
