"""The port's data pipeline (``repro.data``)."""
from .pipeline import DataConfig, Prefetcher, make_batch  # noqa: F401
