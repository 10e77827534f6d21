"""The port's optimizer and learning-rate schedules (``repro.optim``)."""
from . import adamw, schedule  # noqa: F401
