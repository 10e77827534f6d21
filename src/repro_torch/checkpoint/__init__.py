"""The port's checkpointing (``repro.checkpoint``)."""
