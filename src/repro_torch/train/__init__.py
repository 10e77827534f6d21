"""The port's training stack (``repro.train``): the train step and the
fault-tolerant loop."""
