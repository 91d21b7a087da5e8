"""The training data pipeline: the port's copy of ``repro.data``."""
