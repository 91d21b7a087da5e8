"""Training: the port's copy of ``repro.train`` (the AdamW + WSD
optimizer, the microbatched train step, checkpoints and fault handling)."""
