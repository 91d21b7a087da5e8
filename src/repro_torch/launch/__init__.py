"""Launchers: ``python -m repro_torch.launch.serve`` (the serving path) and
``python -m repro_torch.launch.train`` (the training loop)."""
