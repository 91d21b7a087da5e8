"""Launchers: ``python -m repro_torch.launch.serve`` (the serving path)."""
