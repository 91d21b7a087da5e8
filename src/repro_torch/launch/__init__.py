"""Launchers: ``python -m repro_torch.launch.serve`` (the serving path),
``python -m repro_torch.launch.train`` (the training loop) and
``python -m repro_torch.launch.dryrun`` (every arch x shape cell on the
production meshes, from fake tensors over a fake process group, with the
analytic roofline for H100 meshes); ``mesh``, ``specs`` and ``analysis``
are the dry run's pieces."""
