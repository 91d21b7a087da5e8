"""Half-gates garbling/evaluation: ``csrc/`` CUDA kernels, ``kernel``
(binding), ``ref`` (plain PyTorch), ``ops`` (wrappers + launch counters)."""
