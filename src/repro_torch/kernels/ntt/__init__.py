"""Negacyclic NTT and modular products: ``csrc/`` CUDA kernels, ``kernel``
(binding), ``ref`` (plain PyTorch), ``ops`` (wrappers + launch counters),
``tables`` (twiddle tables in exact integer arithmetic)."""
