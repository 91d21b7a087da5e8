"""Paged decode attention: ``csrc/`` CUDA kernel, ``kernel`` (binding and
work figures), ``ref`` (plain PyTorch), ``ops`` (wrapper + launch
counters)."""
