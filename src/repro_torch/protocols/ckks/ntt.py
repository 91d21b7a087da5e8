"""Negacyclic NTT over NTT-friendly primes: the port's counterpart of
``repro.protocols.ckks.ntt``.

Forward (Cooley–Tukey) takes standard order to bit-reversed; inverse
(Gentleman–Sande) takes bit-reversed back to standard, so pointwise
products happen in the bit-reversed domain and the order never needs fixing
up.  Operands are ``int64`` tensors ``(..., N)`` of residues; ``primes`` is
one prime, or one per row along axis -2 (``(..., P, N)`` RNS stacks).
Every function here is a kernel launch on a card (``kernels.ntt.ops``) and
the plain PyTorch version on the CPU; nothing else computes a transform.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...kernels.ntt import ops
from ...kernels.ntt.tables import bit_reverse_indices, ntt_tables

Primes = int | Sequence[int]


def ntt_forward(a: torch.Tensor, primes: Primes) -> torch.Tensor:
    """Negacyclic forward NTT of every row (standard -> bit-reversed)."""
    return ops.ntt_forward(a, primes)


def ntt_inverse(a: torch.Tensor, primes: Primes) -> torch.Tensor:
    """Inverse negacyclic NTT of every row (bit-reversed -> standard)."""
    return ops.ntt_inverse(a, primes)


def mul_mod(a: torch.Tensor, b: torch.Tensor, primes: Primes
            ) -> torch.Tensor:
    """a * b mod q, elementwise (the NTT domain's product)."""
    return ops.mul_mod(a, b, primes)


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, primes: Primes
                   ) -> torch.Tensor:
    """c = a*b mod (X^N + 1, q) for residue rows a, b."""
    fa, fb = ntt_forward(torch.stack([a, b]), primes)
    return ntt_inverse(mul_mod(fa, fb, primes), primes)


__all__ = ["bit_reverse_indices", "mul_mod", "negacyclic_mul",
           "ntt_forward", "ntt_inverse", "ntt_tables"]
