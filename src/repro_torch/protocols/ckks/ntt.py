"""Negacyclic NTT over NTT-friendly primes: the port's counterpart of
``repro.protocols.ckks.ntt``.

Forward (Cooley–Tukey) takes standard order to bit-reversed; inverse
(Gentleman–Sande) takes bit-reversed back to standard, so pointwise
products happen in the bit-reversed domain and the order never needs fixing
up.  Operands are ``int64`` tensors ``(..., N)`` of residues; ``primes`` is
one prime, or one per row along axis -2 (``(..., P, N)`` RNS stacks).
Every function here is a kernel launch on a card (``kernels.ntt.ops``) and
the plain PyTorch version on the CPU; nothing else computes a transform.
A product of polynomials (``negacyclic_mul``, ``ntt_mul``) is one fused
launch: forward, product and inverse.
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


def ntt_mul(coef: Sequence[torch.Tensor], ntt: Sequence[torch.Tensor],
            terms: ops.Terms, primes: Primes) -> torch.Tensor:
    """Sums of negacyclic products: INV(sum of X_i * X_j) for each output,
    X_i the forward transform of a coefficient operand or an operand in the
    NTT domain (``kernels.ntt.ops.ntt_mul``): one launch on a card."""
    return ops.ntt_mul(coef, ntt, terms, primes)


def mul_fits(n: int, n_coef: int, n_ntt: int, n_terms: int,
             n_out: int) -> bool:
    """Whether one ``ntt_mul`` launch takes a job of this size at ring n
    (``kernels.ntt.ops.mul_fits``)."""
    return ops.mul_fits(n, n_coef, n_ntt, n_terms, n_out)


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor, primes: Primes
                   ) -> torch.Tensor:
    """c = a*b mod (X^N + 1, q) for residue rows a, b of one shape."""
    return ops.ntt_mul([a, b], [], (((0, 1),),), primes).reshape(a.shape)


__all__ = ["bit_reverse_indices", "mul_fits", "mul_mod", "negacyclic_mul",
           "ntt_forward", "ntt_inverse", "ntt_mul", "ntt_tables"]
