"""Twiddle tables of the negacyclic NTT, in exact Python-int arithmetic
(the port's copy of ``bit_reverse_indices`` and ``ntt_tables`` of
``repro.protocols.ckks.ntt``; ``protocols.ckks.ntt`` re-exports them).

They live beside the kernels because the wrappers (``ops.py``) build their
device tables from them, and the protocol layer calls the wrappers.
"""

from __future__ import annotations

import functools

import numpy as np

from ...protocols.ckks.params import primitive_2n_root


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def ntt_tables(q: int, n: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(psi powers bit-reversed, psi^-1 powers bit-reversed, N^-1 mod q)."""
    psi = primitive_2n_root(q, n)
    psi_inv = pow(psi, q - 2, q)
    pw = np.empty(n, dtype=np.uint64)
    pwi = np.empty(n, dtype=np.uint64)
    x = y = 1
    for i in range(n):
        pw[i] = x
        pwi[i] = y
        x = x * psi % q
        y = y * psi_inv % q
    rev = bit_reverse_indices(n)
    return pw[rev], pwi[rev], pow(n, q - 2, q)


def shoup(w: np.ndarray | int, q: int) -> np.ndarray:
    """floor(w * 2^32 / q) for residues w < q: the precomputed quotient of
    Shoup's multiplication by a constant (``csrc/ntt_arith.cuh``)."""
    return (np.asarray(w, dtype=np.uint64) << np.uint64(32)) // np.uint64(q)


def barrett(q: int) -> tuple[int, int]:
    """(mu, k) of Barrett reduction for products of two residues mod q:
    k = bitlen(q), mu = floor(2^2k / q) < 2^32 for q < 2^31."""
    k = q.bit_length()
    return (1 << (2 * k)) // q, k
