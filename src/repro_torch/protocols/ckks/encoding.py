"""CKKS canonical embedding via a twisted FFT (O(N log N), exact indices):
the port's copy of ``repro.protocols.ckks.encoding``, run on the host in
NumPy.  It stays in NumPy on purpose: ``torch.fft`` may round differently,
and one unit in the last place of an FFT output can move a rounded
coefficient, which would break bitwise parity with the JAX package.

The slot evaluation points are the primitive 2N-th roots of unity
zeta_k = omega^{5^k mod 2N} (k = 0..N/2-1) with omega = exp(i*pi/N); their
conjugates are the remaining odd powers.  Evaluating a real polynomial at
ALL odd powers is a twisted DFT:

    m(omega^(2j+1)) = N * ifft(m_l * omega^l)[j]

so encode/decode are an index shuffle + one FFT — no Vandermonde matrices.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _slot_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(slot->odd-dft-index, conjugate index) for ring dim n."""
    m = 2 * n
    idx = np.empty(n // 2, dtype=np.int64)
    cidx = np.empty(n // 2, dtype=np.int64)
    p = 1
    for k in range(n // 2):
        idx[k] = (p - 1) // 2
        cidx[k] = (m - p - 1) // 2
        p = (p * 5) % m
    return idx, cidx


@functools.lru_cache(maxsize=None)
def _twist(n: int) -> np.ndarray:
    return np.exp(1j * np.pi * np.arange(n) / n)


def encode(z: np.ndarray, n: int, scale: float) -> np.ndarray:
    """Complex slot vector (N/2,) -> integer coefficients (N,) (signed)."""
    z = np.asarray(z, dtype=np.complex128)
    assert z.shape == (n // 2,), z.shape
    idx, cidx = _slot_indices(n)
    f = np.zeros(n, dtype=np.complex128)
    f[idx] = z * scale
    f[cidx] = np.conj(z) * scale
    g = np.fft.fft(f) / n
    coeffs = np.real(g * np.conj(_twist(n)))
    return np.round(coeffs).astype(np.int64)


def decode(coeffs: np.ndarray, n: int, scale: float) -> np.ndarray:
    """Signed integer/float coefficients (N,) -> complex slots (N/2,)."""
    idx, _ = _slot_indices(n)
    g = np.asarray(coeffs, dtype=np.float64) * _twist(n)
    f = np.fft.ifft(g) * n
    return f[idx] / scale
