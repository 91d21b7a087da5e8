"""CKKS parameters: RNS primes, roots of unity, scales (the port's copy of
``repro.protocols.ckks.params``).

Primes are NTT-friendly (q ≡ 1 mod 2N) and < 2^31, so the product of two
residues fits a signed 64-bit integer (the port's ``int64`` rows) and the
card's kernels work on 32-bit lanes with 32x32->64 multiplies.  The modulus
chain is [q0 | scale primes...] plus one special prime P for hybrid
key-switching (GHS-style), which keeps relinearization noise ~e instead of
~q·e.
"""

from __future__ import annotations

import dataclasses
import functools


_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_primes(n_ring: int, bits: list[int]) -> list[int]:
    """One NTT-friendly prime per requested bit size, all distinct."""
    out: list[int] = []
    step = 2 * n_ring
    for b in bits:
        cand = (1 << b) + 1
        # search upward in steps of 2N keeping q ≡ 1 (mod 2N)
        cand += (-(cand - 1)) % step
        while (not is_prime(cand)) or cand in out:
            cand += step
        out.append(cand)
    return out


def primitive_2n_root(q: int, n_ring: int) -> int:
    """psi with psi^N ≡ -1 (mod q) — a primitive 2N-th root of unity."""
    order = 2 * n_ring
    assert (q - 1) % order == 0
    exp = (q - 1) // order
    for a in range(2, 1000):
        psi = pow(a, exp, q)
        if pow(psi, n_ring, q) == q - 1:
            return psi
    raise RuntimeError(f"no 2N-th root found for q={q}")


@dataclasses.dataclass(frozen=True)
class CkksParams:
    """Depth-`levels` CKKS with RNS modulus chain + special prime."""
    n_ring: int = 1024                 # N; slots = N/2
    levels: int = 2                    # multiplicative depth
    scale_bits: int = 25
    q0_bits: int = 29
    special_bits: int = 30
    noise_std: float = 3.2

    @functools.cached_property
    def primes(self) -> list[int]:
        bits = [self.q0_bits] + [self.scale_bits] * self.levels
        return gen_primes(self.n_ring, bits)

    @functools.cached_property
    def special_prime(self) -> int:
        got = gen_primes(self.n_ring,
                         [self.special_bits, self.special_bits])
        # avoid collision with chain primes
        for p in got:
            if p not in self.primes:
                return p
        raise RuntimeError("special prime collision")

    @property
    def slots(self) -> int:
        return self.n_ring // 2

    @property
    def scale(self) -> float:
        return float(1 << self.scale_bits)

    def level_primes(self, level: int) -> list[int]:
        """Primes of a ciphertext at ``level`` (level L = fresh)."""
        return self.primes[:level + 1]

    def ct_slots(self, level: int, ncomp: int = 2) -> int:
        """uint64 slots a ciphertext occupies in the engine array."""
        return ncomp * (level + 1) * self.n_ring

    def pt_slots(self) -> int:
        """Encoded plaintext: one poly over the full chain."""
        return (self.levels + 1) * self.n_ring
