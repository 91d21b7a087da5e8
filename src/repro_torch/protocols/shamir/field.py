"""GF(p) arithmetic for the Shamir driver, p = 2^61 - 1 (Mersenne): the
port's copy of ``repro.protocols.shamir.field``.

A 61-bit prime keeps every share in one 8-byte slot, sums of a few
residues stay below 2^64, and the Mersenne structure makes the 122-bit
products of ``mulmod`` reducible with shifts and masks (2^61 = 1 mod p),
so share-wise multiplication vectorizes without 128-bit intermediates.

The array helpers are elementwise over int64 tensors on whatever device
they live on.  The JAX package works in uint64; PyTorch has no uint64
arithmetic on the card, so a tensor here carries the same 64 bits as
int64.  Additions and multiplications wrap identically in both types;
``fold`` masks its right shift (``_shr``), so the arithmetic shift of a
word with its top bit set gives the logical one.  ``fold``, ``addmod``
and ``submod`` therefore equal the JAX package's bit for bit on any
64-bit word; ``mulmod`` on canonical residues, its contract there.  Each
returns canonical residues in [0, p), in fewer tensor operations than a
line-for-line copy would take (one fold per product, not four): on the
card every operation is a kernel launch.

Scalar helpers (inverse, Lagrange weights) run on Python ints: they only
produce *public* per-(n, t) constants baked into instruction immediates
at trace time.  ``prf_coeffs`` draws on the host in NumPy uint64: its
coefficients depend only on trace-time constants, and the driver uploads
them.  ``share`` and ``reconstruct`` (the offline dealer) take and return
NumPy uint64 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

#: the field modulus, a Mersenne prime: one 8-byte slot per element
P = (1 << 61) - 1

_MASK30 = (1 << 30) - 1
_MASK31 = (1 << 31) - 1


def as_tensor(x) -> torch.Tensor:
    """A uint64 NumPy array (or anything ``np.asarray`` takes as one) ->
    a CPU int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int64 tensor -> a uint64 NumPy array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of 64-bit words held as int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def fold(x: torch.Tensor) -> torch.Tensor:
    """Reduce any 64-bit word mod p via Mersenne folding (2^61 = 1).

    One fold leaves y = hi + lo < 2^61 + 8 = p + 9, congruent to x, so
    one conditional subtraction makes it canonical: the JAX package's
    second fold gives the same residue."""
    y = _shr(x, 61) + (x & P)
    return torch.where(y >= P, y - P, y)


def addmod(a: torch.Tensor, b: torch.Tensor | int) -> torch.Tensor:
    return fold(a + b)


def submod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fold(a + (P - b))


def _mul_sum(ah, al, bh, bl) -> torch.Tensor:
    """hh*2^62 + mid*2^31 + ll, collapsed mod p without 128-bit
    temporaries: 2^62 = 2 and 2^61 = 1 mod p, so the sum is
    2*hh + mh + ml*2^31 + ll with mid = mh*2^30 + ml.  For canonical
    factors every term fits 62 bits and the sum stays below 2^64 (it may
    set the top bit, which ``fold`` reads as the word's own)."""
    mid = ah * bl + al * bh                 # < 2^62
    return ((ah * bh) << 1) + (mid >> 30) + ((mid & _MASK30) << 31) \
        + al * bl


def mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p for canonical residues (the JAX package's contract):
    both factors split at bit 31."""
    return fold(_mul_sum(a >> 31, a & _MASK31, b >> 31, b & _MASK31))


def mulmod_scalar(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod p for canonical residues a and a public int c."""
    c %= P
    return fold(_mul_sum(a >> 31, a & _MASK31, c >> 31, c & _MASK31))


# ---------------------------------------------------------------------------
# public scalar constants (Python ints)
# ---------------------------------------------------------------------------


def inverse(x: int) -> int:
    """x^-1 mod p (Fermat); x must be nonzero mod p."""
    x %= P
    if x == 0:
        raise ZeroDivisionError("0 has no inverse in GF(p)")
    return pow(x, P - 2, P)


def eval_point(party: int) -> int:
    """The public evaluation point of one party: alpha_i = i + 1."""
    return party + 1


def _lagrange(pts: list[int]) -> list[int]:
    """Interpolation weights at x=0 over the points ``pts``."""
    out = []
    for i, ai in enumerate(pts):
        num = den = 1
        for j, aj in enumerate(pts):
            if j != i:
                num = num * aj % P
                den = den * ((aj - ai) % P) % P
        out.append(num * inverse(den) % P)
    return out


def lagrange_at_zero(n_parties: int) -> tuple[int, ...]:
    """Reconstruction weights at x=0 over ALL n points alpha_1..alpha_n.

    Valid for any sharing of degree <= n - 1, so one weight vector serves
    both degree-t values and the degree-2t products of F_MUL_LOCAL
    (n >= 2t + 1 by construction).
    """
    return tuple(_lagrange([eval_point(i) for i in range(n_parties)]))


# ---------------------------------------------------------------------------
# deterministic coefficient PRF (order-independent across engine loops)
# ---------------------------------------------------------------------------

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def prf_coeffs(key: int, a: int, b: int, count: int) -> np.ndarray:
    """(count,) uint64 residues derived from (key, a, b, lane) via
    splitmix64, on the host.

    Keyed only by trace-time constants (never by execution order), so the
    scalar, batched and overlap loops draw identical "randomness".
    """
    seed = _mix64(key * 0x8CB92BA72F3D8DD7 + a * 0xD6E8FEB86659FD93 + b + 1)
    x = np.uint64(seed) + _GAMMA * np.arange(1, count + 1, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    x = x ^ (x >> np.uint64(31))
    return to_numpy(fold(as_tensor(x)))


# ---------------------------------------------------------------------------
# share / reconstruct (the offline dealer, also used by the tests)
# ---------------------------------------------------------------------------


def share(secrets: np.ndarray, n_parties: int, threshold: int,
          rng: np.random.Generator) -> np.ndarray:
    """Deal (n_parties, count) uint64 Shamir shares of a secret vector.

    Each lane gets an independent uniform degree-``threshold`` polynomial
    f with f(0) = secret; party i holds f(alpha_{i+1}).  ``rng`` is drawn
    as the JAX package draws it, so both deal the same shares.
    """
    secrets = np.asarray(secrets, dtype=np.uint64) % np.uint64(P)
    count = secrets.shape[0]
    coeffs = as_tensor(rng.integers(0, P, size=(threshold, count),
                                    dtype=np.uint64))
    sec = as_tensor(secrets)
    out = torch.empty((n_parties, count), dtype=torch.int64)
    for i in range(n_parties):
        acc = torch.zeros(count, dtype=torch.int64)
        a = eval_point(i)
        for k in range(threshold - 1, -1, -1):      # Horner, highest first
            acc = addmod(mulmod_scalar(acc, a), coeffs[k])
        out[i] = addmod(mulmod_scalar(acc, a), sec)
    return to_numpy(out)


def reconstruct(shares: np.ndarray, parties: list[int] | None = None
                ) -> np.ndarray:
    """Interpolate at 0 from (k, count) uint64 shares held by ``parties``."""
    shares = np.asarray(shares, dtype=np.uint64)
    k = shares.shape[0]
    idx = list(range(k)) if parties is None else list(parties)
    if len(idx) != k:
        raise ValueError(f"{k} share rows for {len(idx)} party ids")
    rows = as_tensor(shares)
    acc = torch.zeros(shares.shape[1:], dtype=torch.int64)
    for i, lam in enumerate(_lagrange([eval_point(i) for i in idx])):
        acc = addmod(acc, mulmod_scalar(rows[i], lam))
    return to_numpy(acc)
