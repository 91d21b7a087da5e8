"""CKKS cipher operations in RNS form (add / mul / relin / rescale) on
device tensors: the port's counterpart of ``repro.protocols.ckks.cipher``.

Secret-key RLWE over Z_q[X]/(X^N+1) with an RNS modulus chain and hybrid
key-switching through one special prime P (GHS).  Ciphertexts are
COEFFICIENT-domain ``int64`` tensors shaped (ncomp, level+1, N), flat
buffers that swap as plain byte copies (§7.4).  ``add``, ``sub``,
``mul_tensor`` and ``add_plain`` also take a leading batch of ciphertexts
(the batched driver's groups).

What differs from the reference, and keeps its results bit for bit:
- the reference's ``uint64`` becomes ``int64``: every residue is below
  2^31, so each product of two residues and each sum the ops form stays
  below 2^63 (the bounds are noted where a product meets a sum);
  ``np.mod`` of signed values becomes ``torch.remainder`` (both take the
  divisor's sign);
- where the reference loops over primes, components or digits, the port
  stacks them along axis -2 / -3 and makes one call: every transform and
  every product of two residue rows goes through ``ntt.py``, which is a
  kernel launch on a card;
- every product of polynomials (encrypt, decrypt, mul_tensor, relinearize,
  mul_plain) is one fused call, ``ntt.ntt_mul``: forward transforms,
  products and the inverse in one launch, which reads its operands where
  they lie (views of the stacks, no gathers);
- decrypt sums its components' products before the inverse transform,
  not after (equal mod q: the transform is linear);
- s^2 in the NTT domain is computed once, not at each use.
Randomness stays on a host ``numpy.random.default_rng(seed)``, drawn in the
reference's order; samples move to the device after they are drawn.  The
encoding FFT and decode's CRT stay on the host.

``counts`` tallies the rows of every transform and product this context
asked for (a fused call's under each of the three, and its output rows
under ``ntt_mul``), so a run can hold the kernels' counters against it.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ...kernels import resolve_device, to_device
from . import ntt
from .encoding import decode, encode
from .params import CkksParams


#: ntt_mul's terms (operand index pairs, one list per output): a row
#: against a row
ONE_TERM = (((0, 1),),)
#: (a0, a1) x (b0, b1): a0 b0, a0 b1 + a1 b0, a1 b1
TENSOR_TERMS = (((0, 2),), ((0, 3), (1, 2)), ((1, 3),))


def sum_terms(k: int, outs: int = 1) -> tuple:
    """Output h: the sum over i < k of operand i times operand
    k + h k + i (coefficient rows against NTT-domain rows)."""
    return tuple(tuple((i, k + h * k + i) for i in range(k))
                 for h in range(outs))


def plain_terms(k: int) -> tuple:
    """Output i: operand i times operand k (the plaintext)."""
    return tuple(((i, k),) for i in range(k))


def _center(vals: torch.Tensor, q: int) -> torch.Tensor:
    """[0,q) -> centered signed values in (-q/2, q/2]."""
    return torch.where(vals > q // 2, vals - q, vals)


class CkksContext:
    """Keys and homomorphic ops of one CKKS instance on one device.

    Built from a seed (key generation drawn as the reference draws it) or
    from ``keys`` made elsewhere: ``(s_int, {level: (b, a)})``, the ternary
    secret (N,) and per level the evaluation key, b and a each (digits,
    basis, N) in the NTT domain (``interop.ckks_context_from_keys``
    builds it from the JAX package's context).  Encryptions draw from
    ``rng`` (default: ``default_rng(seed)``)."""

    def __init__(self, params: CkksParams, seed: int = 0xCEC5,
                 device: str | torch.device | None = None, *,
                 keys: tuple | None = None,
                 rng: np.random.Generator | None = None):
        self.p = params
        self.device = resolve_device(device)
        self.counts: Counter = Counter()
        self._cols: dict[tuple, torch.Tensor] = {}   # (P, 1) columns
        self._rng = rng if rng is not None else np.random.default_rng(seed)
        n = params.n_ring
        self.chain = tuple(params.primes) + (params.special_prime,)
        if keys is None:
            self.s_int = self._rng.integers(-1, 2, n).astype(np.int64)
        else:
            self.s_int = np.asarray(keys[0], dtype=np.int64)
        self._init_secret()
        # (b, a) per level, each (digits, basis, N), stacked as (2, ...),
        # and the same cut into relinearize's fused calls
        self._evk: dict[int, torch.Tensor] = {}
        self._relin_keys: dict[int, list] = {}
        for lvl in range(1, params.levels + 1):
            self._evk[lvl] = self._make_evk(lvl) if keys is None else \
                self._dev(np.stack([np.asarray(m, dtype=np.int64)
                                    for m in keys[1][lvl]]))
            self._relin_keys[lvl] = self._key_chunks(self._evk[lvl])

    # -- helpers --------------------------------------------------------------

    def _key_chunks(self, evk: torch.Tensor) -> list:
        """relinearize's fused calls at one level: (lo, hi, keys) for
        digits lo..hi-1, as many digits as one launch takes (every digit
        up to 5), ``keys`` the two halves' rows of those digits as one
        stack (2 (hi - lo), B, N) (a view of ``evk`` where one call takes
        every digit)."""
        d = evk.shape[1]
        c = max(k for k in range(1, d + 1)
                if ntt.mul_fits(self.p.n_ring, k, 2 * k, 2 * k, 2))
        return [(lo, min(lo + c, d), evk[:, lo:lo + c].flatten(0, 1))
                for lo in range(0, d, c)]

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return to_device(arr, self.device)

    def col(self, primes) -> torch.Tensor:
        """(P, 1) int64 column of primes on the device, cached."""
        key = ("q", *primes)
        got = self._cols.get(key)
        if got is None:
            got = self._cols[key] = self._dev(
                np.asarray(primes, dtype=np.int64)[:, None])
        return got

    def inv_col(self, x: int, primes) -> torch.Tensor:
        """(P, 1) column of x^-1 mod each prime, cached."""
        key = ("inv", x, *primes)
        got = self._cols.get(key)
        if got is None:
            got = self._cols[key] = self._dev(np.asarray(
                [pow(x, -1, q) for q in primes], dtype=np.int64)[:, None])
        return got

    def _rows(self, a: torch.Tensor) -> int:
        return a.numel() // self.p.n_ring

    def _fwd(self, a: torch.Tensor, primes) -> torch.Tensor:
        self.counts["ntt_forward"] += self._rows(a)
        return ntt.ntt_forward(a, primes)

    def _mul(self, a: torch.Tensor, b: torch.Tensor, primes) -> torch.Tensor:
        self.counts["mul_mod"] += self._rows(a)
        return ntt.mul_mod(a, b, primes)

    def _fused(self, coef: torch.Tensor, ntt_rows: torch.Tensor | None,
               terms: tuple, primes: tuple) -> torch.Tensor:
        """``ntt.ntt_mul`` over the stacks ``coef`` (..., C, P, N) and
        ``ntt_rows`` (M, P, N), its rows counted as the three ops count
        them: (..., O, P, N) for O = len(terms)."""
        out = ntt.ntt_mul(coef, ntt_rows, terms, primes)
        stacks = self._rows(out) // len(terms)      # groups x primes
        c = self.counts
        c["ntt_forward"] += stacks * coef.shape[-3]
        c["mul_mod"] += stacks * sum(len(t) for t in terms)
        c["ntt_inverse"] += stacks * len(terms)
        c["ntt_mul"] += stacks * len(terms)
        return out

    def _spow_stack(self, k: int, n_primes: int) -> torch.Tensor:
        """s^1..s^k over the chain's first ``n_primes`` primes, a view
        (k, P, N) of the secret's stack, cached."""
        key = ("view", k, n_primes)
        got = self._spow_cache.get(key)
        if got is None:
            got = self._spow_cache[key] = self._spow[:k, :n_primes]
        return got

    def _sample_error(self, n: int) -> np.ndarray:
        return np.round(self._rng.normal(0.0, self.p.noise_std, n)
                        ).astype(np.int64)

    def _sample_uniform_int(self, n: int) -> np.ndarray:
        return self._rng.integers(0, 1 << 62, n, dtype=np.int64)

    def _init_secret(self) -> None:
        """s and s^2 in the NTT domain over the whole chain and P."""
        chain = self.chain
        s = torch.remainder(self._dev(self.s_int)[None, :], self.col(chain))
        s_ntt = self._fwd(s, chain)
        #: (2, L+2, N): s, s^2 per prime of the chain and P
        self._spow = torch.stack([s_ntt, self._mul(s_ntt, s_ntt, chain)])
        self._spow_cache: dict[tuple, torch.Tensor] = {}

    def _spow_rows(self, k: int, primes: tuple[int, ...]) -> torch.Tensor:
        """s^1..s^k over ``primes`` (a subset of the chain): (k, P, N), a
        copy made once (key generation's basis skips chain primes)."""
        key = (k, primes)
        got = self._spow_cache.get(key)
        if got is None:
            idx = torch.tensor([self.chain.index(q) for q in primes],
                               device=self.device)
            got = self._spow_cache[key] = \
                self._spow[:k].index_select(1, idx).contiguous()
        return got

    def _make_evk(self, level: int) -> torch.Tensor:
        """Keys for relinearizing a level-``level`` product: (2, D, B, N),
        b then a, for D digits over B = D + 1 basis primes."""
        p = self.p
        primes = p.level_primes(level)
        basis = tuple(primes) + (p.special_prime,)
        P = p.special_prime
        Q = 1
        for q in primes:
            Q *= q
        draws = []
        for _ in primes:        # a then e per digit, the reference's order
            draws.append(self._sample_uniform_int(p.n_ring))
            draws.append(self._sample_error(p.n_ring))
        d = len(primes)
        ae = self._dev(np.stack(draws).reshape(d, 2, p.n_ring)
                       .transpose(1, 0, 2))
        qb = self.col(basis)
        f = self._fwd(torch.remainder(ae[:, :, None, :], qb), basis)
        aj, ej = f[0], f[1]                               # (D, B, N)
        s, s2 = self._spow_rows(2, basis)                 # (B, N) each
        as_ = self._mul(aj, s, basis)           # s: one stack for all D
        term = np.zeros((d, len(basis), 1), dtype=np.int64)
        for i, qi in enumerate(primes):
            qhat = Q // qi
            qtilde = qhat * pow(qhat, -1, qi)   # CRT interpolant for q_i
            for j, qj in enumerate(basis):
                term[i, j, 0] = (P % qj) * (qtilde % qj) % qj
        # term * s2 < 2^62, plus 2q + e < 2^33: below 2^63
        b = (2 * qb + ej + self._dev(term) * s2 - as_) % qb
        return torch.stack([b, aj])

    def evk(self, level: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The level's evaluation key (b, a), each (digits, basis, N)."""
        return self._evk[level][0], self._evk[level][1]

    # -- encode / encrypt -----------------------------------------------------

    def encode(self, z: np.ndarray, scale: float | None = None
               ) -> torch.Tensor:
        """Real/complex slots -> plaintext poly over the FULL chain, so the
        same encoded plaintext works at any level.  Shape (levels+1, N)."""
        p = self.p
        coeffs = encode(z, p.n_ring, scale or p.scale)
        return torch.remainder(self._dev(coeffs)[None, :],
                               self.col(p.primes))

    def encrypt(self, pt_full: torch.Tensor) -> torch.Tensor:
        """Plaintext poly (levels+1, N) -> fresh ct (2, levels+1, N)."""
        p = self.p
        primes = p.primes
        a_int = self._sample_uniform_int(p.n_ring)
        e_int = self._sample_error(p.n_ring)
        q = self.col(primes)
        ae = torch.remainder(self._dev(np.stack([a_int, e_int]))[:, None, :],
                             q)
        aj, ej = ae[0], ae[1]
        # the chain's first P rows of s are the primes' (no gather)
        as_ = self._fused(ae[:1], self._spow_stack(1, len(primes)),
                          ONE_TERM, tuple(primes))[0]
        c0 = (pt_full + ej + (q - as_)) % q
        return torch.stack([c0, aj])

    def decrypt(self, ct: torch.Tensor, level: int) -> torch.Tensor:
        """ct (ncomp, level+1, N) -> plaintext coeffs (level+1, N)."""
        primes = tuple(self.p.level_primes(level))
        q = self.col(primes)
        acc = ct[0] % q
        k = ct.shape[0] - 1
        if k:
            back = self._fused(ct[1:] % q,
                               self._spow_stack(k, len(primes)),
                               sum_terms(k), primes)[0]
            acc = (acc + back) % q
        return acc

    def decode(self, pt: torch.Tensor, level: int,
               scale: float) -> np.ndarray:
        """CRT-combine centered coefficients (host, Python ints) and decode
        to slots."""
        p = self.p
        primes = p.level_primes(level)
        host = pt.cpu().numpy()
        if len(primes) == 1:
            v = host[0]
            coeffs = np.where(v > primes[0] // 2, v - primes[0], v
                              ).astype(np.float64)
        else:
            Q = 1
            for q in primes:
                Q *= q
            acc = np.zeros(p.n_ring, dtype=object)
            for j, qj in enumerate(primes):
                qhat = Q // qj
                w = qhat * pow(qhat, -1, qj)
                acc = acc + host[j].astype(object) * w
            acc = np.mod(acc, Q)
            acc = np.where(acc > Q // 2, acc - Q, acc)
            coeffs = acc.astype(np.float64)
        return decode(coeffs, p.n_ring, scale)

    # -- homomorphic ops ------------------------------------------------------

    @staticmethod
    def _pad(c: torch.Tensor, ncomp: int) -> torch.Tensor:
        """Zero components up to ``ncomp`` (axis -3)."""
        k = c.shape[-3]
        if k == ncomp:
            return c
        shape = (*c.shape[:-3], ncomp - k, *c.shape[-2:])
        return torch.cat([c, c.new_zeros(shape)], dim=-3)

    def add(self, c1: torch.Tensor, c2: torch.Tensor,
            level: int) -> torch.Tensor:
        q = self.col(self.p.level_primes(level))
        nc = max(c1.shape[-3], c2.shape[-3])
        return (self._pad(c1, nc) + self._pad(c2, nc)) % q

    def sub(self, c1: torch.Tensor, c2: torch.Tensor,
            level: int) -> torch.Tensor:
        q = self.col(self.p.level_primes(level))
        nc = max(c1.shape[-3], c2.shape[-3])
        return (self._pad(c1, nc) + q - self._pad(c2, nc) % q) % q

    def mul_tensor(self, c1: torch.Tensor, c2: torch.Tensor,
                   level: int) -> torch.Tensor:
        """(c0,c1) x (d0,d1) -> 3-component ct at the same level (no relin).
        c1, c2: (..., 2, P, N)."""
        primes = tuple(self.p.level_primes(level))
        q = self.col(primes)
        x = torch.cat([c1, c2], dim=-3) % q              # a0, a1, b0, b1
        return self._fused(x, None, TENSOR_TERMS, primes)

    def relinearize(self, ct3: torch.Tensor, level: int) -> torch.Tensor:
        """3-comp -> 2-comp at the same level (hybrid key switching)."""
        p = self.p
        primes = tuple(p.level_primes(level))
        basis = primes + (p.special_prime,)
        P = p.special_prime
        d = len(primes)
        qb = self.col(basis)
        # digit i (a residue < q_i), reduced mod every basis prime
        dj = torch.remainder(ct3[2][:, None, :], qb)      # (D, B, N)
        # each key half's sum over digits, both halves from one transform
        # of each digit; at a level of more digits than one launch takes,
        # a sum of such calls over parts of the digits (equal mod q: the
        # inverse transform is linear)
        back = None                                        # (2, B, N)
        for lo, hi, keys in self._relin_keys[level]:
            part = self._fused(dj[lo:hi], keys, sum_terms(hi - lo, 2),
                               basis)
            back = part if back is None else (back + part) % qb
        q = self.col(primes)
        inv_np = self.inv_col(P, primes)
        dP = _center(back[:, d], P)                        # (2, N)
        t = (back[:, :d] + torch.remainder(-dP[:, None, :], q)) % q
        # t * inv < 2^62, plus a residue: below 2^63
        return (ct3[:2] + t * inv_np) % q

    def rescale(self, ct: torch.Tensor, level: int) -> torch.Tensor:
        """Drop the last prime; divides the message scale by q_level."""
        primes = self.p.level_primes(level)
        ql = primes[-1]
        rest = primes[:-1]
        q = self.col(rest)
        inv = self.inv_col(ql, rest)
        last = _center(ct[..., -1:, :], ql)
        t = (ct[..., :-1, :] + torch.remainder(-last, q)) % q
        return (t * inv) % q

    def mul(self, c1: torch.Tensor, c2: torch.Tensor,
            level: int) -> torch.Tensor:
        """Full multiply: tensor + relinearize + rescale -> level-1 ct."""
        t = self.mul_tensor(c1, c2, level)
        r = self.relinearize(t, level)
        return self.rescale(r, level)

    def mul_plain(self, ct: torch.Tensor, pt_full: torch.Tensor,
                  level: int) -> torch.Tensor:
        """ct x plaintext, then rescale -> level-1 ct."""
        primes = tuple(self.p.level_primes(level))
        q = self.col(primes)
        k = ct.shape[0]
        x = torch.cat([ct, pt_full[None, :len(primes)]]) % q
        out = self._fused(x, None, plain_terms(k), primes)
        return self.rescale(out, level)

    def add_plain(self, ct: torch.Tensor, pt_full: torch.Tensor,
                  level: int) -> torch.Tensor:
        """ct (..., ncomp, P, N) + pt_full (..., levels+1, N) on c0."""
        n_p = level + 1
        q = self.col(self.p.level_primes(level))
        out = ct.clone()
        out[..., 0, :, :] = (ct[..., 0, :, :] + pt_full[..., :n_p, :]) % q
        return out
