"""The NTT and modular-product wrappers the protocol layer calls, with
launch counters.

Operands are ``int64`` tensors of shape ``(..., N)`` holding residues in
``[0, q)``.  ``primes`` is one prime for every row, or a sequence of P
primes for the rows along axis -2, so that a stack ``(..., P, N)`` of RNS
polynomials (every prime of a level, every component of a ciphertext) is one
launch.  On a CUDA tensor a wrapper launches its kernel on the current
stream (no synchronisation, outputs allocated here); on a CPU tensor it runs
the plain version in ``ref.py``; on anything else it raises.  It also raises
for a prime of 2^31 or more, for N not a power of two, for N above
``MAX_N``, and (transforms on the card) for an operand that does not start
on a 16-byte boundary.

Twiddle tables and per-prime constants are built on the host once per
(primes, N, device) and kept on the device; the primes' checks also run
once per (primes, N, device).  The counters count kernel
launches and the rows they transformed or multiplied, and, apart, the calls
that ran the plain versions, so a run can show that its transforms went
through the kernels.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from . import kernel, ref
from .tables import barrett, ntt_tables, shoup

#: the largest ring a kernel takes: a row in the registers of one CTA (512
#: threads of 16 coefficients), exchanged through 64 KiB of shared memory
MAX_N = 8192
KINDS = ("ntt_forward", "ntt_inverse", "mul_mod")

_lock = threading.Lock()
launches: Counter = Counter()        # kind -> kernel launches
rows: Counter = Counter()            # kind -> rows through the kernel
plain_calls: Counter = Counter()     # kind -> calls that ran ref.py
launch_sizes: dict[str, Counter] = {k: Counter() for k in KINDS}


def reset_counts() -> None:
    with _lock:
        for c in (launches, rows, plain_calls, *launch_sizes.values()):
            c.clear()


def counts() -> dict:
    with _lock:
        return {"launches": {k: launches[k] for k in KINDS},
                "rows": {k: rows[k] for k in KINDS},
                "plain_calls": {k: plain_calls[k] for k in KINDS},
                "launch_sizes": {k: dict(v) for k, v in launch_sizes.items()}}


def _count(kind: str, n_rows: int) -> None:
    with _lock:
        launches[kind] += 1
        rows[kind] += n_rows
        launch_sizes[kind][n_rows] += 1


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrimeTables:
    """Everything the kernels and the plain versions need for P primes at
    ring N on one device."""
    primes: tuple[int, ...]
    n: int
    q: torch.Tensor          # (P, 1) int64
    psi: torch.Tensor        # (P, N) int64, psi powers bit-reversed
    psi_inv: torch.Tensor    # (P, N) int64, psi^-1 powers bit-reversed
    n_inv: torch.Tensor      # (P, 1) int64
    tw: torch.Tensor         # (P, 2, N, 2) uint32 bits: (psi[i], its Shoup
    #                          quotient), then the same of psi^-1
    consts: torch.Tensor     # (P, 8) uint32 bits: NttPrime rows


_tables: dict[tuple, PrimeTables] = {}


def prime_consts(q: int, n: int) -> list[int]:
    """One NttPrime row (``csrc/ntt_arith.cuh``): q, N^-1 and its Shoup
    quotient, Barrett's mu and k, then psi^-1[1] N^-1 (the inverse's last
    twiddle with the final scaling folded in) and its Shoup quotient."""
    _, psi_inv, n_inv = ntt_tables(q, n)
    mu, k = barrett(q)
    w1 = int(psi_inv[1]) * n_inv % q
    return [q, n_inv, int(shoup(n_inv, q)), mu, k, w1, int(shoup(w1, q)), 0]


def tables(primes: tuple[int, ...], n: int,
           device: torch.device) -> PrimeTables:
    key = (primes, n, device)
    got = _tables.get(key)
    if got is not None:
        return got
    psi, psi_inv, n_inv = zip(*(ntt_tables(q, n) for q in primes))
    psi, psi_inv = np.stack(psi), np.stack(psi_inv)
    tw_np = np.stack([np.stack([np.stack([w, shoup(w, q)], axis=-1),
                                np.stack([wi, shoup(wi, q)], axis=-1)])
                      for q, w, wi in zip(primes, psi, psi_inv)])
    c_np = np.array([prime_consts(q, n) for q in primes], dtype=np.uint64)
    col = np.asarray(primes, dtype=np.int64)[:, None]
    got = PrimeTables(
        primes, n, torch.from_numpy(col).to(device),
        torch.from_numpy(psi.astype(np.int64)).to(device),
        torch.from_numpy(psi_inv.astype(np.int64)).to(device),
        torch.from_numpy(np.asarray(n_inv, dtype=np.int64)[:, None]
                         ).to(device), _u32_tensor(tw_np, device),
        _u32_tensor(c_np, device))
    with _lock:
        return _tables.setdefault(key, got)


def _u32_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 values (given as uint64) -> an int32 bit view on ``device``."""
    if int(x.max(initial=0)) >> 32:
        raise ValueError("table entry does not fit 32 bits")
    return torch.from_numpy(np.ascontiguousarray(
        x.astype(np.uint32)).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _check(a: torch.Tensor, name: str) -> None:
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(a)}")
    if a.dtype != torch.int64 or a.dim() < 1:
        raise ValueError(f"{name} must be an int64 tensor (..., N), got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NTT kernel for device {a.device}")
    if not a.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _validate(primes: int | Sequence[int], n: int) -> tuple[int, ...]:
    """Check N and every prime; returns the primes as a tuple of ints."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"N = {n} is not a power of two >= 2")
    if n > MAX_N:
        raise ValueError(f"N = {n} exceeds the kernels' largest ring "
                         f"{MAX_N} (a row must fit shared memory)")
    ps = (int(primes),) if isinstance(primes, (int, np.integer)) \
        else tuple(int(q) for q in primes)
    for q in ps:
        if not 2 < q < 1 << 31:
            raise ValueError(f"q = {q} is out of range: the kernels take "
                             f"odd primes below 2^31")
        if (q - 1) % (2 * n):
            raise ValueError(f"q = {q} is not 1 mod 2N (N = {n})")
    return ps


#: (primes as the caller gave them, N, device) -> (the checked primes, their
#: tables), for primes given as an int or a tuple (the cipher layer passes
#: tuples)
_prepared: dict[tuple, tuple[tuple[int, ...], PrimeTables]] = {}


def _prepare(a: torch.Tensor, primes: int | Sequence[int]
             ) -> tuple[tuple[int, ...], int, PrimeTables]:
    """(primes, N, tables) for an operand.  The primes' checks and the
    table lookup run once per (primes, N, device); the rows of ``a`` are
    checked against the number of primes every call."""
    n = a.shape[-1]
    key = (primes, n, a.device) if type(primes) is tuple or \
        isinstance(primes, (int, np.integer)) else None
    got = _prepared.get(key) if key is not None else None
    if got is None:
        ps = _validate(primes, n)
        got = ps, tables(ps, n, a.device)
        if key is not None:
            with _lock:
                _prepared[key] = got
    ps, t = got
    if len(ps) > 1 and (a.dim() < 2 or a.shape[-2] != len(ps)):
        raise ValueError(f"{len(ps)} primes for rows of shape "
                         f"{tuple(a.shape)}: axis -2 must have one row per "
                         f"prime")
    return ps, n, t


def _n_rows(a: torch.Tensor, n: int) -> int:
    rows = a.numel() // n
    if rows >= 1 << 31:
        raise ValueError(f"{rows} rows exceed one launch's grid (2^31 - 1)")
    return rows


def _stacks(a: torch.Tensor, n_primes: int) -> torch.Tensor:
    return a.reshape(-1, n_primes, a.shape[-1])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _transform(a: torch.Tensor, primes, inverse: bool) -> torch.Tensor:
    kind = "ntt_inverse" if inverse else "ntt_forward"
    _check(a, "a")
    ps, n, t = _prepare(a, primes)
    n_rows = _n_rows(a, n)
    if a.device.type == "cpu":
        with _lock:
            plain_calls[kind] += 1
        v = _stacks(a, len(ps))
        out = ref.ntt_inverse(v, t.q, t.psi_inv, t.n_inv) if inverse \
            else ref.ntt_forward(v, t.q, t.psi)
        return out.reshape(a.shape)
    if a.data_ptr() % 16:
        raise ValueError("a must start on a 16-byte boundary: the kernels "
                         "read rows two coefficients at a time")
    out = torch.empty_like(a)
    if n_rows:   # an empty batch launches nothing
        kernel.launch_transform(inverse, a, out, t.tw, t.consts, len(ps),
                                n.bit_length() - 1, n_rows)
        _count(kind, n_rows)
    return out


def ntt_forward(a: torch.Tensor, primes: int | Sequence[int]
                ) -> torch.Tensor:
    """Negacyclic forward NTT of every row: standard order in,
    bit-reversed order out (``repro.protocols.ckks.ntt.ntt_forward``)."""
    return _transform(a, primes, inverse=False)


def ntt_inverse(a: torch.Tensor, primes: int | Sequence[int]
                ) -> torch.Tensor:
    """Inverse negacyclic NTT of every row: bit-reversed in, standard
    order out, times N^-1."""
    return _transform(a, primes, inverse=True)


def mul_mod(a: torch.Tensor, b: torch.Tensor,
            primes: int | Sequence[int]) -> torch.Tensor:
    """a * b mod q, elementwise; ``a`` and ``b`` of one shape."""
    _check(a, "a")
    _check(b, "b")
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"b is {tuple(b.shape)} on {b.device}, expected "
                         f"{tuple(a.shape)} on {a.device}")
    ps, n, t = _prepare(a, primes)
    n_rows = _n_rows(a, n)
    if a.device.type == "cpu":
        with _lock:
            plain_calls["mul_mod"] += 1
        return ref.mul_mod(_stacks(a, len(ps)), _stacks(b, len(ps)),
                           t.q).reshape(a.shape)
    out = torch.empty_like(a)
    if n_rows:
        kernel.launch_mul_mod(a, b, out, t.consts, len(ps),
                              n.bit_length() - 1, n_rows)
        _count("mul_mod", n_rows)
    return out
