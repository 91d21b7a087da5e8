"""The NTT, modular-product and fused negacyclic-product wrappers the
protocol layer calls, with launch counters.

Operands are ``int64`` tensors of shape ``(..., N)`` holding residues in
``[0, q)``.  ``primes`` is one prime for every row, or a sequence of P
primes for the rows along axis -2, so that a stack ``(..., P, N)`` of RNS
polynomials (every prime of a level, every component of a ciphertext) is one
launch.  On a CUDA tensor a wrapper launches its kernel on the current
stream (no synchronisation, outputs allocated here); on a CPU tensor it runs
the plain version in ``ref.py``; on anything else it raises.  It also raises
for a prime of 2^31 or more, for N not a power of two, for N above
``MAX_N``, and (on the card) for an operand that does not start on a
16-byte boundary.

``ntt_mul`` is the fused product: INV(sum of X_i * X_j) for each output,
X_i the forward transform of a coefficient operand or an operand already
in the NTT domain, in one launch (``repro.kernels.ntt.ops.negacyclic_mul``
and the cipher layer's sums of products).  It counts its launches under
``ntt_mul`` and adds the rows it transformed, multiplied and transformed
back to ``ntt_forward``, ``mul_mod`` and ``ntt_inverse``, so the rows
through the kernels still equal the rows the cipher asked for.

Twiddle tables and per-prime constants are built on the host once per
(primes, N, device) and kept on the device; the primes' checks also run
once per (primes, N, device).  The counters count kernel
launches and the rows they transformed or multiplied, and, apart, the calls
that ran the plain versions, so a run can show that its transforms went
through the kernels.
"""

from __future__ import annotations

import dataclasses
import functools
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
KINDS = ("ntt_forward", "ntt_inverse", "mul_mod", "ntt_mul")

_lock = threading.Lock()
launches: Counter = Counter()        # kind -> kernel launches
rows: Counter = Counter()            # kind -> rows through the kernel
plain_calls: Counter = Counter()     # kind -> calls that ran ref.py
launch_sizes: dict[str, Counter] = {k: Counter() for k in KINDS}
#: ntt_mul launches by job shape (n_coef, n_ntt, terms, groups, primes)
mul_shapes: Counter = Counter()


def reset_counts() -> None:
    with _lock:
        for c in (launches, rows, plain_calls, mul_shapes,
                  *launch_sizes.values()):
            c.clear()


def counts() -> dict:
    with _lock:
        return {"launches": {k: launches[k] for k in KINDS},
                "rows": {k: rows[k] for k in KINDS},
                "plain_calls": {k: plain_calls[k] for k in KINDS},
                "launch_sizes": {k: dict(v) for k, v in launch_sizes.items()},
                "mul_shapes": dict(mul_shapes)}


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


def _check_rows(a: torch.Tensor, name: str) -> None:
    """``_check`` for an operand that may be a view: its rows are checked
    apart (``_group_stride``)."""
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(a)}")
    if a.dtype != torch.int64 or a.dim() < 1:
        raise ValueError(f"{name} must be an int64 tensor (..., N), got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NTT kernel for device {a.device}")


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
    _aligned(a, "a")
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


def _aligned(a: torch.Tensor, name: str) -> None:
    if a.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary: the "
                         f"kernels read rows two coefficients at a time")


def mul_mod(a: torch.Tensor, b: torch.Tensor,
            primes: int | Sequence[int]) -> torch.Tensor:
    """a * b mod q, elementwise; ``b`` of ``a``'s shape or, for P > 1
    primes, one stack (P, N) that every stack of ``a`` takes."""
    _check(a, "a")
    _check(b, "b")
    ps, n, t = _prepare(a, primes)
    stack = len(ps) > 1 and b.shape == (len(ps), n)
    if (b.shape != a.shape and not stack) or b.device != a.device:
        raise ValueError(f"b is {tuple(b.shape)} on {b.device}, expected "
                         f"{tuple(a.shape)} on {a.device}")
    n_rows = _n_rows(a, n)
    if a.device.type == "cpu":
        with _lock:
            plain_calls["mul_mod"] += 1
        return ref.mul_mod(_stacks(a, len(ps)), _stacks(b, len(ps)),
                           t.q).reshape(a.shape)
    _aligned(a, "a")
    _aligned(b, "b")
    out = torch.empty_like(a)
    if n_rows:
        kernel.launch_mul_mod(a, b, out, t.consts, len(ps),
                              n.bit_length() - 1, b.numel() // n, n_rows)
        _count("mul_mod", n_rows)
    return out


# ---------------------------------------------------------------------------
# the fused product
# ---------------------------------------------------------------------------

Terms = Sequence[Sequence[tuple[int, int]]]

#: from this many (group, prime) stacks (two for each of the H100's 132
#: SMs) each stack takes one CTA, its rows one after another, instead of
#: a cluster of one CTA a row: the smallest count from which one CTA was
#: as fast or faster in every shape that ``tools/ntt_mul_spread.py`` timed
#: (PERF.md); below it the clusters' rows side by side win
MUL_SPREAD_LIMIT = 264


def mul_fits(n: int, n_coef: int, n_ntt: int, n_terms: int,
             n_out: int) -> bool:
    """Whether one fused launch takes a job of this size at ring n: its
    operands, terms and outputs within the kernel's limits, and its
    transformed coefficient rows within a CTA's shared memory."""
    return (1 <= n_coef and n_coef + n_ntt <= kernel.MUL_MAX_IN and
            n_terms <= kernel.MUL_MAX_TERMS and
            1 <= n_out <= kernel.MUL_MAX_OUT and
            kernel.mul_smem_bytes(n.bit_length() - 1, n_coef, n_ntt,
                                  False) <= kernel.MUL_MAX_SMEM)


@functools.lru_cache(maxsize=1024)
def _terms(terms: tuple, n_in: int) -> tuple[int, tuple[int, ...],
                                              tuple[int, ...]]:
    """(number of terms, each output's end in the term list, the terms'
    operand indices flat), checked once per (terms, operands)."""
    if not 1 <= len(terms) <= kernel.MUL_MAX_OUT:
        raise ValueError(f"{len(terms)} outputs: the kernel takes 1 to "
                         f"{kernel.MUL_MAX_OUT}")
    ends, flat = [], []
    for o, out_terms in enumerate(terms):
        if not out_terms:
            raise ValueError(f"output {o} has no term")
        for term in out_terms:
            if len(term) != 2 or not all(
                    isinstance(i, int) and 0 <= i < n_in for i in term):
                raise ValueError(f"term {term} of output {o}: two operand "
                                 f"indices below {n_in} expected")
            flat.extend(term)
        ends.append(len(flat) // 2)
    if ends[-1] > kernel.MUL_MAX_TERMS:
        raise ValueError(f"{ends[-1]} terms: the kernel takes at most "
                         f"{kernel.MUL_MAX_TERMS}")
    return ends[-1], tuple(ends), tuple(flat)


def _stack_layout(shape: tuple, strides: tuple, lead: tuple,
                  k: int) -> tuple[int, int]:
    """(group stride, operand stride), in elements, of an operand stack
    (*lead', S, *rows) whose leading dimensions broadcast to ``lead``: the
    one stride between the rows of consecutive groups (``lead``
    flattened; 0 where the stack is broadcast over them) and between
    consecutive operands.  Raises where the rows are not contiguous or the
    groups not one stride apart."""
    n = shape[-1]
    if strides[-1] != 1 or (k == 2 and shape[-2] > 1 and strides[-2] != n):
        raise ValueError(f"an operand's rows must be contiguous, each stack "
                         f"of P rows one after the other: shape {shape}, "
                         f"strides {strides}")
    sizes, st = shape[:-k - 1], strides[:-k - 1]
    pad = len(lead) - len(sizes)
    if pad < 0:
        raise ValueError(f"operands {shape} have more leading dimensions "
                         f"than the job's {lead}")
    gs, span = None, 1
    for d in range(len(lead) - 1, -1, -1):
        size = sizes[d - pad] if d >= pad else 1
        stride = st[d - pad] if d >= pad and size > 1 else 0
        if size not in (1, lead[d]):
            raise ValueError(f"operands {shape} do not broadcast to {lead}")
        if lead[d] > 1:
            if gs is None:
                gs, rem = divmod(stride, span)
                if rem:
                    gs = -1
            if stride != gs * span:
                raise ValueError(f"operands {shape} with strides {strides}: "
                                 f"the groups are not one stride apart")
            span *= lead[d]
    return gs or 0, strides[-k - 1]


@dataclasses.dataclass
class _MulPlan:
    """What a fused call of one signature (operand shapes, strides, dtypes
    and devices, terms, primes) needs, checked once."""
    t: PrimeTables
    logn: int
    k: int                  # row dimensions: 1 (one prime) or 2 (P, N)
    lead: tuple
    groups: int
    n_coef: int
    n_ntt: int
    terms: tuple
    out_shape: tuple
    desc: np.ndarray | None   # the card's descriptor (parse_job), the
    #                           operands' and output's addresses filled per
    #                           call (words 7, 10, 13)
    desc_ptr: int             # the descriptor's address
    counts: tuple             # (output rows, forward, product, inverse rows)


_mul_plans: dict[tuple, _MulPlan] = {}


def _stacked(x, k: int, name: str) -> torch.Tensor:
    """An operand stack: a tensor as given, or a sequence stacked on the
    operand axis (-k - 1)."""
    if isinstance(x, torch.Tensor):
        return x
    xs = list(x)
    if not xs:
        raise ValueError(f"{name}: no operand")
    return torch.stack(xs, dim=-k - 1)


def _mul_plan(coef: torch.Tensor, ntt: torch.Tensor | None, terms,
              primes) -> _MulPlan:
    k = 1 if isinstance(primes, (int, np.integer)) else 2
    stacks = (coef,) if ntt is None else (coef, ntt)
    for x, name in zip(stacks, ("coef", "ntt")):
        _check_rows(x, name)
        if x.dim() < k + 1:
            raise ValueError(f"{name} must be a stack (..., S, "
                             f"{'P, ' if k == 2 else ''}N), got "
                             f"{tuple(x.shape)}")
    ps, n, t = _prepare(coef, primes)
    P = len(ps)
    if k == 2 and coef.shape[-2] != P:
        raise ValueError(f"{P} primes for rows of shape {tuple(coef.shape)}"
                         f": axis -2 must have one row per prime")
    tail = tuple(coef.shape[-k:])
    if ntt is not None and (tuple(ntt.shape[-k:]) != tail or
                            ntt.device != coef.device):
        raise ValueError(f"ntt is {tuple(ntt.shape)} on {ntt.device}, "
                         f"expected rows (..., {', '.join(map(str, tail))})"
                         f" on {coef.device}")
    n_coef = coef.shape[-k - 1]
    n_ntt = 0 if ntt is None else ntt.shape[-k - 1]
    n_in = n_coef + n_ntt
    if not 1 <= n_coef or n_in > kernel.MUL_MAX_IN:
        raise ValueError(f"{n_coef} coefficient and {n_ntt} NTT-domain "
                         f"operands: the kernel takes 1 to "
                         f"{kernel.MUL_MAX_IN}, one coefficient operand at "
                         f"least")
    n_terms, ends, flat = _terms(terms, n_in)
    n_out = len(ends)
    lead = tuple(torch.broadcast_shapes(*(x.shape[:-k - 1]
                                          for x in stacks)))
    groups = int(np.prod(lead, dtype=np.int64)) if lead else 1
    logn = n.bit_length() - 1
    teams = 1 if groups * P >= MUL_SPREAD_LIMIT else \
        min(kernel.MUL_MAX_TEAMS, max(n_coef, n_out))
    if kernel.mul_smem_bytes(logn, n_coef, n_ntt, False) > \
            kernel.MUL_MAX_SMEM:
        raise ValueError(f"{n_coef} coefficient operands at N = {n} need "
                         f"more shared memory than a CTA has")
    layouts = [_stack_layout(tuple(x.shape), x.stride(), lead, k)
               for x in stacks]
    desc = None
    if coef.device.type == "cuda":
        if any(v % 2 for lay in layouts for v in lay):
            raise ValueError("operand and group strides must be even: the "
                             "kernel reads rows two coefficients (16 "
                             "bytes) at a time")
        (cgs, cs), (ngs, ns) = layouts[0], layouts[-1] if ntt is not None \
            else (0, 0)
        half = n // 2
        stage = n_ntt > 0 and kernel.mul_smem_bytes(
            logn, n_coef, n_ntt, True) <= kernel.MUL_MAX_SMEM
        desc = np.array([n_coef, n_in, n_out, P, groups, int(stage), teams,
                         0, cgs // 2, cs // 2, 0, ngs // 2, ns // 2,
                         0, n_out * P * half, P * half, t.tw.data_ptr(),
                         t.consts.data_ptr(), *ends, *flat], dtype=np.int64)
    stacks_ = groups * P
    return _MulPlan(t, logn, k, lead, groups, n_coef, n_ntt, terms,
                    (*lead, n_out, *tail), desc,
                    0 if desc is None else desc.ctypes.data,
                    (stacks_ * n_out, stacks_ * n_coef, stacks_ * n_terms,
                     stacks_ * n_out))


def ntt_mul(coef, ntt, terms: Terms, primes: int | Sequence[int]
            ) -> torch.Tensor:
    """Sums of negacyclic products in one launch:

        out[..., o, :, :] = INV( sum over (i, j) in terms[o] of
                                 X_i * X_j mod q )

    over the operands ``coef[..., 0..C-1, :, :]`` then ``ntt[..., 0..M-1,
    :, :]``: X_i = FWD(operand i) for a coefficient operand and operand i
    itself for one already in the NTT domain (bit-reversed order).  Each
    of ``coef`` and ``ntt`` (``ntt`` may be None) is a stack ``(...,
    S, P, N)`` of S operands (``(..., S, N)`` for one prime), or a sequence
    of ``(..., P, N)`` operands, stacked here (a copy); the stacks' leading
    dimensions broadcast to one shape ``lead``, and a stack may be a view
    (rows contiguous, its operands and its groups each one stride apart).
    Returns ``(*lead, O, P, N)`` (``(*lead, O, N)`` for one prime),
    O = len(terms).  Each output is what ``ntt_inverse`` of the ``mul_mod``
    sums of ``ntt_forward`` gives, bit for bit.

    On the card one cluster of CTAs (one a row of the larger of the
    coefficient operands and the outputs, at most 8; a single CTA from
    ``MUL_SPREAD_LIMIT`` stacks on) computes every output of one stack.
    The plan of a call (its checks, the card's descriptor) is kept per
    signature: the operands' shapes, strides, dtypes and devices, the
    terms and the primes."""
    k = 1 if isinstance(primes, (int, np.integer)) else 2
    coef = _stacked(coef, k, "coef")
    if ntt is not None and not isinstance(ntt, torch.Tensor):
        ntt = _stacked(ntt, k, "ntt") if len(ntt) else None
    if not isinstance(terms, tuple):
        terms = tuple(tuple(tuple(tm) for tm in o) for o in terms)
    key = (coef.shape, coef.stride(), coef.dtype, coef.device,
           None if ntt is None else
           (ntt.shape, ntt.stride(), ntt.dtype, ntt.device), terms,
           primes if type(primes) is tuple or k == 1 else tuple(primes))
    try:
        plan = _mul_plans.get(key)
    except TypeError:     # terms holding lists
        key, plan = None, None
    if plan is None:
        plan = _mul_plan(coef, ntt, terms, primes)
        if key is not None:
            with _lock:
                _mul_plans[key] = plan
    if coef.device.type == "cpu":
        with _lock:
            plain_calls["ntt_mul"] += 1
        t, k = plan.t, plan.k
        tail = tuple(coef.shape[-k:])
        ops_ = [coef] if ntt is None else [coef, ntt]
        xs = []
        for x in ops_:
            s_ = x.shape[-k - 1]
            v = x.expand(*plan.lead, s_, *tail).reshape(
                plan.groups, s_, -1, tail[-1])
            xs += [v[:, i] for i in range(s_)]
        out = ref.ntt_mul(xs, plan.n_coef, plan.terms, t.q, t.psi,
                          t.psi_inv, t.n_inv)
        return out.reshape(plan.out_shape)
    cptr = coef.data_ptr()
    nptr = 0 if ntt is None else ntt.data_ptr()
    if cptr % 16 or nptr % 16:
        raise ValueError("every operand must start on a 16-byte boundary: "
                         "the kernel reads rows two coefficients at a time")
    out = torch.empty(plan.out_shape, dtype=torch.int64, device=coef.device)
    if plan.groups:
        d = plan.desc
        n_out, fwd, mul, inv = plan.counts
        with _lock:
            d[7], d[10], d[13] = cptr, nptr, out.data_ptr()
            kernel.launch_mul(plan.desc_ptr, plan.logn, out.device.index)
            launches["ntt_mul"] += 1
            rows["ntt_mul"] += n_out
            launch_sizes["ntt_mul"][n_out] += 1
            rows["ntt_forward"] += fwd
            rows["mul_mod"] += mul
            rows["ntt_inverse"] += inv
            mul_shapes[(plan.n_coef, plan.n_ntt, plan.terms, plan.groups,
                        len(plan.t.primes))] += 1
    return out
