"""Round-structured n-party Shamir workloads + vectorized trace builders:
the port's copy of ``repro.workloads.shamir_workloads``.

Two workload families over GF(2^61 - 1), both parameterized by the party
count through ``num_workers`` (the n Shamir parties ARE the n workers,
as in the JAX package):

* ``shamir_stats`` — threshold statistics over B = n / 256 secret blocks:
  sum, mean (sum * B^-1) and variance (E[x^2] - mean^2).  The B
  elementwise squares are *independent* multiplication rounds inside one
  barrier-free window — the communication shape the overlap pass hides.
* ``shamir_cmp`` — an equality-comparison tree: leaf differences
  x_b - y_b, a log-depth multiplication tree (the root is 0 iff any leaf
  pair is equal), and a Fermat zero-test chain z^(p-1) — a deep
  sequential round structure (~119 dependent MULs).

Like ``fast_trace`` for the GC kernels, each family also has a
vectorized NumPy record builder that is digest-identical to the
FREE-stripped DSL trace (held by ``tests/test_torch_shamir.py``).  Shamir
traces pin every value until the trace closes, so allocation is a
strictly sequential page counter and the whole layout is closed-form:
the only Python-level iteration is one loop per *round batch* (tree
level / Fermat step).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bytecode import (_IMM_OFF, _IN_OFF, _OUT_OFF, RECORD_WORDS, Op,
                             ProgramFile, ProgramWriter)
from ..core.workers import ProgramOptions
from ..protocols.shamir.dsl import (ROUND_TAG, REVEAL_TAG, mul, reveal,
                                    share_input)
from ..protocols.shamir.field import (P, addmod, as_tensor, fold, inverse,
                                      lagrange_at_zero, mulmod,
                                      mulmod_scalar, submod, to_numpy)
from .base import Workload, register

SH_PAGE_SHIFT = 8          # 256 uint64 slots = 2 KiB pages
SH_VEC = 1 << SH_PAGE_SHIFT   # one full-page vector per secret block

A_TAGS = 0
B_TAGS = 1 << 20
OUT_TAGS = 1 << 24


def _blocks(n: int, lo: int = 1) -> int:
    b, rem = divmod(n, SH_VEC)
    if rem or b < lo:
        raise ValueError(f"shamir workloads need n a multiple of {SH_VEC} "
                         f"with at least {lo} blocks, got n={n}")
    return b


def _provider(data_by_base: dict[int, np.ndarray]):
    def provider(tag: int) -> np.ndarray:
        for base, data in data_by_base.items():
            if base <= tag < base + (1 << 20):
                i = tag - base
                return data[i * SH_VEC:(i + 1) * SH_VEC]
        raise KeyError(tag)
    return provider


def _stats_data(n: int) -> np.ndarray:
    rng = np.random.default_rng(7000 + n)
    return rng.integers(0, P, n, dtype=np.uint64)


def _cmp_data(n: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(8000 + n)
    x = rng.integers(0, P, n, dtype=np.uint64)
    d = rng.integers(1, P, n, dtype=np.uint64)    # never 0: lanes differ
    d[:SH_VEC // 2] = 0                           # block 0, low lanes: equal
    return x, to_numpy(addmod(as_tensor(x), as_tensor(d)))


# ---------------------------------------------------------------------------
# shamir_stats
# ---------------------------------------------------------------------------


def _stats_build(opts: ProgramOptions) -> None:
    b = _blocks(opts.problem_size)
    xs = [share_input(SH_VEC, A_TAGS + i) for i in range(b)]
    s = xs[0]
    for i in range(1, b):
        s = s + xs[i]
    inv_b = inverse(b)
    m = s.mulc(inv_b)
    sqs = [mul(x, x) for x in xs]
    q = sqs[0]
    for i in range(1, b):
        q = q + sqs[i]
    msq = q.mulc(inv_b)
    var = msq - mul(m, m)
    reveal(s, 0, OUT_TAGS + 0)
    reveal(m, 1, OUT_TAGS + 1)
    reveal(var, 2, OUT_TAGS + 2)


def _stats_inputs(n: int, worker: int, p: int):
    return _provider({A_TAGS: _stats_data(n)})


def _stats_oracle(n: int) -> dict[int, np.ndarray]:
    b = _blocks(n)
    x = fold(as_tensor(_stats_data(n))).reshape(b, SH_VEC)
    s = torch.zeros(SH_VEC, dtype=torch.int64)
    sq = torch.zeros(SH_VEC, dtype=torch.int64)
    for i in range(b):
        s = addmod(s, x[i])
        sq = addmod(sq, mulmod(x[i], x[i]))
    inv_b = inverse(b)
    m = mulmod_scalar(s, inv_b)
    var = submod(mulmod_scalar(sq, inv_b), mulmod(m, m))
    return {OUT_TAGS + 0: to_numpy(s), OUT_TAGS + 1: to_numpy(m),
            OUT_TAGS + 2: to_numpy(var)}


register(Workload("shamir_stats", "shamir", _stats_build, _stats_inputs,
                  _stats_oracle, page_shift=SH_PAGE_SHIFT, default_n=2048))


# ---------------------------------------------------------------------------
# shamir_cmp
# ---------------------------------------------------------------------------


def _cmp_build(opts: ProgramOptions) -> None:
    b = _blocks(opts.problem_size, lo=2)
    xs, ys = [], []
    for i in range(b):
        xs.append(share_input(SH_VEC, A_TAGS + i))
        ys.append(share_input(SH_VEC, B_TAGS + i))
    level = [x - y for x, y in zip(xs, ys)]
    while len(level) > 1:
        nxt = [mul(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    root = level[0]
    acc = root                                   # Fermat: root^(p-1)
    for bit in bin(P - 1)[3:]:                   # MSB consumed by acc=root
        acc = mul(acc, acc)
        if bit == "1":
            acc = mul(acc, root)
    reveal(acc, 0, OUT_TAGS + 0)


def _cmp_inputs(n: int, worker: int, p: int):
    x, y = _cmp_data(n)
    return _provider({A_TAGS: x, B_TAGS: y})


def _cmp_oracle(n: int) -> dict[int, np.ndarray]:
    b = _blocks(n, lo=2)
    x, y = _cmp_data(n)
    z = submod(fold(as_tensor(x)), fold(as_tensor(y))).reshape(b, SH_VEC)
    prod = z[0]
    for i in range(1, b):
        prod = mulmod(prod, z[i])
    return {OUT_TAGS + 0: (to_numpy(prod) != 0).astype(np.uint64)}


register(Workload("shamir_cmp", "shamir", _cmp_build, _cmp_inputs,
                  _cmp_oracle, page_shift=SH_PAGE_SHIFT, default_n=1024))


# ---------------------------------------------------------------------------
# vectorized record builders (digest-identical to the DSL trace)
# ---------------------------------------------------------------------------

_PAGE = SH_VEC


def _word0(op: Op, n_outs: int, n_ins: int, n_imm: int) -> int:
    return int(op) | n_outs << 16 | n_ins << 20 | n_imm << 24


def _rows(n: int) -> np.ndarray:
    return np.zeros((n, RECORD_WORDS), dtype=np.int64)


class _Rec:
    """Sequential-page record emitter mirroring the shamir DSL layout."""

    def __init__(self, worker: int, num_workers: int):
        if num_workers < 3:
            raise ValueError(f"shamir traces need num_workers >= 3, "
                             f"got {num_workers}")
        self.w = worker
        self.n = num_workers
        self.t = (num_workers - 1) // 2
        self.lam = lagrange_at_zero(num_workers)
        self.page = 0          # the DSL's strictly sequential page counter
        self.rid = 0
        self.out: list[np.ndarray] = []

    def pages(self, k: int) -> np.ndarray:
        """Allocate k sequential pages; returns their slot addresses."""
        a = (self.page + np.arange(k, dtype=np.int64)) * _PAGE
        self.page += k
        return a

    def inputs(self, tags: np.ndarray) -> np.ndarray:
        r = _rows(len(tags))
        addr = self.pages(len(tags))
        r[:, 0] = _word0(Op.INPUT, 1, 0, 2)
        r[:, _OUT_OFF] = addr
        r[:, _OUT_OFF + 1] = _PAGE
        r[:, _IMM_OFF] = SH_VEC
        r[:, _IMM_OFF + 1] = tags
        self.out.append(r)
        return addr

    def _bin(self, op: Op, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        r = _rows(len(a))
        addr = self.pages(len(a))
        r[:, 0] = _word0(op, 1, 2, 1)
        r[:, _OUT_OFF] = addr
        r[:, _OUT_OFF + 1] = _PAGE
        r[:, _IN_OFF] = a
        r[:, _IN_OFF + 1] = _PAGE
        r[:, _IN_OFF + 2] = b
        r[:, _IN_OFF + 3] = _PAGE
        r[:, _IMM_OFF] = SH_VEC
        self.out.append(r)
        return addr

    def add_chain(self, addrs: np.ndarray) -> int:
        """((a0+a1)+a2)... left fold; returns the final address."""
        acc = int(addrs[0])
        if len(addrs) > 1:
            outs = self.page * _PAGE + \
                np.arange(len(addrs) - 1, dtype=np.int64) * _PAGE
            prev = np.concatenate(([acc], outs[:-1]))
            r = _rows(len(addrs) - 1)
            self.pages(len(addrs) - 1)
            r[:, 0] = _word0(Op.F_ADD, 1, 2, 1)
            r[:, _OUT_OFF] = outs
            r[:, _OUT_OFF + 1] = _PAGE
            r[:, _IN_OFF] = prev
            r[:, _IN_OFF + 1] = _PAGE
            r[:, _IN_OFF + 2] = addrs[1:]
            r[:, _IN_OFF + 3] = _PAGE
            r[:, _IMM_OFF] = SH_VEC
            self.out.append(r)
            acc = int(outs[-1])
        return acc

    def mulc(self, a: int, c: int) -> int:
        r = _rows(1)
        addr = int(self.pages(1)[0])
        r[0, 0] = _word0(Op.F_MULC, 1, 1, 2)
        r[0, _OUT_OFF] = addr
        r[0, _OUT_OFF + 1] = _PAGE
        r[0, _IN_OFF] = a
        r[0, _IN_OFF + 1] = _PAGE
        r[0, _IMM_OFF] = SH_VEC
        r[0, _IMM_OFF + 1] = c % P
        self.out.append(r)
        return addr

    def sub(self, a: int, b: int) -> int:
        return int(self._bin(Op.F_SUB, np.array([a], dtype=np.int64),
                             np.array([b], dtype=np.int64))[0])

    def mul_rounds(self, xa: np.ndarray, ya: np.ndarray) -> np.ndarray:
        """A batch of R independent degree-reduction rounds (the DSL's
        ``mul``), emitted round-major; returns the R result addresses."""
        n, w, t = self.n, self.w, self.t
        big = np.int64(_PAGE)
        xa = np.asarray(xa, dtype=np.int64)
        ya = np.asarray(ya, dtype=np.int64)
        rr = len(xa)
        rpr, ppr = 4 * n - 1, 3 * n
        base = self.page * _PAGE + \
            np.arange(rr, dtype=np.int64)[:, None] * (ppr * _PAGE)
        self.pages(0)  # no-op, keeps intent explicit
        self.page += rr * ppr
        rid = self.rid + np.arange(rr, dtype=np.int64)[:, None]
        self.rid += rr
        a = np.zeros((rr, rpr, RECORD_WORDS), dtype=np.int64)
        # sub-share address of party i, as seen by worker w
        def sshare(i: int) -> np.ndarray:
            if i == w:
                return base + (1 + w) * _PAGE
            k = i if i < w else i - 1
            return base + (1 + n + k) * _PAGE
        k = 0
        a[:, k, 0] = _word0(Op.F_MUL_LOCAL, 1, 2, 1)
        a[:, k, _OUT_OFF] = base[:, 0]
        a[:, k, _OUT_OFF + 1] = big
        a[:, k, _IN_OFF] = xa
        a[:, k, _IN_OFF + 1] = big
        a[:, k, _IN_OFF + 2] = ya
        a[:, k, _IN_OFF + 3] = big
        a[:, k, _IMM_OFF] = SH_VEC
        for j in range(n):
            k += 1
            a[:, k, 0] = _word0(Op.F_EVAL, 1, 1, 4)
            a[:, k, _OUT_OFF] = base[:, 0] + (1 + j) * _PAGE
            a[:, k, _OUT_OFF + 1] = big
            a[:, k, _IN_OFF] = base[:, 0]
            a[:, k, _IN_OFF + 1] = big
            a[:, k, _IMM_OFF] = SH_VEC
            a[:, k, _IMM_OFF + 1] = j
            a[:, k, _IMM_OFF + 2] = t
            a[:, k, _IMM_OFF + 3] = rid[:, 0]
        for j in range(n):
            if j == w:
                continue
            k += 1
            a[:, k, 0] = _word0(Op.NET_SEND, 0, 1, 2)
            a[:, k, _IN_OFF] = base[:, 0] + (1 + j) * _PAGE
            a[:, k, _IN_OFF + 1] = big
            a[:, k, _IMM_OFF] = j
            a[:, k, _IMM_OFF + 1] = ROUND_TAG + rid[:, 0]
        for i in range(n):
            if i == w:
                continue
            k += 1
            a[:, k, 0] = _word0(Op.NET_RECV, 1, 0, 2)
            a[:, k, _OUT_OFF] = sshare(i)[:, 0]
            a[:, k, _OUT_OFF + 1] = big
            a[:, k, _IMM_OFF] = i
            a[:, k, _IMM_OFF + 1] = ROUND_TAG + rid[:, 0]
        k += 1
        a[:, k, 0] = _word0(Op.F_MULC, 1, 1, 2)
        a[:, k, _OUT_OFF] = base[:, 0] + 2 * n * _PAGE
        a[:, k, _OUT_OFF + 1] = big
        a[:, k, _IN_OFF] = sshare(0)[:, 0]
        a[:, k, _IN_OFF + 1] = big
        a[:, k, _IMM_OFF] = SH_VEC
        a[:, k, _IMM_OFF + 1] = self.lam[0]
        for q in range(1, n):
            k += 1
            a[:, k, 0] = _word0(Op.F_MULC_ADD, 1, 2, 2)
            a[:, k, _OUT_OFF] = base[:, 0] + (2 * n + q) * _PAGE
            a[:, k, _OUT_OFF + 1] = big
            a[:, k, _IN_OFF] = base[:, 0] + (2 * n + q - 1) * _PAGE
            a[:, k, _IN_OFF + 1] = big
            a[:, k, _IN_OFF + 2] = sshare(q)[:, 0]
            a[:, k, _IN_OFF + 3] = big
            a[:, k, _IMM_OFF] = SH_VEC
            a[:, k, _IMM_OFF + 1] = self.lam[q]
        assert k == rpr - 1
        self.out.append(a.reshape(rr * rpr, RECORD_WORDS))
        return base[:, 0] + (3 * n - 1) * _PAGE

    def reveal(self, addr: int, out_index: int, out_tag: int) -> None:
        n, w = self.n, self.w
        if w != 0:
            r = _rows(1)
            r[0, 0] = _word0(Op.NET_SEND, 0, 1, 2)
            r[0, _IN_OFF] = addr
            r[0, _IN_OFF + 1] = _PAGE
            r[0, _IMM_OFF] = 0
            r[0, _IMM_OFF + 1] = REVEAL_TAG + out_index
            self.out.append(r)
            return
        recv = self.pages(n - 1)
        r = _rows(n - 1)
        r[:, 0] = _word0(Op.NET_RECV, 1, 0, 2)
        r[:, _OUT_OFF] = recv
        r[:, _OUT_OFF + 1] = _PAGE
        r[:, _IMM_OFF] = 1 + np.arange(n - 1, dtype=np.int64)
        r[:, _IMM_OFF + 1] = REVEAL_TAG + out_index
        self.out.append(r)
        acc = self.mulc(addr, self.lam[0])
        for q in range(1, n):
            z = _rows(1)
            nxt = int(self.pages(1)[0])
            z[0, 0] = _word0(Op.F_MULC_ADD, 1, 2, 2)
            z[0, _OUT_OFF] = nxt
            z[0, _OUT_OFF + 1] = _PAGE
            z[0, _IN_OFF] = acc
            z[0, _IN_OFF + 1] = _PAGE
            z[0, _IN_OFF + 2] = recv[q - 1]
            z[0, _IN_OFF + 3] = _PAGE
            z[0, _IMM_OFF] = SH_VEC
            z[0, _IMM_OFF + 1] = self.lam[q]
            self.out.append(z)
            acc = nxt
        o = _rows(1)
        o[0, 0] = _word0(Op.OUTPUT, 0, 1, 2)
        o[0, _IN_OFF] = acc
        o[0, _IN_OFF + 1] = _PAGE
        o[0, _IMM_OFF] = SH_VEC
        o[0, _IMM_OFF + 1] = out_tag
        self.out.append(o)

    def records(self) -> np.ndarray:
        return np.vstack(self.out)


def build_shamir_stats_records(n: int, worker: int,
                               num_workers: int) -> np.ndarray:
    """The FREE-stripped ``shamir_stats`` trace of one worker/party."""
    b = _blocks(n)
    rec = _Rec(worker, num_workers)
    xs = rec.inputs(A_TAGS + np.arange(b, dtype=np.int64))
    s = rec.add_chain(xs)
    inv_b = inverse(b)
    m = rec.mulc(s, inv_b)
    sq = rec.mul_rounds(xs, xs)
    q = rec.add_chain(sq)
    msq = rec.mulc(q, inv_b)
    m2 = int(rec.mul_rounds(np.array([m]), np.array([m]))[0])
    var = rec.sub(msq, m2)
    rec.reveal(s, 0, OUT_TAGS + 0)
    rec.reveal(m, 1, OUT_TAGS + 1)
    rec.reveal(var, 2, OUT_TAGS + 2)
    return rec.records()


def build_shamir_cmp_records(n: int, worker: int,
                             num_workers: int) -> np.ndarray:
    """The FREE-stripped ``shamir_cmp`` trace of one worker/party."""
    b = _blocks(n, lo=2)
    rec = _Rec(worker, num_workers)
    tags = np.empty(2 * b, dtype=np.int64)
    tags[0::2] = A_TAGS + np.arange(b)
    tags[1::2] = B_TAGS + np.arange(b)
    xy = rec.inputs(tags)
    level = rec._bin(Op.F_SUB, xy[0::2], xy[1::2])
    while len(level) > 1:
        nxt = rec.mul_rounds(level[0:-1:2], level[1::2][:len(level) // 2])
        if len(level) % 2:
            nxt = np.concatenate([nxt, level[-1:]])
        level = nxt
    root = int(level[0])
    acc = root
    for bit in bin(P - 1)[3:]:
        acc = int(rec.mul_rounds(np.array([acc]), np.array([acc]))[0])
        if bit == "1":
            acc = int(rec.mul_rounds(np.array([acc]),
                                     np.array([root]))[0])
    rec.reveal(acc, 0, OUT_TAGS + 0)
    return rec.records()


def _write(path, name: str, n: int, worker: int, num_workers: int,
           rec: np.ndarray) -> ProgramFile:
    pages = int(rec[:, _OUT_OFF].max()) // _PAGE + 1
    w = ProgramWriter(path, page_shift=SH_PAGE_SHIFT, protocol="shamir",
                      worker=worker, num_workers=num_workers,
                      vspace_slots=pages << SH_PAGE_SHIFT,
                      meta={"workload": name, "n": n})
    w.append_records(rec)
    return w.close()


def write_shamir_stats_program(path, n: int, worker: int,
                               num_workers: int) -> ProgramFile:
    rec = build_shamir_stats_records(n, worker, num_workers)
    return _write(path, "shamir_stats", n, worker, num_workers, rec)


def write_shamir_cmp_program(path, n: int, worker: int,
                             num_workers: int) -> ProgramFile:
    rec = build_shamir_cmp_records(n, worker, num_workers)
    return _write(path, "shamir_cmp", n, worker, num_workers, rec)
