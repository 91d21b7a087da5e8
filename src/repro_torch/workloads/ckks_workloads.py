"""The five CKKS workloads (§8.1.2): rsum, rstats, rmvmul, n_rmatmul,
t_rmatmul — the port's copy of ``repro.workloads.ckks_workloads``.

Each DSL value is one ciphertext — a vector of N/2 reals computed SIMD-style
over independent problem instances (§8.1.3).  Problem size n = number of
elements (rsum/rstats) or matrix side (rmvmul, *_rmatmul).  Lazy
relinearization (mul_norelin + adds + one relin) is used wherever products
are summed — the §7.4 optimization the paper calls crucial for rstats and
the linear-algebra workloads.

One difference from the reference: inputs and the oracle are drawn at the
slot count of the params the job runs at (``ckks_params``), where the
reference always draws ``PARAMS.slots`` = 64 values and so can only run at
its default ring of 128.  At ring 128 both draw the same values.
With p workers, each takes its share of the elements (rsum, rstats) or of
the rows (rmvmul, *_rmatmul); rsum's and rstats' partial sums are
gathered on worker 0 over NET_* directives (``_gather_add``).
"""

from __future__ import annotations

import numpy as np

from ..core.workers import ProgramOptions, recv_into, send_value
from ..protocols.ckks.driver import Batch, Plain
from ..protocols.ckks.params import CkksParams
from .base import CKKS_PAGE_SHIFT, Workload, register

X_TAGS = 0
Y_TAGS = 1 << 20
C_TAGS = 1 << 22          # plaintext constants
OUT_TAGS = 1 << 24

PARAMS = CkksParams(n_ring=128, levels=2)   # tests; benches override n_ring


def _params(opts: ProgramOptions) -> CkksParams:
    return opts.extra.get("ckks_params", PARAMS)


def _vals(n: int, seed: int, slots: int) -> np.ndarray:
    """n independent slot-vectors in [-1, 1)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, slots))


def _provider(data_by_base: dict[int, np.ndarray]):
    def provider(tag: int) -> np.ndarray:
        for base, data in data_by_base.items():
            if base <= tag < base + (1 << 20):
                return data[tag - base]
        raise KeyError(tag)
    return provider


# ---------------------------------------------------------------------------
# rsum: sum of n encrypted vectors (no multiplications)
# ---------------------------------------------------------------------------


def _gather_add(acc: Batch, opts: ProgramOptions, p: CkksParams,
                tag0: int) -> Batch | None:
    """Combine per-worker partials on worker 0 (network directives)."""
    if opts.num_workers == 1:
        return acc
    if opts.worker != 0:
        send_value(acc, 0, tag=tag0 + opts.worker)
        return None
    for src in range(1, opts.num_workers):
        other = Batch(p, acc.level, acc.ncomp, acc.scale)
        recv_into(other, src, tag0 + src)
        acc = acc + other
    return acc


def _rsum_build(opts: ProgramOptions) -> None:
    p = _params(opts)
    n = opts.problem_size
    per = n // opts.num_workers
    base = opts.worker * per
    cts = [Batch(p).mark_input(X_TAGS + base + i) for i in range(per)]
    acc = cts[0] + cts[1]
    for c in cts[2:]:
        acc = acc + c
    acc = _gather_add(acc, opts, p, 1 << 16)
    if acc is not None:
        acc.mark_output(OUT_TAGS)


def _rsum_inputs(n: int, worker: int, p: int,
                 ckks_params: CkksParams = PARAMS):
    return _provider({X_TAGS: _vals(n, 7000 + n, ckks_params.slots)})


def _rsum_oracle(n: int, ckks_params: CkksParams = PARAMS
                 ) -> dict[int, np.ndarray]:
    return {OUT_TAGS: _vals(n, 7000 + n, ckks_params.slots).sum(axis=0)}


register(Workload("rsum", "ckks", _rsum_build, _rsum_inputs, _rsum_oracle,
                  page_shift=CKKS_PAGE_SHIFT, default_n=64))


# ---------------------------------------------------------------------------
# rstats: mean and variance (depth 2, lazy relin)
# ---------------------------------------------------------------------------


def _rstats_build(opts: ProgramOptions) -> None:
    p = _params(opts)
    n = opts.problem_size
    per = n // opts.num_workers
    base = opts.worker * per
    inv_n = Plain(p).mark_input(C_TAGS)          # encodes 1/n
    cts = [Batch(p).mark_input(X_TAGS + base + i) for i in range(per)]
    s = cts[0] + cts[1]
    for c in cts[2:]:
        s = s + c
    sq = cts[0].mul_norelin(cts[0])
    for c in cts[1:]:
        sq = sq + c.mul_norelin(c)
    s = _gather_add(s, opts, p, 1 << 16)
    sq = _gather_add(sq, opts, p, 1 << 17)
    if s is None:
        return
    sumsq = sq.relin()                            # level 1
    mean = s.mul_plain(inv_n)                     # level 1
    ex2 = sumsq.mul_plain(inv_n)                  # level 0
    mean2 = mean * mean                           # level 0
    var = ex2 - mean2
    mean.mark_output(OUT_TAGS)
    var.mark_output(OUT_TAGS + 1)


def _rstats_inputs(n: int, worker: int, p: int,
                   ckks_params: CkksParams = PARAMS):
    xs = _vals(n, 7100 + n, ckks_params.slots)
    const = np.full(ckks_params.slots, 1.0 / n)
    return _provider({X_TAGS: xs, C_TAGS: const[None, :]})


def _rstats_oracle(n: int, ckks_params: CkksParams = PARAMS
                   ) -> dict[int, np.ndarray]:
    xs = _vals(n, 7100 + n, ckks_params.slots)
    return {OUT_TAGS: xs.mean(axis=0),
            OUT_TAGS + 1: xs.var(axis=0)}


register(Workload("rstats", "ckks", _rstats_build, _rstats_inputs,
                  _rstats_oracle, page_shift=CKKS_PAGE_SHIFT, default_n=64))


# ---------------------------------------------------------------------------
# rmvmul: encrypted matrix-vector multiply (lazy relin per row)
# ---------------------------------------------------------------------------


def _rmv_tag(i: int, j: int, n: int) -> int:
    return X_TAGS + i * n + j


def _rmvmul_build(opts: ProgramOptions) -> None:
    p = _params(opts)
    n = opts.problem_size
    rows = n // opts.num_workers
    r0 = opts.worker * rows
    vec = [Batch(p).mark_input(Y_TAGS + j) for j in range(n)]
    for i in range(r0, r0 + rows):
        row = [Batch(p).mark_input(_rmv_tag(i, j, n)) for j in range(n)]
        acc = row[0].mul_norelin(vec[0])
        for j in range(1, n):
            acc = acc + row[j].mul_norelin(vec[j])
        acc.relin().mark_output(OUT_TAGS + i)


def _rmvmul_data(n: int, slots: int):
    return (_vals(n * n, 7200 + n, slots), _vals(n, 7300 + n, slots))


def _rmvmul_inputs(n: int, worker: int, p: int,
                   ckks_params: CkksParams = PARAMS):
    M, v = _rmvmul_data(n, ckks_params.slots)
    return _provider({X_TAGS: M, Y_TAGS: v})


def _rmvmul_oracle(n: int, ckks_params: CkksParams = PARAMS
                   ) -> dict[int, np.ndarray]:
    M, v = _rmvmul_data(n, ckks_params.slots)
    out = {}
    for i in range(n):
        acc = np.zeros(ckks_params.slots)
        for j in range(n):
            acc += M[i * n + j] * v[j]
        out[OUT_TAGS + i] = acc
    return out


register(Workload("rmvmul", "ckks", _rmvmul_build, _rmvmul_inputs,
                  _rmvmul_oracle, page_shift=CKKS_PAGE_SHIFT, default_n=8))


# ---------------------------------------------------------------------------
# n_rmatmul / t_rmatmul: naive vs tiled matrix-matrix multiply
# ---------------------------------------------------------------------------


def _matmul_data(n: int, slots: int):
    return (_vals(n * n, 7400 + n, slots), _vals(n * n, 7500 + n, slots))


def _matmul_inputs(n: int, worker: int, p: int,
                   ckks_params: CkksParams = PARAMS):
    A, B = _matmul_data(n, ckks_params.slots)
    return _provider({X_TAGS: A, Y_TAGS: B})


def _matmul_oracle(n: int, ckks_params: CkksParams = PARAMS
                   ) -> dict[int, np.ndarray]:
    A, B = _matmul_data(n, ckks_params.slots)
    out = {}
    for i in range(n):
        for k in range(n):
            acc = np.zeros(ckks_params.slots)
            for j in range(n):
                acc += A[i * n + j] * B[j * n + k]
            out[OUT_TAGS + i * n + k] = acc
    return out


def _n_rmatmul_build(opts: ProgramOptions) -> None:
    """Naive i-j-k loop: the whole A row band, B, and C accumulators are
    repeatedly rescanned — the memory-hostile ordering."""
    p = _params(opts)
    n = opts.problem_size
    rows = n // opts.num_workers
    r0 = opts.worker * rows
    A = {(i, j): Batch(p).mark_input(X_TAGS + i * n + j)
         for i in range(r0, r0 + rows) for j in range(n)}
    B = {(j, k): Batch(p).mark_input(Y_TAGS + j * n + k)
         for j in range(n) for k in range(n)}
    C: dict[tuple[int, int], Batch] = {}
    for i in range(r0, r0 + rows):
        for j in range(n):
            for k in range(n):
                t = A[(i, j)].mul_norelin(B[(j, k)])
                C[(i, k)] = t if j == 0 else C[(i, k)] + t
    for i in range(r0, r0 + rows):
        for k in range(n):
            C[(i, k)].relin().mark_output(OUT_TAGS + i * n + k)


def _t_rmatmul_build(opts: ProgramOptions) -> None:
    """Tiled i-k-j loop with T x T tiles: each B tile is reused across a
    whole A row-tile before moving on (the memory-friendly ordering)."""
    p = _params(opts)
    n = opts.problem_size
    T = min(4, n)
    rows = n // opts.num_workers
    r0 = opts.worker * rows
    A = {(i, j): Batch(p).mark_input(X_TAGS + i * n + j)
         for i in range(r0, r0 + rows) for j in range(n)}
    B = {(j, k): Batch(p).mark_input(Y_TAGS + j * n + k)
         for j in range(n) for k in range(n)}
    C: dict[tuple[int, int], Batch] = {}
    for i0 in range(r0, r0 + rows, T):
        for k0 in range(0, n, T):
            for j0 in range(0, n, T):
                for i in range(i0, min(i0 + T, r0 + rows)):
                    for k in range(k0, min(k0 + T, n)):
                        for j in range(j0, min(j0 + T, n)):
                            t = A[(i, j)].mul_norelin(B[(j, k)])
                            C[(i, k)] = t if j == 0 else C[(i, k)] + t
            for i in range(i0, min(i0 + T, r0 + rows)):
                for k in range(k0, min(k0 + T, n)):
                    C.pop((i, k)).relin().mark_output(OUT_TAGS + i * n + k)


register(Workload("n_rmatmul", "ckks", _n_rmatmul_build, _matmul_inputs,
                  _matmul_oracle, page_shift=CKKS_PAGE_SHIFT, default_n=4))
register(Workload("t_rmatmul", "ckks", _t_rmatmul_build, _matmul_inputs,
                  _matmul_oracle, page_shift=CKKS_PAGE_SHIFT, default_n=4))
