"""The five garbled-circuit workloads (§8.1.1): merge, sort, ljoin, mvmul,
binfclayer — the port's copy of ``repro.workloads.gc_workloads``,
written in the Integer DSL against the chunk library.  With p workers
per party, merge and sort run the distributed bitonic network (NET_*
exchanges between workers), and ljoin, mvmul and binfclayer split their
rows between the workers.

Problem sizes follow the paper's conventions: n records per party for
merge/sort/ljoin (128-bit records, 32-bit keys), n = matrix side for
mvmul/binfclayer.  Inputs are deterministic per (workload, n, tag).
"""

from __future__ import annotations

import numpy as np

from ..core.bytecode import Op
from ..core.workers import ProgramOptions
from ..protocols.garbled.dsl import Integer, Party
from .base import GC_PAGE_SHIFT, Workload, register
from .gc_library import (GC_CHUNK, KEY_W, RECORD_W,
                         bitonic_merge_sorted_chunks, bitonic_sort_chunks,
                         distributed_merge_chunks, input_chunks,
                         output_chunks)

A_TAGS = 0
B_TAGS = 1 << 20
OUT_TAGS = 1 << 24


def _key_sort(rec: np.ndarray) -> np.ndarray:
    """Sort records by their 32-bit key (low bits), stably."""
    return rec[np.argsort(rec & np.uint64((1 << 32) - 1), kind="stable")]


def _records(n: int, seed: int, sort: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 31, n, dtype=np.uint64)
    payload = rng.integers(0, 1 << 31, n, dtype=np.uint64)
    rec = keys | (payload << np.uint64(32))
    return _key_sort(rec) if sort else rec


def _chunk_provider(data_by_base: dict[int, np.ndarray], chunk: int):
    def provider(tag: int) -> np.ndarray:
        for base, data in data_by_base.items():
            if base <= tag < base + (1 << 20):
                i = tag - base
                return data[i * chunk:(i + 1) * chunk]
        raise KeyError(tag)
    return provider


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def _merge_build(opts: ProgramOptions) -> None:
    n = opts.problem_size
    p = opts.num_workers
    if p == 1:
        a = input_chunks(n, Party.Garbler, A_TAGS)
        b = input_chunks(n, Party.Evaluator, B_TAGS)
        out = bitonic_merge_sorted_chunks(a, b, opts)
        output_chunks(out, OUT_TAGS)
        return
    # distributed: worker w holds its block of [A asc | B desc]
    assert p % 2 == 0 and (2 * n) % (p * GC_CHUNK) == 0
    mc = (2 * n) // (p * GC_CHUNK)
    w = opts.worker
    chunks = []
    for c in range(mc):
        g = w * mc + c  # global chunk index in the combined sequence
        if g < n // GC_CHUNK:
            chunks.append(Integer(RECORD_W, GC_CHUNK)
                          .mark_input(Party.Garbler, A_TAGS + g))
        else:
            bidx = (2 * n // GC_CHUNK - 1) - g   # reversed chunk order
            v = Integer(RECORD_W, GC_CHUNK).mark_input(Party.Evaluator,
                                                       B_TAGS + bidx)
            chunks.append(v.reverse())
    out = distributed_merge_chunks(chunks, opts)
    output_chunks(out, OUT_TAGS + w * mc)


def _merge_inputs(n: int, worker: int, p: int):
    a = _records(n, seed=1000 + n, sort=True)
    b = _records(n, seed=2000 + n, sort=True)
    return _chunk_provider({A_TAGS: a, B_TAGS: b}, GC_CHUNK)


def _merge_oracle(n: int) -> dict[int, np.ndarray]:
    a = _records(n, seed=1000 + n, sort=True)
    b = _records(n, seed=2000 + n, sort=True)
    merged = _key_sort(np.concatenate([a, b]))
    return {OUT_TAGS + i: merged[i * GC_CHUNK:(i + 1) * GC_CHUNK]
            for i in range(2 * n // GC_CHUNK)}


register(Workload("merge", "gc", _merge_build, _merge_inputs, _merge_oracle,
                  page_shift=GC_PAGE_SHIFT, default_n=512))


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def _sort_build(opts: ProgramOptions) -> None:
    n = opts.problem_size
    p = opts.num_workers
    per = n // p
    base = opts.worker * (per // GC_CHUNK)
    chunks = [Integer(RECORD_W, GC_CHUNK).mark_input(Party.Garbler,
                                                     A_TAGS + base + i)
              for i in range(per // GC_CHUNK)]
    out = bitonic_sort_chunks(chunks, opts)
    output_chunks(out, OUT_TAGS + base)


def _sort_inputs(n: int, worker: int, p: int):
    data = _records(n, seed=3000 + n, sort=False)
    return _chunk_provider({A_TAGS: data}, GC_CHUNK)


def _sort_oracle(n: int) -> dict[int, np.ndarray]:
    data = _key_sort(_records(n, seed=3000 + n, sort=False))
    return {OUT_TAGS + i: data[i * GC_CHUNK:(i + 1) * GC_CHUNK]
            for i in range(n // GC_CHUNK)}


register(Workload("sort", "gc", _sort_build, _sort_inputs, _sort_oracle,
                  page_shift=GC_PAGE_SHIFT, default_n=512))


# ---------------------------------------------------------------------------
# ljoin (loop join: both inputs fit; the output, written in order, does not)
# ---------------------------------------------------------------------------

LJ_A_CELL = 8
LJ_B_CELL = 4


def _ljoin_build(opts: ProgramOptions) -> None:
    n = opts.problem_size
    p = opts.num_workers
    per = n // p                      # A rows per worker; B replicated
    a = input_chunks(per, Party.Garbler,
                     A_TAGS + opts.worker * (per // LJ_A_CELL),
                     chunk=LJ_A_CELL)
    b = input_chunks(n, Party.Evaluator, B_TAGS, chunk=LJ_B_CELL)
    base = OUT_TAGS + opts.worker * (per // LJ_A_CELL) * (n // LJ_B_CELL)
    # §8.1.3 three-phase discipline: the join output is MATERIALIZED in
    # memory (it is what exceeds the budget), then written out in phase 3.
    # (Loops, not a comprehension: ``ca`` and ``cb`` stay bound to the last
    # cells until the build returns, so the values are freed in the JAX
    # package's order and the traces are equal.)
    cells = []
    for ca in a:
        for cb in b:
            cells.append(ca.pair_join(cb, KEY_W))
    for t, cell in enumerate(cells):
        cell.mark_output(base + t)


def _ljoin_data(n: int) -> tuple[np.ndarray, np.ndarray]:
    a = _records(n, seed=4000 + n, sort=False)
    b = a.copy()
    np.random.default_rng(4100 + n).shuffle(b)   # same keys, other order
    return a, b


def _ljoin_inputs(n: int, worker: int, p: int):
    a, b = _ljoin_data(n)
    prov_a = _chunk_provider({A_TAGS: a}, LJ_A_CELL)
    prov_b = _chunk_provider({B_TAGS: b}, LJ_B_CELL)
    return lambda tag: prov_b(tag) if tag >= B_TAGS else prov_a(tag)


def _ljoin_oracle(n: int) -> dict[int, np.ndarray]:
    a, b = _ljoin_data(n)
    m = np.uint64((1 << 32) - 1)
    kw, w = KEY_W, RECORD_W
    half = (w - kw) // 2
    hm = np.uint64((1 << half) - 1)
    out: dict[int, np.ndarray] = {}
    t = 0
    for ia in range(n // LJ_A_CELL):
        ca = a[ia * LJ_A_CELL:(ia + 1) * LJ_A_CELL]
        for ib in range(n // LJ_B_CELL):
            cb = b[ib * LJ_B_CELL:(ib + 1) * LJ_B_CELL]
            aa = np.repeat(ca, LJ_B_CELL)
            bb = np.tile(cb, LJ_A_CELL)
            pa = (aa >> np.uint64(kw)) & hm
            pb = (bb >> np.uint64(kw)) & hm
            # a shift by kw + half = 80 >= 64 gives 0 in NumPy's uint64
            packed = (aa & m) | (pa << np.uint64(kw)) \
                | (pb << np.uint64(kw + half))
            out[OUT_TAGS + t] = np.where((aa & m) == (bb & m), packed,
                                         np.uint64(0))
            t += 1
    return out


register(Workload("ljoin", "gc", _ljoin_build, _ljoin_inputs, _ljoin_oracle,
                  page_shift=GC_PAGE_SHIFT, default_n=64))


# ---------------------------------------------------------------------------
# mvmul (8-bit integer matrix-vector)
# ---------------------------------------------------------------------------

MV_NR = 8     # rows per MAC cell
MV_NJ = 16    # cols per MAC cell
#: the tag of a public constant input (the zero accumulator, a lane mask)
CONST_TAG = 1 << 28


def public_input(value: Integer) -> Integer:
    """Emit ``value`` as the garbler's input under ``CONST_TAG``: a public
    constant, as the JAX package's workloads make theirs."""
    value.builder.emit(Op.INPUT, outs=(value.span,),
                       imm=(value.count, value.width, int(Party.Garbler),
                            CONST_TAG))
    return value


def _mvmul_build(opts: ProgramOptions) -> None:
    n = opts.problem_size
    rows = n // opts.num_workers
    row_base = opts.worker * (rows // MV_NR)
    vec = [Integer(8, MV_NJ).mark_input(Party.Evaluator, B_TAGS + j)
           for j in range(n // MV_NJ)]
    mat = [[Integer(8, MV_NR * MV_NJ).mark_input(
        Party.Garbler, A_TAGS + (row_base + r) * (n // MV_NJ) + j)
        for j in range(n // MV_NJ)] for r in range(rows // MV_NR)]
    zero = public_input(Integer(32, MV_NR))
    outs = []
    for r in range(rows // MV_NR):
        acc = zero
        for j in range(n // MV_NJ):
            acc = mat[r][j].mac8(vec[j], acc)
        outs.append(acc)
    for r, acc in enumerate(outs):  # phase 3
        acc.mark_output(OUT_TAGS + row_base + r)


def _mvmul_data(n: int):
    rng = np.random.default_rng(5000 + n)
    M = rng.integers(0, 256, (n, n), dtype=np.uint64)
    v = rng.integers(0, 256, n, dtype=np.uint64)
    return M, v


def _mvmul_inputs(n: int, worker: int, p: int):
    M, v = _mvmul_data(n)

    def provider(tag: int) -> np.ndarray:
        if tag == CONST_TAG:
            return np.zeros(MV_NR, dtype=np.uint64)
        if tag >= B_TAGS:
            j = tag - B_TAGS
            return v[j * MV_NJ:(j + 1) * MV_NJ]
        r, j = divmod(tag - A_TAGS, n // MV_NJ)
        return M[r * MV_NR:(r + 1) * MV_NR, j * MV_NJ:(j + 1) * MV_NJ] \
            .reshape(-1)
    return provider


def _mvmul_oracle(n: int) -> dict[int, np.ndarray]:
    M, v = _mvmul_data(n)
    res = (M * v[None, :]).sum(axis=1) & np.uint64(0xFFFFFFFF)
    return {OUT_TAGS + r: res[r * MV_NR:(r + 1) * MV_NR]
            for r in range(n // MV_NR)}


register(Workload("mvmul", "gc", _mvmul_build, _mvmul_inputs, _mvmul_oracle,
                  page_shift=GC_PAGE_SHIFT, default_n=64))


# ---------------------------------------------------------------------------
# binfclayer (XONN-style binary fully-connected layer)
# ---------------------------------------------------------------------------

BF_NR = 32
BF_NJ = 128


def _binfc_build(opts: ProgramOptions) -> None:
    """out[r] = sign(popcount_j xnor(M[r, :], v)) for n == BF_NJ; wider
    layers combine the per-block signs by XOR (block voting), as the JAX
    package does.  Each worker takes ``n / p`` rows."""
    n = opts.problem_size
    rows = n // opts.num_workers
    row_base = opts.worker * (rows // BF_NR)
    assert n % BF_NJ == 0
    vec = [Integer(1, BF_NJ).mark_input(Party.Evaluator, B_TAGS + j)
           for j in range(n // BF_NJ)]
    # phase 1: the whole binary matrix is materialized (§8.1.3)
    mat = {(r, j): Integer(1, BF_NR * BF_NJ).mark_input(
        Party.Garbler, A_TAGS + (row_base + r) * (n // BF_NJ) + j)
        for r in range(rows // BF_NR) for j in range(n // BF_NJ)}
    results = []
    for r in range(rows // BF_NR):
        outs = [mat[(r, j)].xnor_pop_sign(vec[j], BF_NR)
                for j in range(n // BF_NJ)]
        acc = outs[0]
        for o in outs[1:]:
            acc = acc ^ o
        results.append(acc)
    for r, out in enumerate(results):  # phase 3
        out.mark_output(OUT_TAGS + row_base + r)


def _binfc_data(n: int):
    rng = np.random.default_rng(6000 + n)
    M = rng.integers(0, 2, (n, n), dtype=np.uint64)
    v = rng.integers(0, 2, n, dtype=np.uint64)
    return M, v


def _binfc_inputs(n: int, worker: int, p: int):
    M, v = _binfc_data(n)

    def provider(tag: int) -> np.ndarray:
        if tag >= B_TAGS:
            j = tag - B_TAGS
            return v[j * BF_NJ:(j + 1) * BF_NJ]
        r, j = divmod(tag - A_TAGS, n // BF_NJ)
        return M[r * BF_NR:(r + 1) * BF_NR, j * BF_NJ:(j + 1) * BF_NJ] \
            .reshape(-1)
    return provider


def _binfc_oracle(n: int) -> dict[int, np.ndarray]:
    M, v = _binfc_data(n)
    out: dict[int, np.ndarray] = {}
    for r in range(n // BF_NR):
        rows = M[r * BF_NR:(r + 1) * BF_NR]
        acc = np.zeros(BF_NR, dtype=np.uint64)
        for j in range(n // BF_NJ):
            blk = rows[:, j * BF_NJ:(j + 1) * BF_NJ]
            vv = v[j * BF_NJ:(j + 1) * BF_NJ]
            cnt = (1 - (blk ^ vv[None, :])).sum(axis=1)
            acc ^= (cnt >= (BF_NJ + 1) // 2).astype(np.uint64)
        out[OUT_TAGS + r] = acc
    return out


register(Workload("binfclayer", "gc", _binfc_build, _binfc_inputs,
                  _binfc_oracle, page_shift=GC_PAGE_SHIFT, default_n=128))
