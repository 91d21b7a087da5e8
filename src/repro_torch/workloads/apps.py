"""§8.8 applications: password-reuse detection (GC) and computational PIR
(CKKS, the Kushilevitz–Ostrovsky sqrt scheme) — the port's copy of
``repro.workloads.apps``.  pir splits its columns between the workers;
passreuse runs on one worker per party (its merge asserts so, as the JAX
package's does).

As for the port's other CKKS workloads, pir draws its database, query and
oracle at the slot count of the parameters the job runs at
(``ckks_params``); at the default ring of 128 that is the JAX package's 64.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.bytecode import Op
from ..core.workers import ProgramOptions
from ..protocols.ckks.driver import Batch, Plain
from ..protocols.ckks.params import CkksParams
from ..protocols.garbled.dsl import Integer, Party
from .base import CKKS_PAGE_SHIFT, GC_PAGE_SHIFT, Workload, register
from .ckks_workloads import PARAMS, _params, _provider
from .gc_library import GC_CHUNK, RECORD_W, bitonic_merge_sorted_chunks
from .gc_workloads import CONST_TAG, public_input

A_TAGS = 0
B_TAGS = 1 << 20
Q_TAGS = 1 << 21
OUT_TAGS = 1 << 24
MATCH_KEY_W = 64          # uid (32b) + password hash (32b)


# ---------------------------------------------------------------------------
# Password-reuse detection (Senate Query 2): merge by (uid, hash), then flag
# adjacent duplicates.
# ---------------------------------------------------------------------------


def _passreuse_build(opts: ProgramOptions) -> None:
    n = opts.problem_size
    a = [Integer(RECORD_W, GC_CHUNK).mark_input(Party.Garbler, A_TAGS + i)
         for i in range(n // GC_CHUNK)]
    b = [Integer(RECORD_W, GC_CHUNK).mark_input(Party.Evaluator, B_TAGS + i)
         for i in range(n // GC_CHUNK)]
    merged = bitonic_merge_sorted_chunks(a, b, opts, key_w=MATCH_KEY_W)
    bld = merged[0].builder
    prev = None
    for i, cur in enumerate(merged):
        # each record beside its predecessor: the previous chunk's last
        # record, then this chunk's first 31 (sub-span copies)
        shifted = Integer(RECORD_W, GC_CHUNK)
        if prev is None:  # first element compares against itself -> no match
            bld.emit(Op.COPY,
                     outs=((shifted.addr, RECORD_W),),
                     ins=((cur.addr, RECORD_W),))
        else:
            bld.emit(Op.COPY,
                     outs=((shifted.addr, RECORD_W),),
                     ins=((prev.addr + (GC_CHUNK - 1) * RECORD_W, RECORD_W),))
        bld.emit(Op.COPY,
                 outs=((shifted.addr + RECORD_W, (GC_CHUNK - 1) * RECORD_W),),
                 ins=((cur.addr, (GC_CHUNK - 1) * RECORD_W),))
        eq = cur.cmp_eq(shifted, key_w=MATCH_KEY_W)
        if prev is None:
            # lane 0 of the first chunk compared against itself: mask it off
            mask = public_input(Integer(1, GC_CHUNK))
            eq = eq & mask
        eq.mark_output(OUT_TAGS + i)
        prev = cur


def _passreuse_data(n: int):
    rng = np.random.default_rng(8000 + n)
    uids = rng.integers(0, n * 4, 2 * n, dtype=np.uint64)
    hashes = rng.integers(0, 1 << 16, 2 * n, dtype=np.uint64)
    rec = (uids | (hashes << np.uint64(32)))
    a = np.sort(rec[:n])
    b = np.sort(rec[n:])
    # force some collisions
    b[: n // 4] = a[: n // 4]
    b = np.sort(b)
    return a, b


def _passreuse_inputs(n: int, worker: int, p: int):
    a, b = _passreuse_data(n)

    def provider(tag: int) -> np.ndarray:
        if tag == CONST_TAG:
            m = np.ones(GC_CHUNK, dtype=np.uint64)
            m[0] = 0
            return m
        if tag >= B_TAGS:
            i = tag - B_TAGS
            return b[i * GC_CHUNK:(i + 1) * GC_CHUNK]
        i = tag - A_TAGS
        return a[i * GC_CHUNK:(i + 1) * GC_CHUNK]
    return provider


def _passreuse_oracle(n: int) -> dict[int, np.ndarray]:
    a, b = _passreuse_data(n)
    merged = np.sort(np.concatenate([a, b]), kind="stable")
    eq = np.zeros(2 * n, dtype=np.uint64)
    eq[1:] = (merged[1:] == merged[:-1]).astype(np.uint64)
    return {OUT_TAGS + i: eq[i * GC_CHUNK:(i + 1) * GC_CHUNK]
            for i in range(2 * n // GC_CHUNK)}


register(Workload("passreuse", "gc", _passreuse_build, _passreuse_inputs,
                  _passreuse_oracle, page_shift=GC_PAGE_SHIFT, default_n=256))


# ---------------------------------------------------------------------------
# Computational PIR (KO97 sqrt scheme over CKKS)
# ---------------------------------------------------------------------------


def _pir_grid(n: int) -> tuple[int, int]:
    r = 1 << max(0, math.isqrt(n - 1).bit_length())
    while r * r < n:
        r *= 2
    return r, (n + r - 1) // r


def _pir_build(opts: ProgramOptions) -> None:
    """Each worker scans its share of the columns when the workers divide
    them, and every column otherwise (as the JAX package does)."""
    p = _params(opts)
    r, c = _pir_grid(opts.problem_size)
    k0, cols = 0, c
    if opts.num_workers > 1 and c % opts.num_workers == 0:
        cols = c // opts.num_workers
        k0 = opts.worker * cols
    # phase 1: materialize the (plaintext-encoded) database + query
    db = {(i, k): Plain(p).mark_input(A_TAGS + i * c + k)
          for i in range(r) for k in range(k0, k0 + cols)}
    q = [Batch(p).mark_input(Q_TAGS + i) for i in range(r)]
    # phase 2: linear scan — one column accumulator per output
    for k in range(k0, k0 + cols):
        acc = q[0].mul_plain(db[(0, k)])
        for i in range(1, r):
            acc = acc + q[i].mul_plain(db[(i, k)])
        acc.mark_output(OUT_TAGS + k)


def _pir_data(n: int, slots: int):
    rng = np.random.default_rng(8200 + n)
    r, c = _pir_grid(n)
    db = rng.uniform(-1, 1, (r * c, slots))
    target = int(rng.integers(0, r))
    q = np.zeros((r, slots))
    q[target] = 1.0
    return db, q, target


def _pir_inputs(n: int, worker: int, p: int,
                ckks_params: CkksParams = PARAMS):
    db, q, _ = _pir_data(n, ckks_params.slots)
    return _provider({A_TAGS: db, Q_TAGS: q})


def _pir_oracle(n: int, ckks_params: CkksParams = PARAMS
                ) -> dict[int, np.ndarray]:
    db, _, target = _pir_data(n, ckks_params.slots)
    c = _pir_grid(n)[1]
    return {OUT_TAGS + k: db[target * c + k] for k in range(c)}


register(Workload("pir", "ckks", _pir_build, _pir_inputs, _pir_oracle,
                  page_shift=CKKS_PAGE_SHIFT, default_n=64))
