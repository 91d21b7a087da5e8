"""The ``aggsum`` workload: the secure-aggregation reduction as a MAGE
program, with a **vectorized trace builder** (the port's copy of
``repro.workloads.agg_workload``).

The DSL path traces one page-sized ``Integer`` vector per client and an
ADD chain over them: one Python ``Builder.emit`` per instruction.
Because the program is *oblivious and regular*, its record stream is a
closed form of ``n``: every value is exactly one page, and full-page
values get strictly sequential pages from the slab allocator.  So
:func:`build_aggsum_records` emits the whole FREE-stripped trace as a
handful of NumPy column assignments into a ``[2n, RECORD_WORDS]`` record
array, and :func:`write_aggsum_program` streams it straight into a
bytecode file via ``ProgramWriter.append_records``.  Its inputs are the
aggregation clients' round-0 vectors (``aggregate.offline``), so its
output is ``expected_sum`` of the first ``n`` clients.  Run two-party,
each ADD of 64-bit lanes is a ripple-carry chain of AND gates through the
half-gates kernels.
"""

from __future__ import annotations

import numpy as np

from ..aggregate.offline import DEFAULT_SEED, client_vector
from ..core.bytecode import (_IMM_OFF, _IN_OFF, _OUT_OFF, RECORD_WORDS, Op,
                             ProgramFile, ProgramWriter)
from ..core.workers import ProgramOptions
from ..protocols.garbled.dsl import Integer, Party
from .base import GC_PAGE_SHIFT, Workload, register
from .gc_workloads import A_TAGS, OUT_TAGS

#: one client's contribution: 64 lanes of 64-bit — exactly one GC page
#: (64 * 64 = 4096 slots), so every DSL value is a full-page allocation
AGG_W = 64
AGG_VEC = 64


def _aggsum_build(opts: ProgramOptions) -> None:
    n = opts.problem_size
    assert opts.num_workers == 1, "aggsum is a single-worker reduction"
    vecs = [Integer(AGG_W, AGG_VEC).mark_input(Party.Garbler, A_TAGS + i)
            for i in range(n)]
    accs = [vecs[0]]                  # keep refs: no mid-build FREEs
    for v in vecs[1:]:
        accs.append(accs[-1] + v)
    accs[-1].mark_output(OUT_TAGS)


def build_aggsum_records(n: int) -> np.ndarray:
    """The FREE-stripped ``aggsum`` trace as a ``[2n, RECORD_WORDS]``
    record array, built with vectorized column writes.

    Layout mirrors the DSL exactly: inputs live on pages ``0..n-1``,
    accumulator ``k`` on page ``n+k-1`` (full-page values take fresh
    sequential pages), and the record fields are what ``Integer``'s
    emit calls produce for INPUT / ADD / OUTPUT."""
    if n <= 0:
        raise ValueError(f"aggsum needs n >= 1 clients, got {n}")
    page = 1 << GC_PAGE_SHIFT
    rec = np.zeros((2 * n, RECORD_WORDS), dtype=np.int64)

    # INPUT i: outs=((i*page, page),), imm=(count, width, party, tag)
    i = np.arange(n, dtype=np.int64)
    rec[:n, 0] = int(Op.INPUT) | 1 << 16 | 4 << 24
    rec[:n, _OUT_OFF] = i * page
    rec[:n, _OUT_OFF + 1] = page
    rec[:n, _IMM_OFF] = AGG_VEC
    rec[:n, _IMM_OFF + 1] = AGG_W
    rec[:n, _IMM_OFF + 2] = int(Party.Garbler)
    rec[:n, _IMM_OFF + 3] = A_TAGS + i

    # ADD k: acc_k = acc_{k-1} + vec_k (acc_0 IS vec_0), k = 1..n-1
    if n > 1:
        k = np.arange(1, n, dtype=np.int64)
        add = rec[n:2 * n - 1]
        add[:, 0] = int(Op.ADD) | 1 << 16 | 2 << 20 | 2 << 24
        add[:, _OUT_OFF] = (n + k - 1) * page
        add[:, _OUT_OFF + 1] = page
        add[:, _IN_OFF] = np.where(k == 1, 0, (n + k - 2) * page)
        add[:, _IN_OFF + 1] = page
        add[:, _IN_OFF + 2] = k * page
        add[:, _IN_OFF + 3] = page
        add[:, _IMM_OFF] = AGG_VEC
        add[:, _IMM_OFF + 1] = AGG_W

    # OUTPUT: ins=(final acc,), imm=(count, width, tag)
    out = rec[2 * n - 1]
    out[0] = int(Op.OUTPUT) | 1 << 20 | 3 << 24
    out[_IN_OFF] = (2 * n - 2) * page if n > 1 else 0
    out[_IN_OFF + 1] = page
    out[_IMM_OFF] = AGG_VEC
    out[_IMM_OFF + 1] = AGG_W
    out[_IMM_OFF + 2] = OUT_TAGS
    return rec


def write_aggsum_program(path, n: int) -> ProgramFile:
    """Stream the vectorized trace straight to a bytecode file — the
    fast cold-trace path (no Instr objects, no allocator)."""
    pages = 2 * n - 1 if n > 1 else 1
    w = ProgramWriter(path, page_shift=GC_PAGE_SHIFT, protocol="gc",
                      vspace_slots=pages << GC_PAGE_SHIFT,
                      meta={"workload": "aggsum", "n": n})
    w.append_records(build_aggsum_records(n))
    return w.close()


def _aggsum_inputs(n: int, worker: int, p: int):
    def provider(tag: int) -> np.ndarray:
        return client_vector(DEFAULT_SEED, tag - A_TAGS, 0, AGG_VEC)
    return provider


def _aggsum_oracle(n: int) -> dict[int, np.ndarray]:
    total = np.zeros(AGG_VEC, dtype=np.uint64)
    for c in range(n):
        total += client_vector(DEFAULT_SEED, c, 0, AGG_VEC)
    return {OUT_TAGS: total}


register(Workload("aggsum", "gc", _aggsum_build, _aggsum_inputs,
                  _aggsum_oracle, page_shift=GC_PAGE_SHIFT, default_n=64))
