"""Chunked oblivious sorting/merging library over the Integer DSL: the
port's copy of ``repro.workloads.gc_library``.

The §5.1 'easier-to-use DSL libraries' layer: bitonic networks expressed at
chunk granularity, optionally distributed across workers.  Remote pairs are
exchanged with network directives and compare-split locally (the classic
parallel bitonic construction) — this is what gives merge/sort their
mid-computation communication phases (Fig. 10).

Key structural fact used throughout: with mc chunks per worker, a bitonic
stage at chunk distance jc pairs chunk g with g^jc; when jc >= mc the
partner lives on worker w ^ (jc // mc) at the SAME local index, and the
low/high role is uniform across the stage — so sends and receives match in
FIFO order on both sides.
"""

from __future__ import annotations

from ..core.workers import ProgramOptions, recv_into, send_value
from ..protocols.garbled.dsl import Integer

RECORD_W = 128      # 32-bit key + payload (§8.1.1)
KEY_W = 32
GC_CHUNK = 32       # records per chunk: 32 * 128 wires = 4096 = one page


def input_chunks(n: int, party, tag_base: int, chunk: int = GC_CHUNK,
                 width: int = RECORD_W) -> list[Integer]:
    """Phase 1: materialize n records as n/chunk page-sized values."""
    assert n % chunk == 0
    return [Integer(width, chunk).mark_input(party, tag_base + i)
            for i in range(n // chunk)]


def output_chunks(chunks: list[Integer], tag_base: int) -> None:
    for i, c in enumerate(chunks):
        c.mark_output(tag_base + i)


def _cx(chunks, a: int, b: int, up: bool, key_w: int) -> None:
    mn, mx = chunks[a].minmax(chunks[b], key_w)
    chunks[a], chunks[b] = (mn, mx) if up else (mx, mn)


def _cx_remote(chunks, idx: int, keep_low: bool, partner: int,
               key_w: int) -> None:
    mine = chunks[idx]
    theirs = Integer(mine.width, mine.count)
    tag = send_value(mine, partner)
    recv_into(theirs, partner, tag)
    mn, mx = mine.minmax(theirs, key_w)
    chunks[idx] = mn if keep_low else mx


def _merge_stage(chunks: list[Integer], opts: ProgramOptions, k: int,
                 key_w: int, n_total: int) -> None:
    """One bitonic merge pass (block size k) over the global chunk sequence;
    ends with local merge_only finishes.  k and chunk counts: powers of 2."""
    mc = len(chunks)
    C = chunks[0].count
    w = opts.worker
    j = k // 2
    while j >= C:
        jc = j // C
        if jc >= mc:  # remote stage: uniform partner, same local index
            pw = w ^ (jc // mc)
            g0 = w * mc
            up = ((g0 * C) & k) == 0
            keep_low = up if pw > w else not up
            if pw > w:
                for c in range(mc):
                    _cx_remote(chunks, c, keep_low=keep_low, partner=pw,
                               key_w=key_w)
            else:
                up_partner = (((pw * mc) * C) & k) == 0
                for c in range(mc):
                    _cx_remote(chunks, c, keep_low=not up_partner,
                               partner=pw, key_w=key_w)
        else:
            for c in range(mc):
                partner = c ^ jc
                if partner > c:
                    g = w * mc + c
                    up = ((g * C) & k) == 0
                    _cx(chunks, c, partner, up, key_w)
        j //= 2
    for c in range(mc):
        g = w * mc + c
        up = ((g * C) & k) == 0
        chunks[c] = chunks[c].sort_local(key_w, descending=not up,
                                         merge_only=True)


def bitonic_sort_chunks(chunks: list[Integer], opts: ProgramOptions,
                        key_w: int = KEY_W) -> list[Integer]:
    """Ascending sort of the global sequence across all workers."""
    mc = len(chunks)
    C = chunks[0].count
    w, p = opts.worker, opts.num_workers
    n_total = mc * p * C
    assert (mc * p) & (mc * p - 1) == 0 and C & (C - 1) == 0

    # local sorts ≡ stages k=2..C of the element-level network: after stage
    # k=C each C-block is sorted ascending iff bit C of its base index is 0
    for c in range(mc):
        g = w * mc + c
        up = ((g * C) & C) == 0
        chunks[c] = chunks[c].sort_local(key_w, descending=not up)

    k = 2 * C
    while k <= n_total:
        _merge_stage(chunks, opts, k, key_w, n_total)
        k *= 2
    return chunks


def bitonic_merge_sorted_chunks(a: list[Integer], b: list[Integer],
                                opts: ProgramOptions,
                                key_w: int = KEY_W) -> list[Integer]:
    """Single-worker merge of two ascending-sorted chunk lists: reverse b
    (free wire shuffle), concatenate (bitonic), one merge pass."""
    assert opts.num_workers == 1
    C = a[0].count
    chunks = list(a) + [c.reverse() for c in reversed(b)]
    _merge_stage(chunks, opts, len(chunks) * C, key_w, len(chunks) * C)
    return chunks


def distributed_merge_chunks(chunks: list[Integer], opts: ProgramOptions,
                             key_w: int = KEY_W) -> list[Integer]:
    """Distributed merge: each worker already holds its block of the GLOBAL
    bitonic sequence [A asc, B desc] (input layout handled by the caller);
    one merge pass over all workers."""
    n_total = len(chunks) * opts.num_workers * chunks[0].count
    _merge_stage(chunks, opts, n_total, key_w, n_total)
    return chunks
