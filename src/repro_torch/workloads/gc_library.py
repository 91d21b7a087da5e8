"""Chunked oblivious merging over the Integer DSL: the port's copy of the
single-worker part of ``repro.workloads.gc_library`` (the §5.1 library
layer).  Bitonic networks are expressed at chunk granularity: a stage at
chunk distance jc compare-exchanges chunk g with g ^ jc, and each stage
ends with a local merge network inside every chunk.
"""

from __future__ import annotations

from ..core.workers import ProgramOptions
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


def _merge_stage(chunks: list[Integer], k: int, key_w: int) -> None:
    """One bitonic merge pass (block size k) over the chunk sequence; ends
    with local merge_only finishes.  k and chunk counts: powers of 2."""
    mc = len(chunks)
    C = chunks[0].count
    j = k // 2
    while j >= C:
        jc = j // C
        for c in range(mc):
            partner = c ^ jc
            if partner > c:
                up = ((c * C) & k) == 0
                _cx(chunks, c, partner, up, key_w)
        j //= 2
    for c in range(mc):
        up = ((c * C) & k) == 0
        chunks[c] = chunks[c].sort_local(key_w, descending=not up,
                                         merge_only=True)


def bitonic_merge_sorted_chunks(a: list[Integer], b: list[Integer],
                                opts: ProgramOptions,
                                key_w: int = KEY_W) -> list[Integer]:
    """Single-worker merge of two ascending-sorted chunk lists: reverse b
    (free wire shuffle), concatenate (bitonic), one merge pass."""
    assert opts.num_workers == 1
    C = a[0].count
    chunks = list(a) + [c.reverse() for c in reversed(b)]
    _merge_stage(chunks, len(chunks) * C, key_w)
    return chunks
