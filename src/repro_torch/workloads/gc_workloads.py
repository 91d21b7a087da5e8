"""The garbled-circuit workloads of the port: ``merge`` (§8.1.1), the
port's copy of its part of ``repro.workloads.gc_workloads``.

n records per party, 128-bit records with 32-bit keys; inputs are
deterministic per (n, tag), and the oracle is a stable key sort.
"""

from __future__ import annotations

import numpy as np

from ..core.workers import ProgramOptions
from ..protocols.garbled.dsl import Party
from .base import GC_PAGE_SHIFT, Workload, register
from .gc_library import (GC_CHUNK, bitonic_merge_sorted_chunks, input_chunks,
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


def _merge_build(opts: ProgramOptions) -> None:
    if opts.num_workers != 1:
        raise NotImplementedError("multi-worker merge is not ported yet")
    n = opts.problem_size
    a = input_chunks(n, Party.Garbler, A_TAGS)
    b = input_chunks(n, Party.Evaluator, B_TAGS)
    out = bitonic_merge_sorted_chunks(a, b, opts)
    output_chunks(out, OUT_TAGS)


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
