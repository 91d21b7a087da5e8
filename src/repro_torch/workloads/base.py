"""Workload harness: the port's copy of ``repro.workloads.base``.

Each workload packages (1) a DSL program parameterized by ProgramOptions,
(2) deterministic synthetic inputs, (3) a numpy oracle for its outputs, and
(4) protocol/page-size defaults matching the paper (GC: 64 KiB pages = 4096
wires; CKKS: 128 KiB pages of 8-byte words).  Inputs are materialized
first, then the computation runs, then outputs are written (§8.1.3), so
memory pressure is real.

Registered: the five garbled-circuit workloads, the five CKKS workloads,
the two §8.8 applications (passreuse, pir) and the two n-party Shamir
workloads (shamir_stats, shamir_cmp; the parties are the job's
workers).  A CKKS workload's ``inputs`` and ``oracle`` also take
``ckks_params``, the parameters the job runs at.  A build traces one
program per worker (``ProgramOptions``' ``worker`` and ``num_workers``);
passreuse takes one worker only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..core.bytecode import Program
from ..core.workers import ProgramOptions, trace_workers

GC_PAGE_SHIFT = 12    # 4096 wires * 16 B = 64 KiB, the paper's GC page size
CKKS_PAGE_SHIFT = 14  # 16384 words = 128 KiB pages (scaled with our N)


@dataclasses.dataclass
class Workload:
    name: str
    protocol: str                      # 'gc' | 'ckks' | 'shamir'
    build: Callable[[ProgramOptions], None]
    inputs: Callable[[int, int, int], Callable[[int], np.ndarray]]
    # (problem_size, worker, num_workers) -> provider(tag)
    oracle: Callable[[int], dict[int, np.ndarray]]
    page_shift: int = GC_PAGE_SHIFT
    default_n: int = 256
    params: dict = dataclasses.field(default_factory=dict)

    def trace(self, n: int | None = None, num_workers: int = 1,
              **extra) -> list[Program]:
        n = n or self.default_n
        return trace_workers(self.build, protocol=self.protocol,
                             page_shift=self.page_shift,
                             num_workers=num_workers, problem_size=n,
                             extra={**self.params, **extra})


REGISTRY: dict[str, Workload] = {}


def register(w: Workload) -> Workload:
    REGISTRY[w.name] = w
    return w


def get(name: str) -> Workload:
    from . import (apps, ckks_workloads, gc_workloads,  # noqa: F401
                   shamir_workloads)
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"workload {name!r} is not ported yet; ported: "
                       f"{sorted(REGISTRY)}") from None


def all_names() -> list[str]:
    get("merge")  # force registration
    return sorted(REGISTRY)
