"""Run workloads end to end: the plaintext oracle, real two-party GC and
CKKS execution, bounded-memory execution — the port's copy of
``repro.workloads.runner``, thin wrappers over :class:`repro_torch.api.
Session`.  A ``cfg`` of ``None`` runs unbounded; ``device`` is the card
unless the caller passes ``"cpu"``; ``num_workers`` workers per party.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..api import CKKS_ATOL, JobSpec, Session, check_outputs
from ..core.planner import PlanConfig
from .base import Workload


def _session(w: Workload, n: int, num_workers: int, cfg: PlanConfig | None,
             use_memmap: bool, device) -> Session:
    kw = dict(n=n, num_workers=num_workers,
              storage="memmap" if use_memmap else "ram")
    if cfg is None:
        kw["plan_mode"] = "unbounded"
    else:
        kw.update(memory_budget=cfg.num_frames, lookahead=cfg.lookahead,
                  prefetch_pages=cfg.prefetch_pages, policy=cfg.policy,
                  swap_bypass=cfg.swap_bypass)
    return Session(JobSpec(w.name, **kw), device=device, workload=w)


def run_gc_plaintext(w: Workload, n: int, num_workers: int = 1,
                     cfg: PlanConfig | None = None, use_memmap: bool = False,
                     device=None) -> dict[int, np.ndarray]:
    return _session(w, n, num_workers, cfg, use_memmap,
                    device).execute(real=False)


def run_gc_real(w: Workload, n: int, num_workers: int = 1,
                cfg: PlanConfig | None = None, use_memmap: bool = False,
                device=None) -> dict[int, np.ndarray]:
    """Both parties, all workers: 2p engines, one party channel per worker
    pair (the one-to-one inter-party topology of Fig. 3)."""
    return _session(w, n, num_workers, cfg, use_memmap,
                    device).execute(real=True)


def run_ckks(w: Workload, n: int, num_workers: int = 1,
             cfg: PlanConfig | None = None, use_memmap: bool = False,
             params=None, device=None) -> dict[int, np.ndarray]:
    if params is not None:
        # a full CkksParams override (every field, not just ring/levels):
        # the workload's base params for this run
        w = dataclasses.replace(w, params={**w.params, "ckks_params": params})
    return _session(w, n, num_workers, cfg, use_memmap, device).execute()


def run(w: Workload, n: int, real: bool = False, **kw
        ) -> dict[int, np.ndarray]:
    if w.protocol == "gc":
        return (run_gc_real if real else run_gc_plaintext)(w, n, **kw)
    return run_ckks(w, n, **kw)


def check_against_oracle(w: Workload, n: int, outputs: dict[int, np.ndarray],
                         atol: float = CKKS_ATOL, **extra) -> None:
    """``extra`` reaches the oracle: ``ckks_params`` for a CKKS workload
    run at other parameters than its default."""
    check_outputs(w, n, outputs, atol=atol, **extra)
