"""MAGE's planner pipeline (§6.1): placement → replacement → scheduling.

The port's copy of the in-memory path of ``repro.core.planner``, on the
scalar stage cores (the reference's ``plan(cfg.core="scalar")`` branch,
whose output is instruction-identical to its array cores).  ``plan()``
turns a virtual-address bytecode into a memory program for a given
physical memory budget.
"""

from __future__ import annotations

import dataclasses
import time

from .bytecode import Program
from .replacement import ReplacementStats, plan_replacement
from .scheduling import ScheduleStats, plan_schedule


@dataclasses.dataclass
class PlanConfig:
    """Memory budget + knobs (paper defaults for GC: 64 KiB pages,
    l=10000, B=256 pages; pages are counted in frames)."""
    num_frames: int                 # T: physical frames incl. prefetch buffer
    lookahead: int = 10_000         # l
    prefetch_pages: int = 0         # B (0 = replacement-only planning)
    policy: str = "min"
    swap_bypass: bool = False       # beyond-paper read-from-write-buffer

    @property
    def replacement_frames(self) -> int:
        return self.num_frames - self.prefetch_pages


@dataclasses.dataclass
class PlanReport:
    replacement_s: float = 0.0
    scheduling_s: float = 0.0
    replacement: ReplacementStats | None = None
    schedule: ScheduleStats | None = None

    @property
    def total_s(self) -> float:
        return self.replacement_s + self.scheduling_s


def plan(virtual_prog: Program, cfg: PlanConfig) -> tuple[Program, PlanReport]:
    if cfg.prefetch_pages >= cfg.num_frames:
        raise ValueError("prefetch buffer must be smaller than the budget")
    t0 = time.perf_counter()
    phys, rstats = plan_replacement(virtual_prog, cfg.replacement_frames,
                                    policy=cfg.policy)
    t1 = time.perf_counter()
    mem, sstats = plan_schedule(phys, cfg.lookahead, cfg.prefetch_pages,
                                swap_bypass=cfg.swap_bypass)
    t2 = time.perf_counter()
    mem.meta["plan"] = dataclasses.asdict(cfg)
    return mem, PlanReport(t1 - t0, t2 - t1, rstats, sstats)
