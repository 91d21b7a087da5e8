"""MAGE's planner pipeline (§6.1): placement → replacement → scheduling.

The port's copy of ``repro.core.planner``.  ``plan()`` turns a
virtual-address bytecode into a memory program for a given physical
memory budget; ``PlanReport`` captures the Table-1 metrics (planning
time, planner peak memory) plus per-stage statistics.

Two execution modes share the same stage cores (so their outputs are
instruction-identical):

  * ``plan()``           — in-memory, for small programs and tests;
  * ``plan_streaming()`` — out-of-core: every stage reads the previous
    stage's bytecode file chunk-by-chunk and appends to the next, so planner
    peak memory is O(chunk + frames + lookahead) regardless of program
    length (the paper's Table-1 claim).

The planner is host code on NumPy record arrays; nothing here touches a
device.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import tracemalloc

from .bytecode import Instr, Program, ProgramFile, decode_chunk, write_program
from .liveness import annotate_next_use
from .replacement import (ReplacementStats, plan_replacement,
                          plan_replacement_file, replacement_records)
from .scheduling import (ScheduleStats, plan_schedule, plan_schedule_file,
                         schedule_records)


@dataclasses.dataclass
class PlanConfig:
    """Memory budget + knobs (paper defaults: GC 64 KiB pages, l=10000, B=256
    pages; CKKS 2 MiB pages, l=100, B=16 — we express pages in slots).

    ``core`` selects the replacement/scheduling implementation: ``"array"``
    (default) runs the vectorized record-array cores, ``"scalar"`` the
    reference transducers.  Outputs are instruction-identical (tested
    bitwise), so the knob never changes a plan — only how fast it is made.
    """
    num_frames: int                 # T: physical frames incl. prefetch buffer
    lookahead: int = 10_000         # l
    prefetch_pages: int = 0         # B (0 = replacement-only planning)
    policy: str = "min"
    swap_bypass: bool = False       # beyond-paper read-from-write-buffer
    core: str = "array"             # array | scalar (same outputs)

    @property
    def replacement_frames(self) -> int:
        return self.num_frames - self.prefetch_pages


@dataclasses.dataclass
class PlanReport:
    annotate_s: float = 0.0         # streaming-only: backward next-use pass
    replacement_s: float = 0.0
    scheduling_s: float = 0.0
    peak_mem_bytes: int = 0
    replacement: ReplacementStats | None = None
    schedule: ScheduleStats | None = None

    @property
    def total_s(self) -> float:
        return self.annotate_s + self.replacement_s + self.scheduling_s


def plan(virtual_prog: Program, cfg: PlanConfig,
         track_memory: bool = False) -> tuple[Program, PlanReport]:
    report = PlanReport()
    if cfg.prefetch_pages >= cfg.num_frames:
        raise ValueError("prefetch buffer must be smaller than the budget")
    if track_memory:
        tracemalloc.start()
    t0 = time.perf_counter()
    # Fused array pipeline: records chain between stages (one encode at
    # the front, one decode at the end).  Falls back to the staged path
    # when the array core cannot run this program/policy.
    fused = replacement_records(virtual_prog, cfg.replacement_frames,
                                cfg.policy) if cfg.core == "array" else None
    if fused is not None:
        phys_chunks, rstats = fused
        t1 = time.perf_counter()
        out: list[Instr] = []
        sstats = schedule_records(
            phys_chunks, cfg.lookahead, cfg.prefetch_pages,
            lambda c: out.extend(decode_chunk(c)),
            swap_bypass=cfg.swap_bypass)
        mem = Program(
            instrs=out, page_shift=virtual_prog.page_shift,
            protocol=virtual_prog.protocol, phase="memory",
            worker=virtual_prog.worker,
            num_workers=virtual_prog.num_workers,
            vspace_slots=virtual_prog.vspace_slots,
            num_frames=cfg.replacement_frames,
            prefetch_slots=max(cfg.prefetch_pages, 0),
            meta=dict(virtual_prog.meta))
        t2 = time.perf_counter()
    else:
        # the array core already proved it cannot run this program/policy
        # (or core="scalar" was asked for): the scalar stages are both
        # faster here and instruction-identical
        phys, rstats = plan_replacement(virtual_prog,
                                        cfg.replacement_frames,
                                        policy=cfg.policy, core="scalar")
        t1 = time.perf_counter()
        mem, sstats = plan_schedule(phys, cfg.lookahead,
                                    cfg.prefetch_pages,
                                    swap_bypass=cfg.swap_bypass,
                                    core="scalar")
        t2 = time.perf_counter()
    if track_memory:
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        report.peak_mem_bytes = peak
    report.replacement_s = t1 - t0
    report.scheduling_s = t2 - t1
    report.replacement = rstats
    report.schedule = sstats
    mem.meta["plan"] = dataclasses.asdict(cfg)
    return mem, report


def plan_memory_estimate(cfg: PlanConfig, chunk_instrs: int = 8192) -> int:
    """Upper-bound bytes of planner peak memory for one worker, O(frames).

    The streaming pipeline's state is the Table-1 bound
    O(chunk + frames + lookahead): per-frame bookkeeping (frame table,
    residency maps, MIN-policy heap entries — a few machine words each),
    the scheduler's lookahead window, and a handful of in-flight record
    chunks per stage.  The constants below are deliberately generous
    (~2x measured ``PlanReport.peak_mem_bytes``), so the estimate errs
    high."""
    from .bytecode import RECORD_BYTES
    per_frame = 128          # frame table + residency + heap, with slack
    chunks_in_flight = 8     # 3 stages x (read + write) + fused-core slack
    return (cfg.num_frames * per_frame
            + max(cfg.lookahead, 1) * 32
            + chunks_in_flight * chunk_instrs * RECORD_BYTES)


def plan_streaming(virtual: Program | ProgramFile, cfg: PlanConfig,
                   out_path: str | os.PathLike | None = None,
                   workdir: str | os.PathLike | None = None,
                   track_memory: bool = False,
                   chunk_instrs: int = 8192,
                   keep_intermediates: bool = False,
                   annotations: str | os.PathLike | None = None,
                   ) -> tuple[ProgramFile, PlanReport]:
    """Out-of-core planning: file-to-file stages, bounded planner memory.

    ``virtual`` is either an in-memory 'virtual' Program (serialized first,
    FREEs stripped) or an already-written 'virtual' ProgramFile.  Returns
    the memory program as a ProgramFile the streaming engine can execute
    directly.  Output is instruction-identical to ``plan()``.

    The caller owns the returned file: with ``workdir=None`` a fresh
    temporary directory is created to hold it (intermediates are always
    cleaned up, and the directory itself is removed if planning fails),
    but after a successful call it is the caller's to delete when done —
    the memory program can be far larger than RAM, so nothing here can
    decide its lifetime.  Pass ``out_path`` to place the result somewhere
    you already manage.

    ``annotations`` is an optional pre-computed next-use sidecar for
    ``virtual`` (as written by ``annotate_next_use``); when given, the
    backward annotation pass is skipped (``report.annotate_s == 0``) and
    the caller keeps ownership of the sidecar file, so one trace is
    replanned under other budgets without re-annotating.
    """
    report = PlanReport()
    if cfg.prefetch_pages >= cfg.num_frames:
        raise ValueError("prefetch buffer must be smaller than the budget")
    made_workdir = workdir is None
    if made_workdir:
        workdir = tempfile.mkdtemp(prefix="mage_plan_")
    else:
        os.makedirs(workdir, exist_ok=True)
    vpath = os.path.join(workdir, "virtual.bc")
    apath = os.path.join(workdir, "virtual.ann")
    ppath = os.path.join(workdir, "physical.bc")
    mpath = os.fspath(out_path) if out_path is not None \
        else os.path.join(workdir, "memory.bc")

    if track_memory:
        tracemalloc.start()
    wrote_virtual = False
    done = False
    try:
        if isinstance(virtual, Program):
            virtual = write_program(virtual, vpath, strip_free=True,
                                    chunk_instrs=chunk_instrs)
            wrote_virtual = True
        assert virtual.phase == "virtual", virtual.phase

        t0 = time.perf_counter()
        if annotations is not None:
            apath = os.fspath(annotations)   # caller-owned: never unlinked
            t1 = t0                          # pass skipped: annotate_s == 0
        else:
            annotate_next_use(virtual, apath, chunk_instrs)
            t1 = time.perf_counter()
        phys, rstats = plan_replacement_file(
            virtual, ppath, cfg.replacement_frames, policy=cfg.policy,
            annotations=apath, chunk_instrs=chunk_instrs, core=cfg.core)
        t2 = time.perf_counter()
        mem, sstats = plan_schedule_file(
            phys, mpath, cfg.lookahead, cfg.prefetch_pages,
            swap_bypass=cfg.swap_bypass, chunk_instrs=chunk_instrs,
            meta={**dict(virtual.meta), "plan": dataclasses.asdict(cfg)},
            core=cfg.core)
        t3 = time.perf_counter()
        done = True
    finally:
        if track_memory:
            _, peak = tracemalloc.get_traced_memory()
            tracemalloc.stop()
            report.peak_mem_bytes = peak
        if not done and made_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        elif not keep_intermediates:
            doomed = [vpath] if wrote_virtual else []
            if annotations is None:
                doomed.append(apath)
            doomed.append(ppath)
            for p in doomed:
                if os.path.exists(p):
                    os.unlink(p)
    report.annotate_s = t1 - t0
    report.replacement_s = t2 - t1
    report.scheduling_s = t3 - t2
    report.replacement = rstats
    report.schedule = sstats
    return mem, report
