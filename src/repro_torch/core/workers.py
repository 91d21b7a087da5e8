"""Parallel execution (§5.1-§5.2, §6 "per-worker planning"): the port's
copy of ``repro.core.workers``.

Workers follow the paper's distributed-memory model: each worker is one
thread of computation with its own MAGE-physical address space; DSL
programs are parameterized by (worker, num_workers) and move data between
workers with explicit network directives (``send_value`` / ``recv_into``).
Planning runs once per worker, independently: serially, in threads or in
processes (programs, program files and plan reports are picklable), in
memory or out of core (``streaming``: one ``workerK/`` directory each).

``run_engines`` is the single place that spawns engine threads and
collects their errors: the Session builds one :class:`EngineJob` per
(party, worker) rank this process hosts (all of them, or one in a
fleet) and hands them here with the fabric they share.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import itertools
import multiprocessing
import os
import shutil
import tempfile
import threading
from typing import Any, Callable, Sequence

from .bytecode import Op, Program, ProgramFile, write_program
from .dsl import Value, trace
from .engine import Engine, ProtocolDriver
from .planner import PlanConfig, PlanReport, plan, plan_streaming
from .transport import Fabric, PartyView


@dataclasses.dataclass
class ProgramOptions:
    """Mirrors the paper's ProgramOptions: worker identity + problem params."""
    worker: int = 0
    num_workers: int = 1
    problem_size: int = 0
    extra: dict = dataclasses.field(default_factory=dict)


def send_value(v: Value, dst: int, tag: int | None = None) -> int:
    """Emit a NET_SEND of ``v`` to worker ``dst``; returns the tag (the
    builder's next fresh tag unless one is given)."""
    b = v.builder
    tag = b.fresh_tag() if tag is None else tag
    b.emit(Op.NET_SEND, ins=(v.span,), imm=(dst, tag))
    return tag


def recv_into(v: Value, src: int, tag: int) -> None:
    """Emit a NET_RECV from worker ``src`` under ``tag`` into ``v``."""
    v.builder.emit(Op.NET_RECV, outs=(v.span,), imm=(src, tag))


def trace_workers(fn: Callable[[ProgramOptions], None], *, protocol: str,
                  page_shift: int, num_workers: int,
                  problem_size: int = 0, extra: dict | None = None,
                  meta: dict | None = None) -> list[Program]:
    progs = []
    for w in range(num_workers):
        opts = ProgramOptions(worker=w, num_workers=num_workers,
                              problem_size=problem_size,
                              extra=dict(extra or {}))
        progs.append(trace(fn, protocol=protocol, page_shift=page_shift,
                           worker=w, num_workers=num_workers,
                           args=(opts,),
                           meta={"problem_size": problem_size,
                                 **(meta or {})}))
    return progs


# ---------------------------------------------------------------------------
# per-worker planning
# ---------------------------------------------------------------------------

PARALLEL_MODES = ("serial", "thread", "process")


def _plan_one(prog: Program | ProgramFile, cfg: PlanConfig,
              streaming: bool, wd: str | None, track_memory: bool,
              chunk_instrs: int, annotation: str | None,
              spawned: tuple[bool, bool] = (False, False),
              ) -> tuple[Program | ProgramFile, PlanReport]:
    """Module-level so ``parallel="process"`` can pickle it.  ``wd`` is
    this worker's directory (None: a fresh temporary one).  ``spawned`` =
    (``prog`` is a virtual file written for this call, removed after
    planning; ``wd`` was made for it, removed if planning fails)."""
    if not streaming:
        return plan(prog, cfg, track_memory=track_memory)
    own_file, own_dir = spawned
    try:
        return plan_streaming(prog, cfg, workdir=wd,
                              track_memory=track_memory,
                              chunk_instrs=chunk_instrs,
                              annotations=annotation)
    except BaseException:
        if own_dir:
            shutil.rmtree(wd, ignore_errors=True)
        raise
    finally:
        if own_file and os.path.exists(prog.path):
            os.unlink(prog.path)


def _virtual_file(prog: Program, wd: str | None, chunk_instrs: int
                  ) -> tuple[ProgramFile, str, tuple[bool, bool]]:
    """A worker's virtual program as a file in its directory (made here
    when ``wd`` is None), for a spawned streaming planner."""
    own_dir = wd is None
    if own_dir:
        wd = tempfile.mkdtemp(prefix="mage_plan_")
    else:
        os.makedirs(wd, exist_ok=True)
    pf = write_program(prog, os.path.join(wd, "virtual.bc"),
                       strip_free=True, chunk_instrs=chunk_instrs)
    return pf, wd, (True, own_dir)


def plan_workers(progs: Sequence[Program | ProgramFile],
                 cfg: PlanConfig | Sequence[PlanConfig],
                 parallel: bool | str = False, streaming: bool = False,
                 workdir: str | None = None, track_memory: bool = False,
                 chunk_instrs: int = 8192,
                 annotations: Sequence[str] | None = None,
                 ) -> tuple[list[Program | ProgramFile], list[PlanReport]]:
    """Plan each worker's program independently (§6.1).

    ``parallel`` picks the executor: ``False`` / ``"serial"`` plans
    in-line, ``True`` / ``"thread"`` one planner thread per worker,
    ``"process"`` one process per worker (spawned: a forked child of a
    process that holds a CUDA context must not touch the card, and a
    fresh one need not care).  ``cfg`` is one PlanConfig or one per
    worker (fractional budgets resolve per working set).

    ``streaming=True`` plans out of core, file to file, in a ``workerK/``
    subdirectory of ``workdir`` each (a fresh temporary directory each
    when ``workdir`` is None), and returns the memory programs as
    ProgramFiles, which the engine runs from disk; a spawned planner is
    handed its worker's virtual program as a file, written here first.
    ``annotations`` are optional per-worker next-use sidecars of the
    virtual programs (the annotation pass is skipped for those).
    ``track_memory=True`` measures each planner's peak with tracemalloc,
    which is process-global: with threads the workers plan serially
    instead."""
    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg] * len(progs)
    if len(cfgs) != len(progs):
        raise ValueError(f"{len(cfgs)} configs for {len(progs)} workers")
    anns = list(annotations) if annotations is not None \
        else [None] * len(progs)
    if len(anns) != len(progs):
        raise ValueError(f"{len(anns)} annotations for {len(progs)} workers")
    mode = {False: "serial", True: "thread"}.get(parallel, parallel)
    if mode not in PARALLEL_MODES:
        raise ValueError(f"parallel must be one of {PARALLEL_MODES}, "
                         f"got {parallel!r}")
    if track_memory and mode == "thread":
        mode = "serial"
    if len(progs) <= 1:
        mode = "serial"
    progs = list(progs)
    dirs = [os.path.join(workdir, f"worker{w}") if workdir else None
            for w in range(len(progs))]
    spawned = [(False, False)] * len(progs)
    if streaming and mode == "process":
        for w, prog in enumerate(progs):
            if isinstance(prog, Program):
                progs[w], dirs[w], spawned[w] = _virtual_file(
                    prog, dirs[w], chunk_instrs)
    args = (progs, cfgs, itertools.repeat(streaming), dirs,
            itertools.repeat(track_memory), itertools.repeat(chunk_instrs),
            anns, spawned)
    if mode == "serial":
        results = list(map(_plan_one, *args))
    elif mode == "thread":
        with cf.ThreadPoolExecutor(max_workers=len(progs),
                                   thread_name_prefix="mage-plan") as ex:
            results = list(ex.map(_plan_one, *args))
    else:
        with cf.ProcessPoolExecutor(
                max_workers=len(progs),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(_plan_one, *args))
    return [r[0] for r in results], [r[1] for r in results]


# ---------------------------------------------------------------------------
# the worker-orchestration core
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EngineJob:
    """One engine to run: a memory or virtual program, its driver, device
    and swap storage (``core.storage``; its owner closes it).  ``net`` is
    the engine's party-scoped window onto the transport (NET_*
    directives).  With a ``batch_schedule`` (``exec.batching``) the
    engine runs the batched path and the driver is a batched one; an
    ``overlap_schedule`` (``exec.overlap``) takes precedence and batches
    its local groups through the same driver; neither means the scalar
    loop.  ``tag`` labels failures (e.g. ``"party0/worker1"``)."""
    program: Program
    driver: ProtocolDriver
    device: Any
    storage: Any = None
    batch_schedule: Any = None
    tag: Any = None
    net: PartyView | None = None
    overlap_schedule: Any = None


def run_engines(jobs: Sequence[EngineJob], fabric: Fabric) -> list[Engine]:
    """Run one Engine per job, each on its own thread, over ``fabric``
    (the hosted ranks' transports: every party's workers and every party
    link); return the engines (their ``stats``, and their ``memory`` as
    the run left it) or re-raise failures.  Each engine holds the
    fabric's baton while it runs (``core.transport``): one baton for all
    the transports of the process.  Once an engine has failed, the fabric
    closes, so that its peers stop waiting for messages that will never
    come."""
    results: list[Engine | None] = [None] * len(jobs)
    errors: list[tuple[Any, Exception]] = []

    def _run(k: int, job: EngineJob) -> None:
        try:
            with fabric.baton:
                eng = Engine(job.program, job.driver, job.device,
                             job.storage, job.batch_schedule, net=job.net,
                             overlap_schedule=job.overlap_schedule)
                eng.run()
                results[k] = eng
        except Exception as e:  # surfaced below
            errors.append((job.tag if job.tag is not None else k, e))
            fabric.close()

    threads = [threading.Thread(target=_run, args=(k, job), daemon=True)
               for k, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(errors) == 1:
        raise errors[0][1]          # sole failure: original exception type
    if errors:
        tags = [t for t, _ in errors]
        raise RuntimeError(f"engine failures in {tags}: {errors}") \
            from errors[0][1]
    return results
