"""Parallel execution (§5.1-§5.2, §6 "per-worker planning"): the port's
copy of ``repro.core.workers`` (the streaming planner waits for a later
slice).

Workers follow the paper's distributed-memory model: each worker is one
thread of computation with its own MAGE-physical address space; DSL
programs are parameterized by (worker, num_workers) and move data between
workers with explicit network directives (``send_value`` / ``recv_into``).
Planning runs once per worker, independently: serially, in threads or in
processes (programs and plan reports are picklable).

``run_engines`` is the single place that spawns engine threads and
collects their errors: the Session builds one :class:`EngineJob` per
(party, worker) rank this process hosts (all of them, or one in a
fleet) and hands them here with the fabric they share.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import multiprocessing
import threading
from typing import Any, Callable, Sequence

from .bytecode import Op, Program
from .dsl import Value, trace
from .engine import Engine, ProtocolDriver
from .planner import PlanConfig, PlanReport, plan
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


def _plan_one(prog: Program, cfg: PlanConfig) -> tuple[Program, PlanReport]:
    """Module-level so ``parallel="process"`` can pickle it."""
    return plan(prog, cfg)


def plan_workers(progs: Sequence[Program],
                 cfg: PlanConfig | Sequence[PlanConfig],
                 parallel: bool | str = False
                 ) -> tuple[list[Program], list[PlanReport]]:
    """Plan each worker's program independently (§6.1).

    ``parallel`` picks the executor: ``False`` / ``"serial"`` plans
    in-line, ``True`` / ``"thread"`` one planner thread per worker,
    ``"process"`` one process per worker (spawned: a forked child of a
    process that holds a CUDA context must not touch the card, and a
    fresh one need not care).  ``cfg`` is one PlanConfig or one per
    worker (fractional budgets resolve per working set)."""
    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg] * len(progs)
    if len(cfgs) != len(progs):
        raise ValueError(f"{len(cfgs)} configs for {len(progs)} workers")
    mode = {False: "serial", True: "thread"}.get(parallel, parallel)
    if mode not in PARALLEL_MODES:
        raise ValueError(f"parallel must be one of {PARALLEL_MODES}, "
                         f"got {parallel!r}")
    if mode == "serial" or len(progs) <= 1:
        results = list(map(_plan_one, progs, cfgs))
    elif mode == "thread":
        with cf.ThreadPoolExecutor(max_workers=len(progs),
                                   thread_name_prefix="mage-plan") as ex:
            results = list(ex.map(_plan_one, progs, cfgs))
    else:
        with cf.ProcessPoolExecutor(
                max_workers=len(progs),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(_plan_one, progs, cfgs))
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
