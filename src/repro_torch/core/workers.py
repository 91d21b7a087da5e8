"""Worker tracing and the engine-orchestration core: the port's copy of the
parts of ``repro.core.workers`` this slice runs (one worker per party;
parallel and streaming planning wait for a later slice).

``run_engines`` is the single place that spawns engine threads and
collects their errors: the two-party Session builds one
:class:`EngineJob` per party and hands them here.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Sequence

from .bytecode import Program
from .dsl import trace
from .engine import Engine, ProtocolDriver
from .transport import InprocTransport


@dataclasses.dataclass
class ProgramOptions:
    """Mirrors the paper's ProgramOptions: worker identity + problem params."""
    worker: int = 0
    num_workers: int = 1
    problem_size: int = 0
    extra: dict = dataclasses.field(default_factory=dict)


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


@dataclasses.dataclass
class EngineJob:
    """One engine to run: a memory or virtual program, its driver, device
    and swap storage (``core.storage``; its owner closes it).  With a
    ``batch_schedule`` (``exec.batching``) the engine runs the batched path
    and the driver is a batched one; ``None`` means the scalar loop.
    ``tag`` labels failures (e.g. ``"party0/worker0"``)."""
    program: Program
    driver: ProtocolDriver
    device: Any
    storage: Any = None
    batch_schedule: Any = None
    tag: Any = None


def run_engines(jobs: Sequence[EngineJob],
                transport: InprocTransport) -> list[Engine]:
    """Run one Engine per job, each on its own thread, over ``transport``;
    return the engines (their ``stats``, and their ``memory`` as the run
    left it) or re-raise failures.  Each engine holds the transport's
    baton while it runs (``core.transport``).  Once an engine has failed,
    the transport closes, so that its peer stops waiting for messages that
    will never come."""
    results: list[Engine | None] = [None] * len(jobs)
    errors: list[tuple[Any, Exception]] = []

    def _run(k: int, job: EngineJob) -> None:
        try:
            with transport.baton:
                eng = Engine(job.program, job.driver, job.device,
                             job.storage, job.batch_schedule)
                eng.run()
                results[k] = eng
        except Exception as e:  # surfaced below
            errors.append((job.tag if job.tag is not None else k, e))
            transport.close()

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
