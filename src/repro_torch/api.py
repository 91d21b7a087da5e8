"""The port's facade: a ``JobSpec`` and a staged ``Session``, the
counterpart of ``repro.api`` for the path this slice runs:

    trace() → plan() → execute(real=True, check=...)

A planned two-party garbled-circuit job, one worker per party: the garbler
and the evaluator run as two engine threads in this process, on one
device, over an in-process channel; their AND gates go through the
half-gates kernels.  The device is the card unless the caller passes
``device="cpu"``; without a card and without that, the Session raises.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .core.bytecode import Program
from .core.engine import EngineStats
from .core.liveness import stripped_touches, working_set_pages
from .core.planner import PlanConfig, PlanReport, plan
from .core.transport import InprocTransport, LinkStats
from .core.workers import EngineJob, run_engines
from .exec.batched_gc import BatchedGCDriver
from .exec.batching import build_batch_schedule
from .kernels import resolve_device
from .protocols.garbled.driver import EvaluatorDriver, GarblerDriver
from .protocols.garbled.gates import GateCounts, PartyChannel
from .workloads import Workload, get

#: the garbler's label seed, as in the JAX package's two-party Session
GARBLER_SEED = 7


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One trace→plan→execute job.

    ``memory_budget`` is the paper's T: an ``int`` is an absolute frame
    count; a ``float`` in (0, 1] is a fraction of the working set, resolved
    with the JAX package's clamping (at least ``8 + prefetch_pages``
    frames, below the working set so there is real memory pressure, the
    prefetch buffer at most a quarter of the budget)."""
    workload: str
    n: int | None = None                  # records per party (None: default)
    memory_budget: int | float | None = None
    lookahead: int = 10_000               # plan knobs (paper l and B)
    prefetch_pages: int = 0

    def __post_init__(self):
        if self.memory_budget is None:
            raise ValueError("a memory_budget is needed (frames or "
                             "working-set fraction)")
        if isinstance(self.memory_budget, float) and \
                not 0.0 < self.memory_budget <= 1.0:
            raise ValueError("fractional memory_budget must be in (0, 1]")

    def normalized(self, workload: Workload) -> "JobSpec":
        return self if self.n is not None else \
            dataclasses.replace(self, n=workload.default_n)


def resolve_plan_config(spec: JobSpec, working_set: int) -> PlanConfig:
    """Turn a spec's budget into a concrete PlanConfig."""
    b = spec.memory_budget
    prefetch = spec.prefetch_pages
    if isinstance(b, float):
        min_frames = 8 + prefetch
        budget = max(int(working_set * b), min_frames)
        budget = min(budget, max(working_set - 1, min_frames))
        prefetch = min(prefetch, max(budget // 4, 1))
    else:
        budget = int(b)
    return PlanConfig(num_frames=budget, lookahead=spec.lookahead,
                      prefetch_pages=prefetch)


def check_outputs(w: Workload, n: int, outputs: dict[int, np.ndarray]
                  ) -> None:
    """Compare executed outputs with the workload's numpy oracle."""
    exp = w.oracle(n)
    missing = set(exp) - set(outputs)
    if missing:
        raise AssertionError(f"{w.name}: missing outputs "
                             f"{sorted(missing)[:5]}...")
    for tag, e in exp.items():
        if not np.array_equal(outputs[tag], e):
            raise AssertionError(f"{w.name} tag {tag}: {outputs[tag][:4]} "
                                 f"!= {e[:4]}")


class Session:
    """Staged trace→plan→execute over one JobSpec on one device.

    After ``execute()``: ``engine_stats`` (garbler, evaluator),
    ``gate_counts`` (garbler, evaluator), ``transport_stats`` of the party
    link, ``timings`` (``trace_s``, ``plan_s``, ``execute_s``) and, with
    ``digest=True``, ``table_digest`` of the garbled-table stream."""

    def __init__(self, spec: JobSpec, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.workload = get(spec.workload)
        self.spec = spec.normalized(self.workload)
        self._progs: list[Program] | None = None
        self._planned: list[Program] | None = None
        self.config: PlanConfig | None = None
        self.plan_reports: list[PlanReport] = []
        self.engine_stats: list[EngineStats] = []
        self.gate_counts: list[GateCounts] = []
        self.transport_stats: dict[tuple[int, int, int], LinkStats] = {}
        self.timings: dict[str, float] = {}
        self.table_digest: str | None = None

    def trace(self) -> list[Program]:
        """Trace the workload's DSL program (placement, §6.1)."""
        if self._progs is None:
            t0 = time.perf_counter()
            self._progs = self.workload.trace(self.spec.n, 1)
            self.timings["trace_s"] = time.perf_counter() - t0
        return self._progs

    def working_set(self) -> int:
        """Peak live pages of the virtual trace (w of §2.4.3)."""
        prog = self.trace()[0]
        return working_set_pages(stripped_touches(prog)[1])

    def plan(self) -> list[Program]:
        """Replacement + scheduling under the spec's budget (§6.1)."""
        if self._planned is None:
            progs = self.trace()
            t0 = time.perf_counter()
            self.config = resolve_plan_config(self.spec, self.working_set())
            mem, report = plan(progs[0], self.config)
            self.timings["plan_s"] = time.perf_counter() - t0
            self._planned = [mem]
            self.plan_reports = [report]
        return self._planned

    def adopt_plan(self, programs: list[Program]) -> None:
        """Execute these memory programs instead of planning (e.g. the JAX
        package's plan, carried over by ``interop.program_from_records``)."""
        if len(programs) != 1 or programs[0].phase != "memory":
            raise ValueError("expected one memory-phase program")
        self._planned = list(programs)

    def execute(self, real: bool = True, check: bool = False,
                digest: bool = False) -> dict[int, np.ndarray]:
        """Run the plan with real two-party crypto; returns the evaluator's
        ``tag -> value`` outputs (checked against the oracle with
        ``check``).  ``digest`` hashes the garbled-table stream, which
        copies every table to the host."""
        if not real:
            raise NotImplementedError("the plaintext driver is not ported "
                                      "yet; run with real=True")
        planned = self.plan()
        dev = self.device
        w, n = self.workload, self.spec.n
        t0 = time.perf_counter()
        sched = build_batch_schedule(planned[0])
        self.timings["batch_schedule_s"] = time.perf_counter() - t0
        transport = InprocTransport(2)
        ch = PartyChannel(transport, src=0, dst=1, digest=digest)
        gd = GarblerDriver(ch, dev, w.inputs(n, 0, 1), seed=GARBLER_SEED)
        ed = EvaluatorDriver(ch, dev, w.inputs(n, 0, 1))
        jobs = [EngineJob(planned[0], BatchedGCDriver(d), dev, sched,
                          tag=f"party{p}/worker0")
                for p, d in enumerate((gd, ed))]
        t0 = time.perf_counter()
        try:
            self.engine_stats = run_engines(jobs, transport)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            transport.close()
        self.timings["execute_s"] = time.perf_counter() - t0
        self.gate_counts = [gd.gates.counts, ed.gates.counts]
        self.transport_stats = transport.stats()
        if digest:
            self.table_digest = ch.table_digest()
        outputs = dict(ed.outputs)
        if check:
            check_outputs(w, n, outputs)
        return outputs
