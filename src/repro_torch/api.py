"""The port's facade: a ``JobSpec`` and a staged ``Session``, the
counterpart of ``repro.api`` for the paths the port runs:

    trace() → plan() → execute(real=True, check=...)

``execute`` dispatches on the workload's protocol.  A garbled-circuit job
runs two parties, one worker each: the garbler and the evaluator are two
engine threads in this process, on one device, over an in-process channel,
and their AND gates go through the half-gates kernels.  With
``real=False`` it runs one engine with the plaintext oracle driver (the
JAX package's ``gc-plaintext``) instead.  A CKKS job runs
one engine whose transforms and products go through the NTT kernels.  The
device is the card unless the caller passes ``device="cpu"``; without a
card and without that, the Session raises.

The knobs are the JAX package's, with its names and values: ``plan_mode``
"memory" (planned paging at a budget) or "unbounded" (the baseline: the
traced program over the whole virtual address space); ``policy`` (MIN,
MinClean, LRU, FIFO) and ``swap_bypass``; ``exec_backend`` "batched" (a
batch schedule, the port's default) or "scalar" (one instruction at a
time; the reference's default); ``storage`` "ram" (pinned host pages) or
"memmap" (a swap file).  The streaming planner, the overlap backend and
multi-worker jobs wait for later slices.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .core.bytecode import Program
from .core.engine import Engine, EngineStats, swapped_pages
from .core.liveness import stripped_touches, working_set_pages
from .core.planner import PlanConfig, PlanReport, plan
from .core.replacement import POLICIES
from .core.storage import MemmapStorage, PinnedStorage
from .core.transport import InprocTransport, LinkStats
from .core.workers import EngineJob, run_engines
from .exec.batched_ckks import BatchedCkksDriver
from .exec.batched_gc import BatchedGCDriver, BatchedPlaintextDriver
from .exec.batching import build_batch_schedule
from .kernels import resolve_device
from .protocols.ckks.driver import CkksDriver
from .protocols.ckks.params import CkksParams
from .protocols.garbled.driver import (EvaluatorDriver, GarblerDriver,
                                       PlaintextDriver)
from .protocols.garbled.gates import GateCounts, PartyChannel
from .workloads import Workload, get
from .workloads.ckks_workloads import PARAMS as DEFAULT_CKKS

#: the garbler's label seed, as in the JAX package's two-party Session
GARBLER_SEED = 7
#: the CKKS driver's key and noise seed, as in the JAX package's Session
CKKS_SEED = 0xCEC5
#: the largest |output - oracle| a CKKS job may show (the JAX package's)
CKKS_ATOL = 2e-2

#: the JAX package's plan modes and execution backends; those not ported
#: yet name the ROADMAP item that ports them
PLAN_MODES = ("memory", "streaming", "unbounded")
EXEC_BACKENDS = ("scalar", "batched", "overlap")
NOT_PORTED = {"streaming": "the streaming planner (ROADMAP Queue 1 item 6)",
              "overlap": "the overlap backend (ROADMAP Queue 1 item 4)"}

#: swap storages by the JAX package's names; "ram" is pinned host memory
STORAGES = {"ram": PinnedStorage, "memmap": MemmapStorage}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One trace→plan→execute job.

    ``memory_budget`` is the paper's T: an ``int`` is an absolute frame
    count; a ``float`` in (0, 1] is a fraction of the working set, resolved
    with the JAX package's clamping (at least ``8 + prefetch_pages``
    frames, below the working set so there is real memory pressure, the
    prefetch buffer at most a quarter of the budget).  ``None`` requires
    ``plan_mode="unbounded"``, which takes no budget."""
    workload: str
    n: int | None = None                  # records per party (None: default)
    memory_budget: int | float | None = None
    lookahead: int = 10_000               # plan knobs (paper l, B, policy)
    prefetch_pages: int = 0
    policy: str = "min"
    swap_bypass: bool = False
    plan_mode: str = "memory"             # memory | unbounded
    exec_backend: str = "batched"         # batched | scalar
    storage: str = "ram"                  # ram | memmap
    ckks_ring: int | None = None          # CKKS N override (benchmarks)
    ckks_levels: int | None = None

    def __post_init__(self):
        for field, value, allowed in (
                ("plan_mode", self.plan_mode, PLAN_MODES),
                ("exec_backend", self.exec_backend, EXEC_BACKENDS),
                ("policy", self.policy, tuple(POLICIES)),
                ("storage", self.storage, tuple(STORAGES))):
            if value not in allowed:
                raise ValueError(f"{field} must be one of {allowed}, got "
                                 f"{value!r}")
            if value in NOT_PORTED:
                raise NotImplementedError(f"{field}={value!r} is not ported "
                                          f"yet: {NOT_PORTED[value]}")
        if self.plan_mode == "unbounded":
            if self.memory_budget is not None:
                raise ValueError("unbounded jobs take no memory_budget")
        elif self.memory_budget is None:
            raise ValueError(f"plan_mode={self.plan_mode!r} needs a "
                             f"memory_budget (frames or working-set "
                             f"fraction)")
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
                      prefetch_pages=prefetch, policy=spec.policy,
                      swap_bypass=spec.swap_bypass)


def check_outputs(w: Workload, n: int, outputs: dict[int, np.ndarray],
                  atol: float = CKKS_ATOL, **extra) -> None:
    """Compare executed outputs with the workload's numpy oracle: exactly
    for garbled circuits, within ``atol`` for CKKS (approximate
    arithmetic).  ``extra`` reaches the oracle (``ckks_params``)."""
    exp = w.oracle(n, **extra)
    missing = set(exp) - set(outputs)
    if missing:
        raise AssertionError(f"{w.name}: missing outputs "
                             f"{sorted(missing)[:5]}...")
    for tag, e in exp.items():
        got = outputs[tag]
        if w.protocol == "gc":
            if not np.array_equal(got, e):
                raise AssertionError(f"{w.name} tag {tag}: {got[:4]} != "
                                     f"{e[:4]}")
        else:
            err = np.max(np.abs(np.asarray(got) - e))
            if not err < atol:
                raise AssertionError(f"{w.name} tag {tag}: err {err}")


class Session:
    """Staged trace→plan→execute over one JobSpec on one device.

    After ``execute()``: ``engines`` (each holding its final ``memory``),
    their ``engine_stats`` and (closed) ``storages``, ``timings``
    (``trace_s``, ``plan_s``, ``batch_schedule_s`` on the batched backend,
    ``execute_s``) and the protocol's records.
    Garbled circuits run for real: ``gate_counts`` (garbler, evaluator),
    ``transport_stats`` of the party link and, with ``digest=True``,
    ``table_digest`` of the garbled-table stream; in the clear, one
    engine.  ``workload`` overrides the registry's (the JAX package's
    runner passes one with other CKKS parameters).  CKKS:
    ``ckks_counts``, the rows of the transforms and modular products the
    job asked for (``ntt_forward``, ``ntt_inverse``, ``mul_mod``; key
    generation included), and ``op_counts``, its instructions by opcode."""

    def __init__(self, spec: JobSpec, device: str | torch.device | None = None,
                 workload: Workload | None = None):
        if workload is not None and workload.name != spec.workload:
            raise ValueError(f"workload object {workload.name!r} does not "
                             f"match spec.workload {spec.workload!r}")
        self.device = resolve_device(device)
        self.workload = workload or get(spec.workload)
        self.spec = spec.normalized(self.workload)
        self._progs: list[Program] | None = None
        self._planned: list[Program] | None = None
        self.config: PlanConfig | None = None
        self.plan_reports: list[PlanReport] = []
        self.engines: list[Engine] = []
        self.engine_stats: list[EngineStats] = []
        self.storages: list = []
        self.gate_counts: list[GateCounts] = []
        self.transport_stats: dict[tuple[int, int, int], LinkStats] = {}
        self.timings: dict[str, float] = {}
        self.table_digest: str | None = None
        self.ckks_counts: dict[str, int] = {}
        self.op_counts: dict[str, int] = {}

    @property
    def protocol(self) -> str:
        return self.workload.protocol

    def ckks_params(self) -> CkksParams:
        """The workload's CKKS parameters with the spec's ring and levels
        (the scale and noise parameters stay)."""
        p = self.workload.params.get("ckks_params", DEFAULT_CKKS)
        return dataclasses.replace(p, n_ring=self.spec.ckks_ring or p.n_ring,
                                   levels=self.spec.ckks_levels or p.levels)

    def _extra(self) -> dict:
        """What the workload's trace, inputs and oracle take beyond n."""
        return {"ckks_params": self.ckks_params()} \
            if self.protocol == "ckks" else {}

    def trace(self) -> list[Program]:
        """Trace the workload's DSL program (placement, §6.1)."""
        if self._progs is None:
            t0 = time.perf_counter()
            self._progs = self.workload.trace(self.spec.n, 1, **self._extra())
            self.timings["trace_s"] = time.perf_counter() - t0
        return self._progs

    def working_set(self) -> int:
        """Peak live pages of the virtual trace (w of §2.4.3)."""
        prog = self.trace()[0]
        return working_set_pages(stripped_touches(prog)[1])

    def plan(self) -> list[Program]:
        """Replacement + scheduling under the spec's budget (§6.1).  An
        unbounded job's "plan" is the traced program itself, with an empty
        report and no config."""
        if self._planned is None:
            progs = self.trace()
            if self.spec.plan_mode == "unbounded":
                self._planned = list(progs)
                self.plan_reports = [PlanReport() for _ in progs]
                return self._planned
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
        """Run the plan; returns the ``tag -> value`` outputs (checked
        against the oracle with ``check``).  Garbled circuits run with real
        two-party crypto, or in the clear with ``real=False`` (the
        plaintext oracle driver); ``digest`` hashes the garbled-table
        stream, which copies every table to the host.  CKKS is real crypto
        either way."""
        if digest and not (real and self.protocol == "gc"):
            raise ValueError("digest=True hashes garbled tables: it needs a "
                             "garbled-circuit job with real=True")
        planned = self.plan()
        sched = None
        if self.spec.exec_backend == "batched":
            t0 = time.perf_counter()
            sched = build_batch_schedule(planned[0])
            self.timings["batch_schedule_s"] = time.perf_counter() - t0
        if self.protocol == "ckks":
            outputs = self._execute_ckks(planned[0], sched)
        elif real:
            outputs = self._execute_gc(planned[0], sched, digest)
        else:
            outputs = self._execute_plaintext(planned[0], sched)
        if check:
            check_outputs(self.workload, self.spec.n, outputs,
                          **self._extra())
        return outputs

    def _run(self, prog: Program, drivers: list, batched_cls, sched,
             transport: InprocTransport) -> None:
        """Run one engine per driver (party ``p`` is ``drivers[p]``) over
        ``prog``: through ``batched_cls(driver)`` when there is a batch
        schedule, the driver itself on the scalar loop, each with a fresh
        storage of the spec's kind for the pages ``prog`` writes out.  The
        storages are built inside the execute time and closed at its end,
        also when a run fails."""
        t0 = time.perf_counter()
        try:
            jobs = []
            for p, drv in enumerate(drivers):
                storage = STORAGES[self.spec.storage](
                    swapped_pages(prog), (prog.page_slots, drv.lane),
                    drv.dtype, self.device)
                self.storages.append(storage)
                jobs.append(EngineJob(
                    prog, batched_cls(drv) if sched is not None else drv,
                    self.device, storage, sched, tag=f"party{p}/worker0"))
            self.engines = run_engines(jobs, transport)
            self.engine_stats = [e.stats for e in self.engines]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            transport.close()
            for storage in self.storages:
                storage.close()
        self.timings["execute_s"] = time.perf_counter() - t0

    def _execute_gc(self, planned: Program, sched, digest: bool
                    ) -> dict[int, np.ndarray]:
        dev = self.device
        w, n = self.workload, self.spec.n
        transport = InprocTransport(2)
        ch = PartyChannel(transport, src=0, dst=1, digest=digest)
        gd = GarblerDriver(ch, dev, w.inputs(n, 0, 1), seed=GARBLER_SEED)
        ed = EvaluatorDriver(ch, dev, w.inputs(n, 0, 1))
        self._run(planned, [gd, ed], BatchedGCDriver, sched, transport)
        self.gate_counts = [gd.gates.counts, ed.gates.counts]
        self.transport_stats = transport.stats()
        if digest:
            self.table_digest = ch.table_digest()
        return dict(ed.outputs)

    def _execute_plaintext(self, planned: Program, sched
                           ) -> dict[int, np.ndarray]:
        """One engine over a one-party transport, in the clear."""
        drv = PlaintextDriver(self.workload.inputs(self.spec.n, 0, 1))
        self._run(planned, [drv], BatchedPlaintextDriver, sched,
                  InprocTransport(1))
        return dict(drv.outputs)

    def _execute_ckks(self, planned: Program, sched
                      ) -> dict[int, np.ndarray]:
        """One engine over a one-party transport.  Key generation (the
        driver's context) counts in ``execute_s``, as it runs inside the
        reference's execute too; ``keygen_s`` is its share."""
        dev = self.device
        transport = InprocTransport(1)
        t0 = time.perf_counter()
        drv = CkksDriver(self.ckks_params(),
                         self.workload.inputs(self.spec.n, 0, 1,
                                              **self._extra()),
                         seed=CKKS_SEED, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings["keygen_s"] = time.perf_counter() - t0
        self._run(planned, [drv], BatchedCkksDriver, sched, transport)
        self.timings["execute_s"] += self.timings["keygen_s"]
        self.ckks_counts = dict(drv.ctx.counts)
        self.op_counts = {op.name: k for op, k in drv.op_counts.items()}
        return dict(drv.outputs)
