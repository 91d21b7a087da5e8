"""The port's facade: a ``JobSpec`` and a staged ``Session``, the
counterpart of ``repro.api`` for the paths the port runs:

    trace() → plan() → execute(real=True, check=...)

``execute`` dispatches on the workload's protocol.  Every party runs
``num_workers`` engines, all threads of this process on one device over
one in-process transport of ``parties * num_workers`` endpoints (global
rank ``party * num_workers + worker``).  Workers of a party exchange
values through NET_* directives over their worker links (each engine has
a ``PartyView`` of its party's ranks).  A garbled-circuit job runs two
parties: garbler worker k streams its tables to evaluator worker k over
their own party link, and every AND gate goes through the half-gates
kernels.  With ``real=False`` it runs one party with the plaintext
oracle driver (the JAX package's ``gc-plaintext``) instead.  A CKKS job
runs one party whose transforms and products go through the NTT kernels.
The device is the card unless the caller passes ``device="cpu"``;
without a card and without that, the Session raises.

The knobs are the JAX package's, with its names and values: ``plan_mode``
"memory" (planned paging at a budget) or "unbounded" (the baseline: the
traced program over the whole virtual address space); ``policy`` (MIN,
MinClean, LRU, FIFO) and ``swap_bypass``; ``exec_backend`` "batched" (a
batch schedule, the port's default), "scalar" (one instruction at a
time; the reference's default) or "overlap" (an overlap schedule: NET
sends hoisted, receives posted early and completed where needed);
``storage`` "ram" (pinned host pages) or "memmap" (a swap file);
``num_workers`` and ``parallel_plan`` (serial, thread or process
planning of the workers' programs).  The streaming planner waits for a
later slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from .core.bytecode import Program
from .core.engine import Engine, EngineStats, swapped_pages
from .core.liveness import stripped_touches, working_set_pages
from .core.planner import PlanConfig, PlanReport, plan
from .core.replacement import POLICIES
from .core.storage import MemmapStorage, PinnedStorage
from .core.transport import InprocTransport, LinkStats, PartyView
from .core.workers import PARALLEL_MODES, EngineJob, plan_workers, \
    run_engines
from .exec.batched_ckks import BatchedCkksDriver
from .exec.batched_gc import BatchedGCDriver, BatchedPlaintextDriver
from .exec.batching import build_batch_schedule
from .exec.overlap import build_overlap_schedule
from .kernels import resolve_device
from .protocols.ckks.driver import CkksDriver
from .protocols.ckks.params import CkksParams
from .protocols.garbled.driver import (EvaluatorDriver, GarblerDriver,
                                       PlaintextDriver)
from .protocols.garbled.gates import GateCounts, PartyChannel
from .workloads import Workload, get
from .workloads.ckks_workloads import PARAMS as DEFAULT_CKKS

#: the garbler's label seed, as in the JAX package's two-party Session;
#: every garbler worker draws from it, so all hold the same R and the
#: labels one sends a sibling stay valid there
GARBLER_SEED = 7
#: the CKKS driver's key and noise seed, as in the JAX package's Session;
#: every CKKS worker uses it, so all hold the same keys and their partial
#: sums add
CKKS_SEED = 0xCEC5
#: the largest |output - oracle| a CKKS job may show (the JAX package's)
CKKS_ATOL = 2e-2

#: the JAX package's plan modes and execution backends; those not ported
#: yet name the ROADMAP item that ports them
PLAN_MODES = ("memory", "streaming", "unbounded")
EXEC_BACKENDS = ("scalar", "batched", "overlap")
NOT_PORTED = {"streaming": "the streaming planner (ROADMAP Queue 1 item 6)"}

#: swap storages by the JAX package's names; "ram" is pinned host memory
STORAGES = {"ram": PinnedStorage, "memmap": MemmapStorage}


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One trace→plan→execute job.

    ``memory_budget`` is the paper's T: an ``int`` is an absolute frame
    count; a ``float`` in (0, 1] is a fraction of the working set, resolved
    with the JAX package's clamping (at least ``8 + prefetch_pages``
    frames, below the working set so there is real memory pressure, the
    prefetch buffer at most a quarter of the budget), per worker against
    that worker's own working set.  ``None`` requires
    ``plan_mode="unbounded"``, which takes no budget."""
    workload: str
    n: int | None = None                  # records per party (None: default)
    num_workers: int = 1                  # engines per party
    memory_budget: int | float | None = None
    lookahead: int = 10_000               # plan knobs (paper l, B, policy)
    prefetch_pages: int = 0
    policy: str = "min"
    swap_bypass: bool = False
    plan_mode: str = "memory"             # memory | unbounded
    parallel_plan: bool | str = "serial"  # serial | thread | process
    exec_backend: str = "batched"         # batched | scalar | overlap
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
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be at least 1, got "
                             f"{self.num_workers}")
        if {False: "serial", True: "thread"}.get(
                self.parallel_plan, self.parallel_plan) not in PARALLEL_MODES:
            raise ValueError(f"parallel_plan must be one of "
                             f"{PARALLEL_MODES}, got {self.parallel_plan!r}")

    def normalized(self, workload: Workload) -> "JobSpec":
        return self if self.n is not None else \
            dataclasses.replace(self, n=workload.default_n)


def resolve_plan_config(spec: JobSpec, working_set: int) -> PlanConfig:
    """Turn a spec's budget into a concrete PlanConfig for one worker of
    ``working_set`` pages."""
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

    After ``execute()``: ``engines`` by global rank (each holding its final
    ``memory``), their ``engine_stats`` and (closed) ``storages``,
    ``timings`` (``trace_s``, ``plan_s``, ``batch_schedule_s`` or
    ``overlap_schedule_s``, ``execute_s``), ``transport_stats`` (sent
    traffic per (src rank, dst rank, tag): worker links and party links)
    and the protocol's records.  Garbled circuits run for real:
    ``gate_counts`` (garbler, evaluator; each summed over the party's
    workers) and, with ``digest=True``, ``table_digests``, one SHA-256 of
    the garbled-table stream per party link (garbler rank, evaluator
    rank), and ``table_digest``, that of the one link or, with several,
    of their digests in rank order; in the clear, one party.
    ``workload`` overrides the registry's (the JAX package's runner
    passes one with other CKKS parameters).  CKKS: ``ckks_counts``, the
    rows of the transforms and modular products the job asked for
    (``ntt_forward``, ``ntt_inverse``, ``mul_mod``; key generation
    included), and ``op_counts``, its instructions by opcode, each summed
    over the workers."""

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
        self._ws: dict[int, int] = {}
        self.configs: list[PlanConfig] = []
        self.plan_reports: list[PlanReport] = []
        self.engines: list[Engine] = []
        self.engine_stats: list[EngineStats] = []
        self.storages: list = []
        self.gate_counts: list[GateCounts] = []
        self.transport_stats: dict[tuple[int, int, int], LinkStats] = {}
        self.timings: dict[str, float] = {}
        self.table_digests: dict[tuple[int, int], str] = {}
        self.table_digest: str | None = None
        self.ckks_counts: dict[str, int] = {}
        self.op_counts: dict[str, int] = {}

    @property
    def protocol(self) -> str:
        return self.workload.protocol

    @property
    def config(self) -> PlanConfig | None:
        """Worker 0's plan config (None before planning or unbounded)."""
        return self.configs[0] if self.configs else None

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
        """Trace the workload's DSL program, one per worker (placement,
        §6.1)."""
        if self._progs is None:
            t0 = time.perf_counter()
            self._progs = self.workload.trace(self.spec.n,
                                              self.spec.num_workers,
                                              **self._extra())
            self.timings["trace_s"] = time.perf_counter() - t0
        return self._progs

    def working_set(self, worker: int = 0) -> int:
        """Peak live pages of one worker's virtual trace (w of §2.4.3)."""
        if worker not in self._ws:
            prog = self.trace()[worker]
            self._ws[worker] = working_set_pages(stripped_touches(prog)[1])
        return self._ws[worker]

    def plan(self) -> list[Program]:
        """Replacement + scheduling of each worker's program under the
        spec's budget, resolved against that worker's working set (§6.1),
        serially, in threads or in processes (``parallel_plan``).  An
        unbounded job's "plan" is the traced programs themselves, with
        empty reports and no configs."""
        if self._planned is None:
            progs = self.trace()
            if self.spec.plan_mode == "unbounded":
                self._planned = list(progs)
                self.plan_reports = [PlanReport() for _ in progs]
                return self._planned
            t0 = time.perf_counter()
            self.configs = [resolve_plan_config(self.spec,
                                                self.working_set(w))
                            for w in range(len(progs))]
            self._planned, self.plan_reports = plan_workers(
                progs, self.configs, parallel=self.spec.parallel_plan)
            self.timings["plan_s"] = time.perf_counter() - t0
        return self._planned

    def adopt_plan(self, programs: list[Program]) -> None:
        """Execute these memory programs, one per worker, instead of
        planning (e.g. the JAX package's plan, carried over by
        ``interop.program_from_records``)."""
        if len(programs) != self.spec.num_workers or \
                any(p.phase != "memory" for p in programs):
            raise ValueError(f"expected {self.spec.num_workers} "
                             f"memory-phase programs, one per worker")
        self._planned = list(programs)

    def execute(self, real: bool = True, check: bool = False,
                digest: bool = False) -> dict[int, np.ndarray]:
        """Run the plan; returns the merged ``tag -> value`` outputs of
        every driver that has them (checked against the oracle with
        ``check``).  Garbled circuits run with real two-party crypto, or in
        the clear with ``real=False`` (the plaintext oracle driver);
        ``digest`` hashes the garbled-table stream of each party link,
        which copies every table to the host.  CKKS is real crypto either
        way."""
        if digest and not (real and self.protocol == "gc"):
            raise ValueError("digest=True hashes garbled tables: it needs a "
                             "garbled-circuit job with real=True")
        planned = self.plan()
        scheds = oscheds = None
        t0 = time.perf_counter()
        if self.spec.exec_backend == "batched":
            scheds = [build_batch_schedule(p) for p in planned]
            self.timings["batch_schedule_s"] = time.perf_counter() - t0
        elif self.spec.exec_backend == "overlap":
            oscheds = [build_overlap_schedule(p) for p in planned]
            self.timings["overlap_schedule_s"] = time.perf_counter() - t0
        if self.protocol == "ckks":
            outputs = self._execute_ckks(planned, scheds, oscheds)
        elif real:
            outputs = self._execute_gc(planned, scheds, oscheds, digest)
        else:
            outputs = self._execute_plaintext(planned, scheds, oscheds)
        if check:
            check_outputs(self.workload, self.spec.n, outputs,
                          **self._extra())
        return outputs

    def _run(self, progs: list[Program], drivers: list, batched_cls,
             scheds, oscheds, transport: InprocTransport) -> None:
        """Run one engine per driver over ``transport``: the driver of
        global rank ``party * p + worker`` is ``drivers[rank]`` and runs
        ``progs[worker]`` with a ``PartyView`` of its party's ranks.  A
        driver goes through ``batched_cls(driver)`` when there is a batch
        or an overlap schedule (the overlap loop batches its local groups
        through it), and runs as it is on the scalar loop.  Each engine
        gets a fresh storage of the spec's kind for the pages its program
        writes out; the storages are built inside the execute time and
        closed at its end, also when a run fails."""
        p = self.spec.num_workers
        wrap = scheds is not None or oscheds is not None
        t0 = time.perf_counter()
        try:
            jobs = []
            for rank, drv in enumerate(drivers):
                party, wk = divmod(rank, p)
                prog = progs[wk]
                storage = STORAGES[self.spec.storage](
                    swapped_pages(prog), (prog.page_slots, drv.lane),
                    drv.dtype, self.device)
                self.storages.append(storage)
                jobs.append(EngineJob(
                    prog, batched_cls(drv) if wrap else drv, self.device,
                    storage, scheds[wk] if scheds else None,
                    tag=f"party{party}/worker{wk}",
                    net=PartyView(transport, party * p, p),
                    overlap_schedule=oscheds[wk] if oscheds else None))
            self.engines = run_engines(jobs, transport)
            self.engine_stats = [e.stats for e in self.engines]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            transport.close()
            for storage in self.storages:
                storage.close()
        self.timings["execute_s"] = time.perf_counter() - t0
        self.transport_stats = transport.stats()

    def _execute_gc(self, planned: list[Program], scheds, oscheds,
                    digest: bool) -> dict[int, np.ndarray]:
        """Two parties of p workers: garbler worker k is rank k, evaluator
        worker k rank p + k, and each pair has its own party link."""
        dev = self.device
        w, n, p = self.workload, self.spec.n, self.spec.num_workers
        transport = InprocTransport(2 * p)
        chans = [PartyChannel(transport, src=k, dst=p + k, digest=digest)
                 for k in range(p)]
        gds = [GarblerDriver(chans[k], dev, w.inputs(n, k, p),
                             seed=GARBLER_SEED) for k in range(p)]
        eds = [EvaluatorDriver(chans[k], dev, w.inputs(n, k, p))
               for k in range(p)]
        self._run(planned, gds + eds, BatchedGCDriver, scheds, oscheds,
                  transport)
        self.gate_counts = [_sum_counts(d.gates.counts for d in ds)
                            for ds in (gds, eds)]
        if digest:
            self.table_digests = {(c.src, c.dst): c.table_digest()
                                  for c in chans}
            self.table_digest = chans[0].table_digest() if p == 1 else \
                hashlib.sha256("".join(self.table_digests[c.src, c.dst]
                                       for c in chans).encode()).hexdigest()
        return _merged(eds)

    def _execute_plaintext(self, planned: list[Program], scheds, oscheds
                           ) -> dict[int, np.ndarray]:
        """One party of p engines, in the clear."""
        w, n, p = self.workload, self.spec.n, self.spec.num_workers
        drvs = [PlaintextDriver(w.inputs(n, k, p)) for k in range(p)]
        self._run(planned, drvs, BatchedPlaintextDriver, scheds, oscheds,
                  InprocTransport(p))
        return _merged(drvs)

    def _execute_ckks(self, planned: list[Program], scheds, oscheds
                      ) -> dict[int, np.ndarray]:
        """One party of p engines.  Key generation (each driver's context)
        counts in ``execute_s``, as it runs inside the reference's execute
        too; ``keygen_s`` is its share."""
        dev = self.device
        w, n, p = self.workload, self.spec.n, self.spec.num_workers
        t0 = time.perf_counter()
        drvs = [CkksDriver(self.ckks_params(),
                           w.inputs(n, k, p, **self._extra()),
                           seed=CKKS_SEED, device=dev) for k in range(p)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.timings["keygen_s"] = time.perf_counter() - t0
        self._run(planned, drvs, BatchedCkksDriver, scheds, oscheds,
                  InprocTransport(p))
        self.timings["execute_s"] += self.timings["keygen_s"]
        self.ckks_counts, self.op_counts = {}, {}
        for d in drvs:
            for k, v in d.ctx.counts.items():
                self.ckks_counts[k] = self.ckks_counts.get(k, 0) + v
            for op, v in d.op_counts.items():
                self.op_counts[op.name] = self.op_counts.get(op.name, 0) + v
        return _merged(drvs)


def _sum_counts(counts) -> GateCounts:
    total = GateCounts()
    for c in counts:
        total.ands += c.ands
        total.xors += c.xors
        total.consts += c.consts
    return total


def _merged(drivers) -> dict[int, np.ndarray]:
    """The outputs of every driver that has them, in rank order."""
    out: dict[int, np.ndarray] = {}
    for d in drivers:
        out.update(d.outputs)
    return out
