"""The port's facade: a ``JobSpec`` and a staged ``Session``, the
counterpart of ``repro.api`` for the paths the port runs:

    trace() → plan() → execute(real=True, check=...)
                     → simulate(cost_fn, model=...)

Every party runs ``num_workers`` engines over one transport fabric of
``parties * num_workers`` endpoints (global rank ``party * num_workers +
worker``), built from the spec's ``transport`` and ``fabric``
(``core.transport``): by default every engine is a thread of this
process on one device over the ``inproc`` backend; ``tcp``, ``shaped``
and ``shaped+tcp`` carry the same traffic over sockets or shaped links,
and ``fabric.rank=k`` hosts exactly one engine, which reaches the others
at ``fabric.peers`` (``python -m repro_torch run JOBDIR --worker k``, one
process a rank).  Workers of a party exchange values through NET_*
directives over their worker links (each engine has a ``PartyView`` of
its party's ranks).  Drivers come from a registry keyed by name: a
garbled-circuit job runs ``gc-2party`` (two parties: garbler worker k
streams its tables to evaluator worker k over their own party link, and
every AND gate goes through the half-gates kernels) or, with
``real=False``, ``gc-plaintext`` (one party in the clear, the JAX
package's oracle driver); a CKKS job runs ``ckks`` (one party whose
transforms and products go through the NTT kernels); a Shamir job runs
``shamir`` (or ``shamir-3party`` / ``shamir-5party``, which check the
party count): its n parties are the n workers of one party, and every
resharing round is ordinary NET_* traffic over their worker links.  A
factory builds drivers for the ranks this process hosts only.  The
device is the card unless the caller passes ``device="cpu"``; without a
card and without that, the Session raises.

Plans are saved to a directory (``save_plan``: ``workerK.memory.bc``
program files and a ``job.json`` manifest, in the JAX package's format)
and loaded for execution (``Session.from_plan``), here or as one rank of
a fleet.  The spec's plan hash (``JobSpec.plan_hash``, the reference's
digest) is stamped into every program's ``meta``, so a stale or tampered
plan raises :class:`SpecMismatchError` instead of running.

The knobs are the JAX package's, with its names and values: ``plan_mode``
"memory" (planned paging at a budget, in memory), "streaming" (the same
plan made out of core, file to file: each worker's memory program is a
``ProgramFile`` in ``workdir`` or in a temporary directory the Session
owns and removes on ``close``, and the engine runs it from disk) or
"unbounded" (the baseline: the traced program over the whole virtual
address space); ``track_plan_memory`` (the planner's peak, by tracemalloc); ``policy`` (MIN,
MinClean, LRU, FIFO) and ``swap_bypass``; ``exec_backend`` "batched" (a
batch schedule, the port's default), "scalar" (one instruction at a
time; the reference's default) or "overlap" (an overlap schedule: NET
sends hoisted, receives posted early and completed where needed);
``storage`` "ram" (pinned host pages) or "memmap" (a swap file);
``num_workers`` and ``parallel_plan`` (serial, thread or process
planning of the workers' programs).

``Session.simulate`` replays the paper's three §8.2 scenarios (unbounded,
OS swapping, MAGE) over a planned job with the timing simulator
(``core.simulator``): host work whose seconds are outputs of the cost and
storage models, not times taken on any device.

A memory program is a deterministic function of the spec, so a Session
with an artifact cache (``Session(spec, cache=...)``: a
``serve_daemon.ArtifactCache`` or a cache root) serves a repeated job
shape from validated files on disk: the traced programs and their
next-use sidecars by ``JobSpec.trace_hash`` (shared by every budget of
one shape), the memory programs and the batch and overlap schedules by
``JobSpec.plan_hash``.  ``cache_events`` says what each stage did.  The
entries are the JAX package's, so either package hits the other's.
``estimate_job_resources`` sizes a job (frames, bytes) for the serve
daemon's admission controller.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from .core.bytecode import (RECORD_BYTES, Program, ProgramFile,
                            write_program, writer_like)
from .core.engine import Engine, EngineStats, ProtocolDriver, swapped_pages
from .core.liveness import working_set_pages_stream
from .core.planner import PlanConfig, PlanReport, plan_memory_estimate
from .core.replacement import POLICIES
from .core.simulator import (DeviceModel, SimResult, simulate_memory_program,
                             simulate_os_paging, simulate_unbounded)
from .core.storage import MemmapStorage, PinnedStorage
from .core.transport import (TRANSPORTS, Fabric, FabricSpec, LinkStats,
                             build_fabric)
from .core.workers import PARALLEL_MODES, EngineJob, plan_workers, \
    run_engines
from .exec.batched_ckks import BatchedCkksDriver
from .exec.batched_gc import BatchedGCDriver, BatchedPlaintextDriver
from .exec.batched_shamir import BatchedShamirDriver
from .exec.batching import build_batch_schedule
from .exec.overlap import build_overlap_schedule
from .kernels import resolve_device
from .protocols.ckks.driver import CkksDriver
from .protocols.ckks.params import CkksParams
from .protocols.garbled.driver import (EvaluatorDriver, GarblerDriver,
                                       PlaintextDriver)
from .protocols.garbled.gates import GateCounts, PartyChannel
from .protocols.shamir.driver import ShamirDriver
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

#: the JAX package's plan modes and execution backends; a knob value not
#: ported yet would name here the ROADMAP item that ports it
PLAN_MODES = ("memory", "streaming", "unbounded")
EXEC_BACKENDS = ("scalar", "batched", "overlap")
NOT_PORTED: dict[str, str] = {}

#: swap storages by the JAX package's names; "ram" is pinned host memory
STORAGES = {"ram": PinnedStorage, "memmap": MemmapStorage}

#: version stamped into every machine-readable output (``--json`` files)
SCHEMA_VERSION = 1
#: bytes per address-space slot, per protocol (the JAX package's): a GC
#: slot is one 128-bit wire label, a CKKS or Shamir slot one 8-byte word;
#: what the timing simulator and the OS-paging baseline charge per page
SLOT_BYTES = {"gc": 16, "ckks": 8, "shamir": 8}
#: a saved plan's manifest, beside its ``workerK.memory.bc`` files
JOB_FILE = "job.json"
#: the JobSpec fields that determine the planned memory program (the JAX
#: package's): execution details (driver, backend, storage, transport,
#: placement, parallelism, plan_mode) are left out, so one plan runs
#: under all of them
PLAN_HASH_FIELDS = ("workload", "n", "num_workers", "memory_budget",
                    "lookahead", "prefetch_pages", "policy", "swap_bypass",
                    "ckks_ring", "ckks_levels")
#: the subset of PLAN_HASH_FIELDS that determines the traced bytecode (the
#: JAX package's): a trace is a pure function of the workload's shape, so
#: one cached trace and its next-use sidecar serve every budget, lookahead
#: and policy of that shape (``JobSpec.trace_hash``)
TRACE_HASH_FIELDS = ("workload", "n", "num_workers", "ckks_ring",
                     "ckks_levels")
#: JobSpec fields of the JAX package that leave its results as they are:
#: which of two cores giving the same results plans and simulates, and the
#: records a chunk its file stages take.  A manifest it wrote carries them,
#: and the port reads and ignores them: it plans with the record-array core
#: (``PlanConfig.core``; the scalar one for a custom eviction policy), in
#: chunks of ``DEFAULT_CHUNK_INSTRS``
REFERENCE_ONLY_FIELDS = ("plan_core", "sim_core", "chunk_instrs")


class SpecMismatchError(ValueError):
    """A plan artifact does not match the spec that claims it."""


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One trace→plan→execute job.

    ``memory_budget`` is the paper's T: an ``int`` is an absolute frame
    count; a ``float`` in (0, 1] is a fraction of the working set, resolved
    with the JAX package's clamping (at least ``8 + prefetch_pages``
    frames, below the working set so there is real memory pressure, the
    prefetch buffer at most a quarter of the budget), per worker against
    that worker's own working set.  ``None`` requires
    ``plan_mode="unbounded"``, which takes no budget.  ``driver`` names a
    registered driver ("auto": ``gc-plaintext``, ``ckks`` or ``shamir`` by
    the workload's protocol); ``transport`` and ``fabric`` pick the backend
    and place the endpoints (``core.transport.FabricSpec``).  None of the
    three is part of the plan hash."""
    workload: str
    n: int | None = None                  # records per party (None: default)
    num_workers: int = 1                  # engines per party
    memory_budget: int | float | None = None
    lookahead: int = 10_000               # plan knobs (paper l, B, policy)
    prefetch_pages: int = 0
    policy: str = "min"
    swap_bypass: bool = False
    plan_mode: str = "memory"             # memory | streaming | unbounded
    parallel_plan: bool | str = "serial"  # serial | thread | process
    driver: str = "auto"                  # auto -> the protocol's default
    exec_backend: str = "batched"         # batched | scalar | overlap
    storage: str = "ram"                  # ram | memmap
    transport: str = "inproc"             # inproc | tcp | shaped | shaped+tcp
    fabric: FabricSpec | None = None      # endpoint placement, shaping
    workdir: str | None = None            # streaming plan files live here
    track_plan_memory: bool = False
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
        if isinstance(self.fabric, dict):      # from_dict / JSON round trip
            object.__setattr__(self, "fabric", FabricSpec(**self.fabric))

    def normalized(self, workload: Workload | None = None) -> "JobSpec":
        """Fill the workload's defaults in: ``n`` and the driver."""
        w = workload if workload is not None else get(self.workload)
        changes = {}
        if self.n is None:
            changes["n"] = w.default_n
        if self.driver == "auto":
            changes["driver"] = {"ckks": "ckks", "shamir": "shamir"}.get(
                w.protocol, "gc-plaintext")
        return dataclasses.replace(self, **changes) if changes else self

    def plan_hash(self, workload: Workload | None = None) -> str:
        """Digest of the plan-determining fields (``PLAN_HASH_FIELDS``),
        canonicalized as the JAX package does, so both give one digest."""
        return self._hash(PLAN_HASH_FIELDS, workload)

    def trace_hash(self, workload: Workload | None = None) -> str:
        """Digest of the trace-determining fields (``TRACE_HASH_FIELDS``),
        the JAX package's digest."""
        return self._hash(TRACE_HASH_FIELDS, workload)

    def _hash(self, fields: tuple[str, ...],
              workload: Workload | None) -> str:
        spec = self.normalized(workload)
        payload = {k: getattr(spec, k) for k in fields}
        blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        """The inverse of ``to_dict``; also takes the JAX package's
        ``to_dict``, whose ``REFERENCE_ONLY_FIELDS`` are dropped.  Any
        other unknown field raises."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known - set(REFERENCE_ONLY_FIELDS)
        if unknown:
            raise ValueError(f"unknown JobSpec fields: {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in known})


def load_manifest(jobdir: str | os.PathLike) -> tuple[dict, JobSpec]:
    """A saved plan's ``job.json`` and its spec."""
    with open(os.path.join(os.fspath(jobdir), JOB_FILE)) as f:
        manifest = json.load(f)
    return manifest, JobSpec.from_dict(manifest["spec"])


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


def ckks_params(w: Workload, spec: JobSpec) -> CkksParams:
    """The workload's CKKS parameters with the spec's ring and levels (the
    scale and noise parameters stay)."""
    p = w.params.get("ckks_params", DEFAULT_CKKS)
    return dataclasses.replace(p, n_ring=spec.ckks_ring or p.n_ring,
                               levels=spec.ckks_levels or p.levels)


def oracle_extra(w: Workload, spec: JobSpec) -> dict:
    """What the workload's trace, inputs and oracle take beyond n."""
    return {"ckks_params": ckks_params(w, spec)} \
        if w.protocol == "ckks" else {}


def check_outputs(w: Workload, n: int, outputs: dict[int, np.ndarray],
                  atol: float = CKKS_ATOL, **extra) -> None:
    """Compare executed outputs with the workload's numpy oracle: exactly
    for garbled circuits and Shamir, within ``atol`` for CKKS (approximate
    arithmetic).  ``extra`` reaches the oracle (``ckks_params``)."""
    exp = w.oracle(n, **extra)
    missing = set(exp) - set(outputs)
    if missing:
        raise AssertionError(f"{w.name}: missing outputs "
                             f"{sorted(missing)[:5]}...")
    for tag, e in exp.items():
        got = outputs[tag]
        if w.protocol in ("gc", "shamir"):
            if not np.array_equal(got, e):
                raise AssertionError(f"{w.name} tag {tag}: {got[:4]} != "
                                     f"{e[:4]}")
        else:
            err = np.max(np.abs(np.asarray(got) - e))
            if not err < atol:
                raise AssertionError(f"{w.name} tag {tag}: err {err}")


# ---------------------------------------------------------------------------
# the driver registry
# ---------------------------------------------------------------------------

#: a factory builds the drivers of the ranks THIS process hosts:
#: ``factory(session, fabric, digest) -> {global rank: driver}`` for
#: ``fabric.hosted`` only, so a single-rank process builds its own driver
DriverFactory = Callable[["Session", Fabric, bool],
                         dict[int, ProtocolDriver]]


@dataclasses.dataclass(frozen=True)
class DriverDef:
    factory: DriverFactory
    parties: int = 1
    #: the batched driver a batch or overlap schedule wraps it in
    batched: Callable[[ProtocolDriver], ProtocolDriver] | None = None


DRIVERS: dict[str, DriverDef] = {}


def register_driver(name: str, factory: DriverFactory, parties: int = 1,
                    batched=None) -> None:
    DRIVERS[name] = DriverDef(factory, parties, batched)


def _driver_def(name: str) -> DriverDef:
    try:
        return DRIVERS[name]
    except KeyError:
        raise KeyError(f"unknown driver {name!r}; registered: "
                       f"{sorted(DRIVERS)}") from None


def driver_parties(name: str) -> int:
    """Parties (rank blocks) a registered driver deploys."""
    return _driver_def(name).parties


def list_transports() -> list[str]:
    """Registered transport backends (``JobSpec.transport`` values)."""
    return sorted(TRANSPORTS)


def _gc_plaintext_drivers(s: "Session", fx: Fabric, digest: bool
                          ) -> dict[int, ProtocolDriver]:
    w, n, p = s.workload, s.spec.n, s.spec.num_workers
    return {r: PlaintextDriver(w.inputs(n, r % p, p)) for r in fx.hosted}


def _gc_two_party_drivers(s: "Session", fx: Fabric, digest: bool
                          ) -> dict[int, ProtocolDriver]:
    """Garbler worker k is rank k, evaluator worker k rank p + k, and each
    pair has its own party link (the one-to-one topology of Fig. 3)."""
    w, n, p = s.workload, s.spec.n, s.spec.num_workers
    out: dict[int, ProtocolDriver] = {}
    for r in fx.hosted:
        party, wk = divmod(r, p)
        chan = PartyChannel(fx.transport_for(r), src=wk, dst=p + wk,
                            digest=digest)
        out[r] = GarblerDriver(chan, s.device, w.inputs(n, wk, p),
                               seed=GARBLER_SEED) if party == 0 else \
            EvaluatorDriver(chan, s.device, w.inputs(n, wk, p))
    return out


def _ckks_drivers(s: "Session", fx: Fabric, digest: bool
                  ) -> dict[int, ProtocolDriver]:
    w, n, p = s.workload, s.spec.n, s.spec.num_workers
    return {r: CkksDriver(s.ckks_params(),
                          w.inputs(n, r % p, p, **s._extra()),
                          seed=CKKS_SEED, device=s.device)
            for r in fx.hosted}


def _shamir_drivers(s: "Session", fx: Fabric, digest: bool
                    ) -> dict[int, ProtocolDriver]:
    """The n Shamir parties ARE the n workers of one registry party: worker
    rank == party index, and each multiplication's resharing round rides
    the all-to-all worker links as ordinary NET_* directives."""
    w, n, p = s.workload, s.spec.n, s.spec.num_workers
    return {r: ShamirDriver(p, r % p, w.inputs(n, r % p, p))
            for r in fx.hosted}


def _shamir_fixed(n_parties: int) -> DriverFactory:
    def factory(s: "Session", fx: Fabric, digest: bool
                ) -> dict[int, ProtocolDriver]:
        if s.spec.num_workers != n_parties:
            raise ValueError(
                f"driver shamir-{n_parties}party needs num_workers="
                f"{n_parties}, got {s.spec.num_workers}")
        return _shamir_drivers(s, fx, digest)
    return factory


register_driver("gc-plaintext", _gc_plaintext_drivers,
                batched=BatchedPlaintextDriver)
register_driver("gc-2party", _gc_two_party_drivers, parties=2,
                batched=BatchedGCDriver)
register_driver("ckks", _ckks_drivers, batched=BatchedCkksDriver)
register_driver("shamir", _shamir_drivers, batched=BatchedShamirDriver)
register_driver("shamir-3party", _shamir_fixed(3),
                batched=BatchedShamirDriver)
register_driver("shamir-5party", _shamir_fixed(5),
                batched=BatchedShamirDriver)


@dataclasses.dataclass
class WorkerScenarios:
    """Per-worker §8.2 scenario timings (model outputs) + plan metadata."""
    unbounded: SimResult
    os: SimResult
    mage: SimResult
    report: PlanReport
    config: PlanConfig
    working_set_pages: int
    page_bytes: int
    instructions: int
    program_bytes: int                   # memory program size (file or est.)


class Session:
    """Staged trace→plan→execute over one JobSpec on one device.

    After ``execute()``, over the ranks this process hosts (``hosted``,
    global ranks) and the driver they ran (``driver_name``): ``engines``
    in rank order (each holding its final ``memory``), their
    ``engine_stats`` and (closed) ``storages``, ``timings`` (``trace_s``,
    ``plan_s``, ``batch_schedule_s`` or ``overlap_schedule_s``,
    ``connect_s``, ``execute_s``, and for a distributed rank
    ``barrier_s``), ``transport_stats`` (traffic the hosted ranks sent,
    per (src rank, dst rank, tag): worker links and party links) and the
    protocol's records.  Garbled circuits: ``gate_counts`` (garbler,
    evaluator; each summed over the party's hosted workers) and, with
    ``digest=True``, ``table_digests``, one SHA-256 of the garbled-table
    stream per hosted garbler's party link (garbler rank, evaluator
    rank), and ``table_digest``, that of the one link or, with several,
    of their digests in rank order (None unless every garbler is
    hosted).  ``workload`` overrides the registry's (the JAX package's
    runner passes one with other CKKS parameters).  CKKS:
    ``ckks_counts``, the rows of the transforms and modular products the
    job asked for (``ntt_forward``, ``ntt_inverse``, ``mul_mod``; key
    generation included), and ``op_counts``, its instructions by opcode,
    each summed over the hosted workers.

    A streaming plan with no ``workdir`` lives in a temporary directory
    the Session owns: use the Session as a context manager (or call
    :meth:`close`) to remove it, or :meth:`save_plan` to move the
    program files somewhere durable."""

    def __init__(self, spec: JobSpec, device: str | torch.device | None = None,
                 workload: Workload | None = None, cache=None):
        if workload is not None and workload.name != spec.workload:
            raise ValueError(f"workload object {workload.name!r} does not "
                             f"match spec.workload {spec.workload!r}")
        self.device = resolve_device(device)
        self.workload = workload or get(spec.workload)
        self.spec = spec.normalized(self.workload)
        self._progs: list[Program | ProgramFile] | None = None
        self._planned: list[Program | ProgramFile] | None = None
        self._ws: dict[int, int] = {}
        self._tmpdir: str | None = None
        self._cache = None
        self._plan_probed = False
        self._trace_anns: list[str] | None = None
        #: what each stage of THIS session got from the cache: {"trace" |
        #: "plan" | "batch" | "overlap": "hit" | "miss"}; a stage that did
        #: not consult it is absent
        self.cache_events: dict[str, str] = {}
        if cache is not None:
            self.set_cache(cache)
        self.configs: list[PlanConfig] = []
        self.plan_reports: list[PlanReport] = []
        self.hosted: list[int] = []
        self.driver_name: str | None = None
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

    def set_cache(self, cache) -> None:
        """Attach an artifact cache (an ``ArtifactCache`` or a root path)."""
        from .serve_daemon.cache import ArtifactCache
        if not isinstance(cache, ArtifactCache):
            cache = ArtifactCache(cache)
        self._cache = cache

    @property
    def cache(self):
        """The attached ArtifactCache, or None."""
        return self._cache

    def _usable_cache(self):
        """The cache, unless the workload object is not the registry's: a
        custom workload's trace is not a function of its name."""
        if self._cache is None:
            return None
        try:
            registered = get(self.spec.workload)
        except KeyError:
            return None
        return self._cache if self.workload is registered else None

    def close(self) -> None:
        """Remove the temporary directory of a streaming plan, if any."""
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def protocol(self) -> str:
        return self.workload.protocol

    @property
    def config(self) -> PlanConfig | None:
        """Worker 0's plan config (None before planning, unbounded or
        loaded from a saved plan)."""
        return self.configs[0] if self.configs else None

    def ckks_params(self) -> CkksParams:
        """The workload's CKKS parameters with the spec's ring and levels
        (the scale and noise parameters stay)."""
        return ckks_params(self.workload, self.spec)

    def _extra(self) -> dict:
        return oracle_extra(self.workload, self.spec)

    def trace(self, cache_dir=None) -> list[Program | ProgramFile]:
        """Trace the workload's DSL program, one per worker (placement,
        §6.1); the spec's plan hash and the spec are stamped into every
        program's ``meta``, so the plans made from them carry both.

        With a cache (``cache_dir`` here, or ``cache`` at construction), a
        repeated trace shape is served as the cache's FREE-stripped
        program files and next-use sidecars instead of running the DSL; a
        fresh trace fills the cache, and the Session takes the cached
        files, so cold and hot runs plan the same."""
        if cache_dir is not None:
            self.set_cache(cache_dir)
        if self._progs is None:
            t0 = time.perf_counter()
            cache = self._usable_cache()
            got = cache.get_trace(self.spec, self.workload) \
                if cache is not None else None
            if cache is not None:
                self.cache_events["trace"] = "miss" if got is None else "hit"
            if got is None:
                progs = self.workload.trace(self.spec.n,
                                            self.spec.num_workers,
                                            **self._extra())
                if cache is not None:
                    got = cache.put_trace(self.spec, self.workload, progs)
            if got is not None:
                progs, self._trace_anns = list(got[0]), list(got[1])
            h = self.spec.plan_hash(self.workload)
            for prog in progs:
                # a cached file's stamp is its trace hash; the Session's
                # own identity is stamped in memory
                prog.meta["spec_hash"] = h
                prog.meta["job_spec"] = self.spec.to_dict()
            self._progs = progs
            self.timings["trace_s"] = time.perf_counter() - t0
        return self._progs

    def working_set(self, worker: int = 0) -> int:
        """Peak live pages of one worker's virtual trace (w of §2.4.3)."""
        if worker not in self._ws:
            self._ws[worker] = working_set_pages_stream(self.trace()[worker])
        return self._ws[worker]

    def _workdir(self) -> str | None:
        """Where a streaming plan's files go: the spec's ``workdir``, else
        a temporary directory this Session owns."""
        if self.spec.workdir is not None:
            return self.spec.workdir
        if self.spec.plan_mode == "streaming":
            if self._tmpdir is None:
                self._tmpdir = tempfile.mkdtemp(prefix="mage_job_")
            return self._tmpdir
        return None

    def plan(self, cache_dir=None) -> list[Program | ProgramFile]:
        """Replacement + scheduling of each worker's program under the
        spec's budget, resolved against that worker's working set (§6.1),
        serially, in threads or in processes (``parallel_plan``); in
        memory, or out of core with ``plan_mode="streaming"`` (memory
        programs as files, a ``workerK/`` directory each).  An unbounded
        job's "plan" is the traced programs themselves, with empty
        reports and no configs.  ``timings`` gains ``annotate_s`` (the
        streaming planner's next-use pass, summed over the workers) and,
        with ``track_plan_memory``, ``peak_mem_bytes`` (the largest
        worker's).

        With a cache, a repeated plan shape is served from the cache's
        validated memory-program files, with their configs and reports:
        no trace and no planning (``cache_events["plan"] == "hit"``); a
        fresh plan is put in the cache."""
        if cache_dir is not None:
            self.set_cache(cache_dir)
        if self._planned is None:
            if self.spec.plan_mode != "unbounded" and self.plan_if_cached():
                return self._planned
            progs = self.trace()
            if self.spec.plan_mode == "unbounded":
                self._planned = list(progs)
                self.plan_reports = [PlanReport() for _ in progs]
                return self._planned
            t0 = time.perf_counter()
            self.configs = [resolve_plan_config(self.spec,
                                                self.working_set(w))
                            for w in range(len(progs))]
            streaming = self.spec.plan_mode == "streaming"
            if not streaming:
                # the in-memory planner takes Programs; a cached trace is
                # files (small, by definition of the in-memory mode)
                progs = [p.read_program() if isinstance(p, ProgramFile)
                         else p for p in progs]
            self._planned, self.plan_reports = plan_workers(
                progs, self.configs, parallel=self.spec.parallel_plan,
                streaming=streaming,
                workdir=self._workdir() if streaming else None,
                track_memory=self.spec.track_plan_memory,
                annotations=self._trace_anns if streaming else None)
            self.timings["plan_s"] = time.perf_counter() - t0
            self.timings["annotate_s"] = sum(r.annotate_s
                                             for r in self.plan_reports)
            if self.spec.track_plan_memory:
                self.timings["peak_mem_bytes"] = max(
                    r.peak_mem_bytes for r in self.plan_reports)
            cache = self._usable_cache()
            if cache is not None:
                cache.put_plan(self.spec, self.workload, self._planned,
                               self.configs, self.plan_reports)
        return self._planned

    def plan_if_cached(self) -> bool:
        """Probe the cache for this spec's plan (once a Session); on a hit
        take its memory programs, configs and reports and return True.
        The serve daemon sizes admission with it, without planning."""
        if self._planned is not None:
            return True
        cache = self._usable_cache()
        if cache is None or self.spec.plan_mode == "unbounded" or \
                self._plan_probed:
            return False
        self._plan_probed = True
        t0 = time.perf_counter()
        got = cache.get_plan(self.spec, self.workload)
        if got is None:
            self.cache_events["plan"] = "miss"
            return False
        self.cache_events["plan"] = "hit"
        planned, cfgs, reports = got
        self._planned = list(planned)
        self.configs = list(cfgs)
        self.plan_reports = list(reports)
        self.timings["plan_s"] = time.perf_counter() - t0
        return True

    def adopt_plan(self, programs: list[Program | ProgramFile]) -> None:
        """Execute these programs, one per worker, instead of planning
        (the JAX package's plan carried over by
        ``interop.program_from_records``, or a saved plan): memory-phase
        programs, or for an unbounded job the traced, virtual-phase
        ones."""
        phase = "virtual" if self.spec.plan_mode == "unbounded" \
            else "memory"
        if len(programs) != self.spec.num_workers or \
                any(p.phase != phase for p in programs):
            raise ValueError(f"expected {self.spec.num_workers} "
                             f"{phase}-phase programs, one per worker")
        self._planned = list(programs)

    def save_plan(self, outdir: str | os.PathLike) -> str:
        """Write the planned programs (an unbounded job's traced ones) as
        ``workerK.memory.bc`` files and a ``job.json`` manifest to
        ``outdir``, in the JAX package's format; returns the manifest's
        path.  Each program's ``meta`` carries the spec's plan hash and
        the spec itself.  A streaming plan's files are moved there (they
        can be far larger than RAM), and the Session runs them from
        there; in-memory plans are written."""
        outdir = os.fspath(outdir)
        os.makedirs(outdir, exist_ok=True)
        h = self.spec.plan_hash(self.workload)
        names = []
        planned = self.plan()
        cached = self.cache_events.get("plan") == "hit" or (
            self.spec.plan_mode == "unbounded"
            and self.cache_events.get("trace") is not None)
        for i, prog in enumerate(planned):
            name = f"worker{i}.memory.bc"
            dst = os.path.join(outdir, name)
            if isinstance(prog, ProgramFile):
                if os.path.abspath(prog.path) != os.path.abspath(dst):
                    if cached:
                        # a cache's files stay in the cache; the copy
                        # gets this spec's stamp
                        _restamp(prog, dst, h, self.spec.to_dict())
                    else:
                        shutil.move(prog.path, dst)
                        srcdir = os.path.dirname(prog.path)
                        if not os.listdir(srcdir):
                            os.rmdir(srcdir)
                planned[i] = ProgramFile(dst)
            else:
                prog.meta["spec_hash"] = h
                prog.meta["job_spec"] = self.spec.to_dict()
                write_program(prog, dst)
            names.append(name)
        path = os.path.join(outdir, JOB_FILE)
        with open(path, "w") as f:
            json.dump({"format": 1, "spec": self.spec.to_dict(),
                       "spec_hash": h, "programs": names}, f, indent=2)
        return path

    @classmethod
    def from_plan(cls, jobdir: str | os.PathLike, storage: str | None = None,
                  driver: str | None = None, transport: str | None = None,
                  fabric: FabricSpec | None = None,
                  device: str | torch.device | None = None) -> "Session":
        """Load a plan saved by either package for execution, its program
        files run from disk (never read into RAM whole).  The spec's
        hash is recomputed from the manifest and checked against the
        manifest's and every program file's stamp: an edited
        ``job.json``, a swapped plan file or a changed planner raises
        :class:`SpecMismatchError` instead of running a stale plan.
        ``storage``, ``driver``, ``transport`` and ``fabric`` override
        execution details, which the hash leaves out: one plan runs in
        this process or as one rank of a fleet."""
        jobdir = os.fspath(jobdir)
        manifest, spec = load_manifest(jobdir)
        expect = spec.plan_hash()
        if manifest.get("spec_hash") != expect:
            raise SpecMismatchError(
                f"job.json spec hashes to {expect} but the manifest claims "
                f"{manifest.get('spec_hash')}: the spec was modified after "
                f"planning; re-run `plan`")
        overrides = {k: v for k, v in (("storage", storage),
                                       ("driver", driver),
                                       ("transport", transport),
                                       ("fabric", fabric)) if v is not None}
        if overrides:
            spec = dataclasses.replace(spec, **overrides)
        sess = cls(spec, device=device)
        names = manifest["programs"]
        if len(names) != sess.spec.num_workers:
            raise SpecMismatchError(f"{len(names)} program files for "
                                    f"{sess.spec.num_workers} workers")
        planned = []
        for k, name in enumerate(names):
            pf = ProgramFile(os.path.join(jobdir, name))
            got = pf.meta.get("spec_hash")
            if got != expect or pf.worker != k:
                raise SpecMismatchError(
                    f"{name} was planned for spec {got}, worker "
                    f"{pf.worker}; job.json says {expect}, worker {k}: "
                    f"artifact and spec disagree")
            planned.append(pf)
        sess.adopt_plan(planned)
        return sess

    def simulate(self, cost_fn: Callable, model: DeviceModel | None = None,
                 os_page_bytes: int | None = None,
                 slot_bytes: int | None = None,
                 core: str = "array") -> list[WorkerScenarios]:
        """Replay the three §8.2 scenarios (Unbounded / OS swap / MAGE)
        per worker with the given per-instruction cost model: host work,
        whose seconds are model outputs.

        ``core`` picks the simulator core: ``"array"`` (the default)
        replays record chunks through the vectorized cores, pricing whole
        chunks with ``cost_fn.cost_chunk`` when the cost object has one;
        ``"scalar"`` runs the JAX package's per-instruction loops.  The
        results are exactly equal either way."""
        if self.spec.plan_mode == "unbounded":
            raise ValueError("simulate() compares scenarios under a memory "
                             "budget; plan_mode='unbounded' has none")
        planned = self.plan()
        if len(self.configs) != len(planned):
            raise ValueError(
                "simulate() needs the plan configs and reports of an "
                "in-session plan(); a Session loaded with from_plan() can "
                "only execute() its artifacts")
        progs = self.trace()
        sb = slot_bytes if slot_bytes is not None \
            else SLOT_BYTES[self.protocol]
        out = []
        for wk, prog in enumerate(progs):
            page_bytes = prog.page_slots * sb
            cfg = self.configs[wk]
            ub = simulate_unbounded(prog, cost_fn, core=core)
            osr = simulate_os_paging(prog, cost_fn, cfg.num_frames,
                                     page_bytes, model,
                                     os_page_bytes=os_page_bytes, core=core)
            mem = planned[wk]
            mage = simulate_memory_program(mem, cost_fn, page_bytes, model,
                                           core=core)
            nbytes = os.path.getsize(mem.path) \
                if isinstance(mem, ProgramFile) else len(mem) * RECORD_BYTES
            out.append(WorkerScenarios(
                unbounded=ub, os=osr, mage=mage,
                report=self.plan_reports[wk], config=cfg,
                working_set_pages=self.working_set(wk),
                page_bytes=page_bytes, instructions=len(prog),
                program_bytes=nbytes))
        return out

    def _driver_name(self, real: bool | None) -> str:
        if real is None or self.protocol != "gc":
            return self.spec.driver      # CKKS is real crypto either way
        return "gc-2party" if real else "gc-plaintext"

    def execute(self, real: bool | None = True, check: bool = False,
                digest: bool = False) -> dict[int, np.ndarray]:
        """Run the plan on the ranks this process hosts; returns the
        merged ``tag -> value`` outputs of every hosted driver that has
        them (checked against the oracle with ``check``).  Garbled
        circuits run with real two-party crypto, or in the clear with
        ``real=False`` (the plaintext oracle driver); ``real=None`` runs
        the spec's driver.  ``digest`` hashes the garbled-table stream of
        each hosted party link, which copies every table to the host.
        CKKS is real crypto either way.  With ``fabric.rank=k`` only
        rank k runs, the run ends with a barrier across the fleet, and
        ``check`` is refused (the outputs are partial)."""
        name = self._driver_name(real)
        ddef = _driver_def(name)
        self.driver_name = name
        if digest and name != "gc-2party":
            raise ValueError("digest=True hashes garbled tables: it needs a "
                             "garbled-circuit job with real=True")
        p = self.spec.num_workers
        fx = build_fabric(self.spec.transport, ddef.parties * p,
                          self.spec.fabric, device=self.device)
        if check and fx.distributed:
            raise ValueError("check=True needs the full outputs; a "
                             "distributed rank only holds its own (run "
                             "`python -m repro_torch fabric` for a checked "
                             "fleet)")
        planned = self.plan()
        scheds = oscheds = None
        t0 = time.perf_counter()
        if self.spec.exec_backend == "batched":
            scheds = self._schedules("batch", planned)
            self.timings["batch_schedule_s"] = time.perf_counter() - t0
        elif self.spec.exec_backend == "overlap":
            oscheds = self._schedules("overlap", planned)
            self.timings["overlap_schedule_s"] = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            fx.connect()
            self.timings["connect_s"] = time.perf_counter() - t0
            drivers = self._run(planned, ddef, fx, scheds, oscheds, digest)
            if fx.distributed:
                # hold the process until every peer has drained its traffic
                t0 = time.perf_counter()
                fx.barrier()
                self.timings["barrier_s"] = time.perf_counter() - t0
            self.transport_stats = fx.stats()
        finally:
            fx.close()
        self._collect(drivers, name, digest)
        outputs: dict[int, np.ndarray] = {}
        for r in sorted(drivers):
            outputs.update(getattr(drivers[r], "outputs", {}))
        if check:
            check_outputs(self.workload, self.spec.n, outputs,
                          **self._extra())
        return outputs

    def _schedules(self, kind: str, planned: list) -> list:
        """One batch (``kind="batch"``) or overlap schedule a worker's
        program, from the cache when it has them (keyed by the plan hash,
        like the plan they describe).  An unbounded job builds its own:
        ``plan_mode`` is not in the plan hash, and an unbounded "plan" is
        the trace, so its schedules would collide with the memory-mode
        entry of the same spec."""
        build = build_batch_schedule if kind == "batch" \
            else build_overlap_schedule
        cache = self._usable_cache()
        if cache is None or self.spec.plan_mode == "unbounded":
            return [build(prog) for prog in planned]
        get, put = (cache.get_batch, cache.put_batch) if kind == "batch" \
            else (cache.get_overlap, cache.put_overlap)
        got = get(self.spec, self.workload)
        if got is not None and len(got) == len(planned):
            self.cache_events[kind] = "hit"
            return got
        self.cache_events[kind] = "miss"
        scheds = [build(prog) for prog in planned]
        put(self.spec, self.workload, scheds)
        return scheds

    def _run(self, planned: list[Program | ProgramFile], ddef: DriverDef,
             fx: Fabric,
             scheds, oscheds, digest: bool) -> dict[int, ProtocolDriver]:
        """Build the hosted ranks' drivers and run one engine each: rank
        ``party * p + worker`` runs ``planned[worker]`` with a
        ``PartyView`` of its party's ranks.  A driver goes through the
        batched driver when there is a batch or an overlap schedule (the
        overlap loop batches its local groups through it), and runs as it
        is on the scalar loop.  Each engine gets a fresh storage of the
        spec's kind for the pages its program writes out; the storages
        are built inside the execute time and closed at its end, also when
        a run fails.  Key generation (a CKKS driver's context) counts in
        ``execute_s``, as it runs inside the reference's execute too;
        ``keygen_s`` is its share."""
        p = self.spec.num_workers
        wrap = scheds is not None or oscheds is not None
        t0 = time.perf_counter()
        try:
            drivers = ddef.factory(self, fx, digest)
            if self.protocol == "ckks":
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.timings["keygen_s"] = time.perf_counter() - t0
            jobs = []
            for rank in sorted(drivers):
                drv = drivers[rank]
                party, wk = divmod(rank, p)
                prog = planned[wk]
                storage = STORAGES[self.spec.storage](
                    swapped_pages(prog), (prog.page_slots, drv.lane),
                    drv.dtype, self.device)
                self.storages.append(storage)
                jobs.append(EngineJob(
                    prog, ddef.batched(drv) if wrap else drv, self.device,
                    storage, scheds[wk] if scheds else None,
                    tag=f"party{party}/worker{wk}",
                    net=fx.view(rank, party * p, p),
                    overlap_schedule=oscheds[wk] if oscheds else None))
            self.hosted = sorted(drivers)
            self.engines = run_engines(jobs, fx)
            self.engine_stats = [e.stats for e in self.engines]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            for storage in self.storages:
                storage.close()
        self.timings["execute_s"] = time.perf_counter() - t0
        return drivers

    def _collect(self, drivers: dict[int, ProtocolDriver], name: str,
                 digest: bool) -> None:
        """The protocol's records of the hosted drivers."""
        p = self.spec.num_workers
        if name == "gc-2party":
            self.gate_counts = [
                _sum_counts(d.gates.counts for r, d in drivers.items()
                            if r // p == party) for party in (0, 1)]
            chans = [drivers[r].gates.ch for r in sorted(drivers) if r < p]
            if digest:
                self.table_digests = {(c.src, c.dst): c.table_digest()
                                      for c in chans}
                ds = [self.table_digests[k] for k in sorted(
                    self.table_digests)]
                self.table_digest = None if len(ds) < p else ds[0] \
                    if p == 1 else hashlib.sha256(
                        "".join(ds).encode()).hexdigest()
        elif name == "ckks":
            self.ckks_counts, self.op_counts = {}, {}
            for d in drivers.values():
                for k, v in d.ctx.counts.items():
                    self.ckks_counts[k] = self.ckks_counts.get(k, 0) + v
                for op, v in d.op_counts.items():
                    self.op_counts[op.name] = \
                        self.op_counts.get(op.name, 0) + v


def run_job(spec: JobSpec, real: bool | None = True, check: bool = False,
            cache=None, device: str | torch.device | None = None
            ) -> dict[int, np.ndarray]:
    """One shot: trace, plan, execute (through ``cache`` when given), clean
    up; returns the outputs."""
    with Session(spec, device=device, cache=cache) as s:
        return s.execute(real=real, check=check)


def plan(spec: JobSpec, outdir: str | os.PathLike, cache=None,
         device: str | torch.device | None = None) -> str:
    """One shot: trace and plan ``spec`` (through ``cache`` when given) and
    save the plan to ``outdir`` (``python -m repro_torch plan``); returns
    the manifest's path."""
    with Session(spec, device=device, cache=cache) as s:
        return s.save_plan(outdir)


def estimate_job_resources(sess: Session) -> tuple[int, int]:
    """(frames, bytes) one job pins while it plans and runs: what the
    serve daemon's admission controller charges (the JAX package's model).

    Frames are the paper's T summed over the workers: from a cached
    plan's configs when there is one (no trace), from an integer budget
    by arithmetic, else from the traced working sets.  An unbounded job
    keeps its whole working set resident.  Bytes are the engine's frames
    (frames x page bytes x parties, in device memory) plus the planner's
    O(frames) peak estimate when the job will plan."""
    spec = sess.spec
    workers = range(spec.num_workers)
    cfgs: list[PlanConfig] = []
    if spec.plan_mode == "unbounded":
        frames = sum(sess.working_set(i) for i in workers)
    elif sess.plan_if_cached():
        frames = sum(c.num_frames for c in sess.configs)
    else:
        # an integer budget needs no working set, so no trace
        fraction = isinstance(spec.memory_budget, float)
        cfgs = [resolve_plan_config(
            spec, sess.working_set(i) if fraction else 0) for i in workers]
        frames = sum(c.num_frames for c in cfgs)
    page_bytes = (1 << sess.workload.page_shift) * SLOT_BYTES[sess.protocol]
    parties = driver_parties(spec.driver) if spec.driver in DRIVERS else 1
    planner_bytes = sum(plan_memory_estimate(c) for c in cfgs)
    return frames, frames * page_bytes * parties + planner_bytes


def _restamp(prog: ProgramFile, dst: str, spec_hash: str,
             job_spec: dict) -> None:
    """Copy a cache-resident program file to ``dst`` with this spec's
    stamp in its header (a cached trace is stamped with its trace hash)."""
    meta = {**prog.meta, "spec_hash": spec_hash, "job_spec": job_spec}
    with writer_like(prog, dst, meta=meta) as w:
        for _, rec in prog.iter_chunks():
            w.append_records(rec)


def _sum_counts(counts) -> GateCounts:
    total = GateCounts()
    for c in counts:
        total.ands += c.ands
        total.xors += c.xors
        total.consts += c.consts
    return total
