"""Calibrated §8.2 scenario harness: Unbounded / OS Swapping / MAGE (the
port's copy of ``repro.scenarios``).

The storage-device calibration, the protocol cost models with input/output
file streaming, and ``run_workload``: a thin wrapper over
``Session.simulate``, so ``python -m repro_torch bench`` and any figure
share one trace -> plan -> simulate path, the out-of-core streaming
planner included for past-planner-cap trace sizes.

Calibration (the JAX package's): cloud-SSD-class storage (~1 GB/s
streaming, 300 us op latency, deep queue); the OS baseline pays
demand-paging costs at 4 KiB granularity with an effective readahead of 2
(swap-slot fragmentation defeats clustering) and direct-reclaim write
throttling, while MAGE moves its own 64 KiB / 128 KiB pages with planned,
overlapped I/O: the same asymmetry the paper measures on Azure D16d_v4
(its local SSD swap vs MAGE's O_DIRECT aio).  Compute costs come from the
protocols' gate/NTT cost models (GC: ~80 ns per AND garbling; CKKS:
~N log N per NTT).  The scenarios' seconds are outputs of these models,
the same on every host and not times taken on any device; what they
validate are the paper's ratios (MAGE-vs-OS speedups, %-of-Unbounded).
Planning (``plan_s``, ``plan_peak_mb``) is measured on the host that runs
it.

``measure_traffic`` runs a job for real on the Session's device and
reports what crossed the transport and the wall time it took.  Every entry
point takes ``device``: the card unless ``device="cpu"``; without a card
and without that, the Session raises.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .api import SLOT_BYTES, JobSpec, Session
from .core.bytecode import _IMM_OFF, _IN_OFF, _OUT_OFF, Op, unpack_heads
from .core.simulator import DeviceModel
from .core.transport import FabricSpec, LinkStats, aggregate_links
from .protocols.ckks.driver import CkksCostModel
from .protocols.ckks.params import CkksParams
from .protocols.garbled.cost import GCCostModel
from .workloads import get

Device = str | torch.device | None

# --- calibration ------------------------------------------------------------

STORAGE = DeviceModel(bandwidth=1e9, latency=300e-6, fault_overhead=5e-6,
                      readahead=2, os_writeback_throttle_s=0.02)
OS_PAGE_BYTES = 4096
FILE_BW = 1e9               # input/output file streaming (all scenarios)
GC_SLOT_BYTES = SLOT_BYTES["gc"]      # one wire label
CKKS_SLOT_BYTES = SLOT_BYTES["ckks"]  # one 8-byte word
BENCH_CKKS = CkksParams(n_ring=1024, levels=2)

# paper defaults (§8.2): GC l=10000, B=256 pages; CKKS l=100, B=16
GC_PLAN = dict(lookahead=10_000, prefetch_pages=64)
CKKS_PLAN = dict(lookahead=100, prefetch_pages=16)

#: the streaming planner's own memory cap (MiB): trace files larger than
#: this are "past-planner-cap" sizes that only the file pipeline can plan
#: within budget
PLANNER_CAP_MB = 8.0


class ScenarioCost:
    """Driver cost model + input/output FILE streaming (paid identically in
    every scenario, §8.1.3 phase 1/3).

    Callable per instruction (the scalar simulator cores' interface) and
    chunkable via :meth:`cost_chunk` over raw record chunks (what the
    ``core="array"`` simulators consume): per-instruction values are
    IDENTICAL between the two paths, which is what makes the array and
    scalar simulator cores exactly equal end-to-end."""

    def __init__(self, protocol: str, n_ring: int | None = None):
        self.protocol = protocol
        self.slot_bytes = GC_SLOT_BYTES if protocol == "gc" \
            else CKKS_SLOT_BYTES
        if protocol == "gc":
            self.model = GCCostModel()
            self._base = self.model.cost
        else:
            self.model = CkksCostModel(pointwise=1.2e-9)
            self.n_ring = n_ring if n_ring is not None else BENCH_CKKS.n_ring
            self._base = lambda instr: self.model.cost(instr, self.n_ring)

    def __call__(self, instr) -> float:
        c = self._base(instr)
        if instr.op in (Op.INPUT, Op.OUTPUT):
            spans = instr.outs if instr.op == Op.INPUT else instr.ins
            nbytes = sum(s[1] for s in spans) * self.slot_bytes
            c += nbytes / FILE_BW
        return c

    def cost_chunk(self, rec: np.ndarray) -> np.ndarray:
        """Per-instruction seconds for one [m, RECORD_WORDS] record chunk:
        the protocol model's vectorized formulas plus the INPUT/OUTPUT
        file-streaming bytes (span slot counts straight off the zero-padded
        record columns)."""
        ops, _n_outs, _n_ins, n_imm = unpack_heads(rec[:, 0])
        imm = rec[:, _IMM_OFF:]
        if self.protocol == "gc":
            c = self.model.cost_chunk(ops, imm, n_imm)
        else:
            c = self.model.cost_chunk(ops, imm, self.n_ring)
        is_in = ops == int(Op.INPUT)
        io = is_in | (ops == int(Op.OUTPUT))
        if io.any():
            sel = rec[io]
            outs_n = sel[:, _OUT_OFF + 1] + sel[:, _OUT_OFF + 3]
            ins_n = sel[:, _IN_OFF + 1:_IN_OFF + 8:2].sum(axis=1)
            nbytes = np.where(is_in[io], outs_n, ins_n) * self.slot_bytes
            c[io] += nbytes.astype(np.float64) / FILE_BW
        return c


def cost_fn(protocol: str) -> ScenarioCost:
    """The calibrated §8.2 cost model for one protocol (see ScenarioCost)."""
    return ScenarioCost(protocol)


@dataclasses.dataclass
class ScenarioResult:
    """One worker's three scenarios (model seconds) and its plan.  The JAX
    package's result also names the simulator core; the port's two cores
    give the same results, so it has no such field."""
    unbounded_s: float
    os_s: float
    mage_s: float
    plan_s: float
    plan_peak_mb: float
    swaps_in: int
    swaps_out: int
    prefetched: int
    working_set_pages: int
    budget_pages: int
    instructions: int
    program_bytes: int = 0
    plan_mode: str = "memory"
    #: bytes the simulated device actually transferred (fig8's I/O columns):
    #: OS faults read whole readahead clusters, so os_read_bytes can exceed
    #: pages * page_bytes; write-backs and MAGE swaps move whole pages.
    os_read_bytes: int = 0
    os_write_bytes: int = 0
    mage_read_bytes: int = 0
    mage_write_bytes: int = 0

    @property
    def speedup_vs_os(self) -> float:
        return self.os_s / self.mage_s

    @property
    def pct_of_unbounded(self) -> float:
        return self.mage_s / self.unbounded_s - 1.0


def scenario_spec(name: str, n: int, budget_frac: float = 0.25,
                  num_workers: int = 1, plan_overrides: dict | None = None,
                  plan_mode: str = "memory") -> JobSpec:
    """The JobSpec the §8.2 benchmarks use for one (workload, size) case."""
    w = get(name)
    knobs = dict(GC_PLAN if w.protocol == "gc" else CKKS_PLAN)
    knobs.update(plan_overrides or {})
    allowed = {"lookahead", "prefetch_pages", "policy", "swap_bypass"}
    unknown = set(knobs) - allowed
    if unknown:
        raise ValueError(f"unknown plan knobs {sorted(unknown)}; "
                         f"allowed: {sorted(allowed)}")
    extra = {}
    if w.protocol == "ckks":
        extra = dict(ckks_ring=BENCH_CKKS.n_ring,
                     ckks_levels=BENCH_CKKS.levels)
    return JobSpec(workload=name, n=n, num_workers=num_workers,
                   memory_budget=float(budget_frac),
                   lookahead=knobs["lookahead"],
                   prefetch_pages=knobs["prefetch_pages"],
                   policy=knobs.get("policy", "min"),
                   swap_bypass=knobs.get("swap_bypass", False),
                   plan_mode=plan_mode, track_plan_memory=True, **extra)


def run_workload_workers(name: str, n: int, num_workers: int = 1,
                         budget_frac: float = 0.25,
                         plan_overrides: dict | None = None,
                         plan_mode: str = "memory",
                         device: Device = None) -> list[ScenarioResult]:
    """All three scenarios for every worker of one case (one Session)."""
    spec = scenario_spec(name, n, budget_frac=budget_frac,
                         num_workers=num_workers,
                         plan_overrides=plan_overrides, plan_mode=plan_mode)
    with Session(spec, device=device) as s:
        scenarios = s.simulate(cost_fn(s.protocol), model=STORAGE,
                               os_page_bytes=OS_PAGE_BYTES)
    out = []
    for sc in scenarios:
        out.append(ScenarioResult(
            unbounded_s=sc.unbounded.total, os_s=sc.os.total,
            mage_s=sc.mage.total, plan_s=sc.report.total_s,
            plan_peak_mb=sc.report.peak_mem_bytes / 2**20,
            swaps_in=sc.report.replacement.swap_ins,
            swaps_out=sc.report.replacement.swap_outs,
            prefetched=sc.report.schedule.prefetched,
            working_set_pages=sc.working_set_pages,
            budget_pages=sc.config.num_frames,
            instructions=sc.instructions,
            program_bytes=sc.program_bytes,
            plan_mode=plan_mode,
            os_read_bytes=sc.os.read_bytes,
            os_write_bytes=sc.os.write_bytes,
            mage_read_bytes=sc.mage.read_bytes,
            mage_write_bytes=sc.mage.write_bytes))
    return out


def run_workload(name: str, n: int, budget_frac: float = 0.25,
                 num_workers: int = 1, worker: int = 0,
                 plan_overrides: dict | None = None,
                 plan_mode: str = "memory",
                 device: Device = None) -> ScenarioResult:
    """One worker's scenarios.  Note: plans and simulates ALL workers of
    the trace (one Session)."""
    return run_workload_workers(name, n, num_workers=num_workers,
                                budget_frac=budget_frac,
                                plan_overrides=plan_overrides,
                                plan_mode=plan_mode, device=device)[worker]


def fmt_row(name: str, r: ScenarioResult) -> str:
    return (f"{name:12s} n/a={r.instructions:7d}i ws={r.working_set_pages:5d} "
            f"budget={r.budget_pages:5d} | unb={r.unbounded_s:8.3f}s "
            f"os={r.os_s:8.3f}s mage={r.mage_s:8.3f}s | "
            f"speedup={r.speedup_vs_os:5.2f}x "
            f"overhead={100*r.pct_of_unbounded:6.1f}%")


def fmt_io_row(name: str, r: ScenarioResult) -> str:
    """The I/O columns: bytes the simulated device actually moved."""
    mib = 2**20
    moved = (r.mage_read_bytes + r.mage_write_bytes) / \
        max(r.os_read_bytes + r.os_write_bytes, 1)
    return (f"{name:12s} io: os r/w={r.os_read_bytes / mib:8.1f}/"
            f"{r.os_write_bytes / mib:8.1f} MiB  "
            f"mage r/w={r.mage_read_bytes / mib:8.1f}/"
            f"{r.mage_write_bytes / mib:8.1f} MiB  "
            f"(mage moves {moved:.2f}x the OS bytes)")


# --- measured traffic (the transport fabric's accounting) -------------------


@dataclasses.dataclass
class TrafficReport:
    """One REAL execution's measured communication + wall time.

    ``links`` is the fabric's send-side accounting aggregated per
    (src_rank, dst_rank); ``stats`` keeps the per-tag detail."""

    seconds: float
    outputs: dict[int, np.ndarray]
    stats: dict[tuple[int, int, int], LinkStats]
    links: dict[tuple[int, int], LinkStats]

    @property
    def total_bytes(self) -> int:
        return sum(s.bytes for s in self.links.values())

    @property
    def total_messages(self) -> int:
        return sum(s.messages for s in self.links.values())


def measure_traffic(name: str, n: int, num_workers: int = 1,
                    driver: str = "auto", transport: str = "inproc",
                    fabric: FabricSpec | None = None,
                    check: bool = False, exec_backend: str = "scalar",
                    warmup: bool = False,
                    device: Device = None) -> TrafficReport:
    """Run a workload for REAL (unbounded plan) on the Session's device
    and report what actually crossed the fabric.  ``transport="shaped"``
    with a fabric carrying ``latency_s``/``bandwidth`` makes ``seconds``
    a WAN measurement.  The job runs the spec's driver (``"auto"``: the
    protocol's default; ``gc-2party`` for two-party garbled circuits).

    ``exec_backend="overlap"`` runs the overlap schedule; ``warmup=True``
    executes once untimed first so the timed run does not pay one-time
    import and first-call costs.  Trace and plan stay out of the time."""
    spec = JobSpec(workload=name, n=n, num_workers=num_workers,
                   plan_mode="unbounded", driver=driver,
                   transport=transport, fabric=fabric,
                   exec_backend=exec_backend)
    if warmup:
        with Session(spec, device=device) as w:
            w.execute(real=None, check=False)
    with Session(spec, device=device) as s:
        s.plan()
        t0 = time.perf_counter()
        outs = s.execute(real=None, check=check)
        seconds = time.perf_counter() - t0
        stats = s.transport_stats
    return TrafficReport(seconds=seconds, outputs=outs,
                         stats=stats, links=aggregate_links(stats))


# --- the `python -m repro_torch bench` sweep --------------------------------

#: fig8-style §8.2 sweep (scaled); the streaming case's virtual trace
#: (~11.6 MiB) exceeds the planner cap, so it runs the file pipeline.
BENCH_CASES = [("merge", 16384), ("sort", 16384), ("ljoin", 256),
               ("mvmul", 384), ("binfclayer", 2048), ("rsum", 256),
               ("rstats", 128), ("rmvmul", 24), ("n_rmatmul", 8),
               ("t_rmatmul", 8)]
TINY_BENCH_CASES = [("merge", 2048), ("rsum", 128)]
STREAMING_CASE = ("merge", 131072)
TINY_STREAMING_CASE = ("merge", 4096)


def _row(name: str, n: int, r: ScenarioResult, **extra) -> dict:
    return {"workload": name, "n": n, **extra,
            "speedup_vs_os": r.speedup_vs_os,
            "pct_of_unbounded": r.pct_of_unbounded,
            **dataclasses.asdict(r)}


def run_bench(cases=None, budget_frac: float = 0.4, check: bool = True,
              streaming_case=None, device: Device = None) -> list[dict]:
    """Drive the §8.2 scenarios; returns JSON-ready row dicts.  ``check``
    asserts the paper's claim on every row: MAGE beats OS swapping."""
    cases = cases if cases is not None else BENCH_CASES
    rows = []
    for name, n in cases:
        r = run_workload(name, n, budget_frac=budget_frac, device=device)
        print("bench:", fmt_row(name, r), flush=True)
        rows.append(_row(name, n, r))
    if streaming_case is not None:
        name, n = streaming_case
        r = run_workload(name, n, budget_frac=budget_frac,
                         plan_mode="streaming", device=device)
        print("bench (streaming):", fmt_row(name, r), flush=True)
        rows.append(_row(name, n, r))
    if check:
        beats = sum(r["os_s"] > r["mage_s"] for r in rows)
        assert beats == len(rows), \
            f"MAGE must beat OS on all cases, got {beats}/{len(rows)}"
    return rows


#: the `bench --sweep` grid: how the planner's two main knobs trade off
SWEEP_BUDGETS = (0.15, 0.25, 0.4, 0.6)
SWEEP_LOOKAHEADS = (100, 1_000, 10_000)


def run_sweep(cases=None, budgets=SWEEP_BUDGETS,
              lookaheads=SWEEP_LOOKAHEADS,
              device: Device = None) -> list[dict]:
    """Budget x lookahead grid over the §8.2 scenarios: one row per
    (case, budget_frac, lookahead) cell."""
    cases = cases if cases is not None else TINY_BENCH_CASES
    rows = []
    for name, n in cases:
        for b in budgets:
            for la in lookaheads:
                r = run_workload(name, n, budget_frac=float(b),
                                 plan_overrides={"lookahead": int(la)},
                                 device=device)
                print(f"sweep: {name:12s} n={n} budget={b:<5} "
                      f"lookahead={la:<6} | mage={r.mage_s:8.3f}s "
                      f"os={r.os_s:8.3f}s speedup={r.speedup_vs_os:5.2f}x "
                      f"overhead={100 * r.pct_of_unbounded:6.1f}%",
                      flush=True)
                rows.append(_row(name, n, r, budget_frac=float(b),
                                 lookahead=int(la)))
    return rows
