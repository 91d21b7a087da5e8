"""Secure-aggregation orchestrator: place endpoints, run the rounds,
collect the evidence (the port's copy of ``repro.aggregate.run``).

``run_aggregation`` is the one entry point behind ``python -m repro_torch
agg``.  It builds the fabric (servers are ranks ``[0, S)``, gateways
``[S, S+G)``), applies the per-link backpressure bound from the spec,
runs every *hosted* endpoint (all of them in-process, or exactly one
under ``--rank`` for multi-process runs), and returns an
:class:`AggResult` whose ``to_doc`` is the CLI's JSON envelope:

* revealed per-round aggregates and the surviving-client subsets (the
  bitwise-identity acceptance surface),
* per-link byte and message accounting and reorder-buffer HIGH-WATER
  marks (the counters that show in-flight bytes stayed under the knobs:
  the bound is the knob plus the largest message the link carries, since
  a send waits only while its link is already at the bound),
* admission-controller status, plan-cache events and cache counters (the
  zero-re-plan evidence), and client-to-ingest latency percentiles.

The servers' share matrices and sums live on ``device``: the card unless
the caller passes ``device="cpu"``.  The endpoint threads of a process
take turns on the fabric's baton (``core.transport``), as engine threads
do, so the gateways' NumPy draws and the servers' copies to the card do
not hand the interpreter lock back and forth; every wait gives it up.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.transport import Fabric, FabricSpec, build_fabric
from ..kernels import resolve_device
from ..serve_daemon.admission import AdmissionController
from .client import LatencyBook, run_gateway
from .offline import (AggSpec, RoundPlan, build_round_plan, expected_sum,
                      load_round_plan)
from .server import run_server

__all__ = ["AggResult", "largest_message", "run_aggregation",
           "verify_aggregates"]


@dataclasses.dataclass
class AggResult:
    """Everything one process learned from an aggregation run.  On a
    distributed non-zero rank, ``rounds`` is empty (only rank 0
    reveals)."""

    spec: AggSpec
    transport: str
    hosted: list[int]
    rounds: list            # rank 0's RoundResults (revealed totals)
    plan_events: list[str]  # rank 0's per-round cache events
    seconds: float
    clients_per_s: float
    latency_ms: dict
    link_totals: dict
    reorder: dict
    admission: dict
    cache: dict | None
    gateway_reports: list[dict]
    device: str = "cpu"

    def to_doc(self) -> dict:
        return {
            "spec": self.spec.to_dict(),
            "transport": self.transport,
            "device": self.device,
            "hosted": self.hosted,
            "rounds": [
                {"round": r.rnd,
                 "aggregate": [int(v) for v in r.total],
                 "survivors": r.survivors,
                 "degraded": r.degraded}
                for r in self.rounds],
            "plan_events": self.plan_events,
            "seconds": self.seconds,
            "clients_per_s": self.clients_per_s,
            "latency_ms": self.latency_ms,
            "link_totals": {
                f"{s}->{d}": {"messages": st.messages, "bytes": st.bytes}
                for (s, d), st in sorted(self.link_totals.items())},
            "reorder": {
                f"{s}->{d}": dataclasses.asdict(st)
                for (s, d), st in sorted(self.reorder.items())},
            "admission": self.admission,
            "cache": self.cache,
        }


def verify_aggregates(result: AggResult) -> None:
    """Check every revealed round against the single-process oracle over
    the SAME surviving subset, bit for bit."""
    for r in result.rounds:
        ref = expected_sum(result.spec, r.rnd, survivors=r.survivors)
        if not np.array_equal(np.asarray(r.total, dtype=np.uint64), ref):
            raise AssertionError(
                f"round {r.rnd}: aggregate over {len(r.survivors)} "
                f"survivors does not match the reference sum")


def largest_message(spec: AggSpec, plan: RoundPlan, g: int) -> int:
    """Bytes of the largest message gateway ``g`` sends a server: a share
    (``vec_len`` words) or its round manifest (a word a client)."""
    return max(plan.share_bytes, 8 * len(plan.gateway_clients[g]))


def _apply_depth(fabric: Fabric, spec: AggSpec) -> None:
    """Bound every hosted server's gateway links per the spec."""
    if not (spec.max_inflight_msgs or spec.max_inflight_bytes):
        return
    for k in range(spec.servers):
        if k not in fabric.transports:
            continue
        t = fabric.transport_for(k)
        for g in range(spec.gateways):
            t.set_depth(spec.gateway_rank(g), k,
                        max_msgs=spec.max_inflight_msgs,
                        max_bytes=spec.max_inflight_bytes)


def run_aggregation(spec: AggSpec, transport: str = "inproc",
                    fabric_spec: FabricSpec | None = None,
                    cache=None, drop=None,
                    device: str | torch.device | None = None) -> AggResult:
    """Run the online phase for every endpoint hosted by this process.

    ``drop`` is an iterable of ``(round, client)`` pairs that never send
    (the straggler model).  ``cache`` is an ``ArtifactCache`` (or None);
    only server rank 0 consults it: one miss cold, zero re-plans hot.
    ``device`` holds the servers' state (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    fabric_spec = fabric_spec or FabricSpec()
    dropset = frozenset((int(r), int(c)) for r, c in (drop or ()))
    fabric = build_fabric(transport, spec.num_endpoints, fabric_spec,
                          device=dev)
    fabric.connect()
    _apply_depth(fabric, spec)

    base_plan = build_round_plan(spec)      # the offline-distributed copy
    admission = AdmissionController(
        frame_pool=spec.frame_pool,
        memory_bytes=spec.frame_pool * (64 << 10))
    latency = LatencyBook() if not fabric.distributed else None

    results: dict[int, dict] = {}
    errors: list[BaseException] = []

    def _endpoint(rank: int) -> None:
        try:
            t = fabric.transport_for(rank)
            with fabric.baton:
                _run_endpoint(rank, t)
        except BaseException as e:  # re-raised after join
            errors.append(e)

    def _run_endpoint(rank: int, t) -> None:
        if rank < spec.servers:
            if rank == 0:
                loader = lambda: load_round_plan(cache, spec)  # noqa: E731
            else:
                loader = lambda: (base_plan, "offline")        # noqa: E731
            results[rank] = run_server(t, spec, rank, admission, loader,
                                       dev, latency=latency)
        else:
            results[rank] = run_gateway(t, spec, base_plan,
                                        rank - spec.servers, drop=dropset,
                                        latency=latency)

    t0 = time.monotonic()
    threads = [threading.Thread(target=_endpoint, args=(r,), daemon=True,
                                name=f"agg-rank{r}") for r in fabric.hosted]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    seconds = time.monotonic() - t0
    if errors:
        fabric.close()
        raise errors[0]

    # hold multi-process peers open until everyone drained their rounds
    if fabric.distributed:
        fabric.barrier()

    link_totals = fabric.link_totals()
    reorder = fabric.reorder_stats()
    fabric.close()

    r0 = results.get(0, {})
    rounds = r0.get("rounds", [])
    ingested = sum(len(r.survivors) for r in rounds)
    return AggResult(
        spec=spec,
        transport=transport,
        hosted=list(fabric.hosted),
        rounds=rounds,
        plan_events=r0.get("plan_events", []),
        seconds=seconds,
        clients_per_s=(ingested / seconds) if seconds > 0 else 0.0,
        latency_ms=latency.percentiles_ms() if latency else {},
        link_totals=link_totals,
        reorder=reorder,
        admission=admission.status(),
        cache=(cache.status() if cache is not None else None),
        gateway_reports=[results[r] for r in fabric.hosted
                         if r >= spec.servers],
        device=str(dev),
    )
