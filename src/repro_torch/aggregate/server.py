"""Secure-aggregation online phase, compute side: one fleet server (the
port's copy of ``repro.aggregate.server``, its state on the card).

Per round, a server:

1. loads the round plan (rank 0 through the artifact cache, so hot
   rounds make no re-plan; other ranks reuse the plan they were handed
   offline),
2. reserves the round's O(clients) footprint with the
   :class:`~..serve_daemon.admission.AdmissionController` (``plan.frames``
   frames, the gathered share matrix in bytes, which lives in device
   memory),
3. **batch-ingests**: receives every announced client share straight
   into one ``[clients, vec_len]`` int64 tensor on the device, which
   holds the shares' uint64 bits (``recv(out=buf[c])``), then reduces it
   with ONE ``torch.sum(dim=0)`` on the device (the reference's
   ``np.add.reduce``): two's-complement addition wraps as uint64
   addition does, so the bits are the reference's mod-2**64 sum,
4. agrees on survivors: servers exchange received-client bitmaps and
   intersect, so every server reduces exactly the same subset even if a
   straggler's share reached only part of the fleet (the rows outside it
   are zeroed before the sum),
5. reveals: non-zero ranks ship their partial sum to rank 0, which adds
   them on its device; additive shares make the reveal a plain sum.

Straggler handling is *reported, never silently wrong*: a gateway whose
manifest misses the round timeout drops all its clients for that round;
a client missing from the intersected bitmap drops from the reduction;
the round result names its surviving subset and is bitwise equal to a
straggler-free run over the same survivors (shares are pure functions
of (client, server, round): ``offline.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.transport import TransportError
from .client import LatencyBook
from .offline import (AggSpec, RoundPlan, data_tag, manifest_tag,
                      partial_tag, survivor_tag)

__all__ = ["RoundResult", "run_server"]


class RoundResult:
    """One round as seen by rank 0: the revealed aggregate (a host uint64
    array; None on other ranks), who made it in, and whether the round
    degraded below the announced population."""

    def __init__(self, rnd: int, total: np.ndarray | None,
                 survivors: list[int], expected_clients: int,
                 plan_event: str):
        self.rnd = rnd
        self.total = total
        self.survivors = survivors
        self.expected_clients = expected_clients
        self.plan_event = plan_event

    @property
    def degraded(self) -> bool:
        return len(self.survivors) < self.expected_clients


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _ingest_round(transport, spec: AggSpec, plan: RoundPlan, k: int,
                  rnd: int, buf: torch.Tensor, latency: LatencyBook | None
                  ) -> np.ndarray:
    """Receive the round's manifests and shares into ``buf``; return the
    received-client boolean mask.  A gateway that misses the round
    timeout loses its whole client block for this round."""
    got = np.zeros(spec.clients, dtype=bool)
    for g in range(spec.gateways):
        gw = spec.gateway_rank(g)
        try:
            man = transport.recv(gw, k, manifest_tag(rnd),
                                 timeout=spec.round_timeout_s)
        except TransportError:
            continue                      # dead or late gateway: block dropped
        for c in _host(man).tolist():
            try:
                transport.recv(gw, k, data_tag(spec, rnd, c), out=buf[c],
                               timeout=spec.round_timeout_s)
            except TransportError:
                continue                  # announced but never arrived
            got[c] = True
            if latency is not None and k == 0:
                latency.ingested(rnd, c)
    return got


def _agree_survivors(transport, spec: AggSpec, k: int, rnd: int,
                     got: np.ndarray) -> np.ndarray:
    """All-to-all bitmap exchange; the fleet reduces the intersection,
    so a share that reached only part of the fleet is dropped everywhere
    (otherwise the shares would not cancel)."""
    agreed = got
    if spec.servers > 1:
        mine = torch.from_numpy(np.packbits(got))
        for j in range(spec.servers):
            if j != k:
                transport.send(k, j, survivor_tag(rnd), mine)
        for j in range(spec.servers):
            if j != k:
                theirs = transport.recv(j, k, survivor_tag(rnd),
                                        timeout=spec.round_timeout_s)
                agreed = agreed & np.unpackbits(
                    _host(theirs), count=spec.clients).astype(bool)
    return agreed


def run_server(transport, spec: AggSpec, k: int, admission,
               plan_loader, device: torch.device,
               latency: LatencyBook | None = None) -> dict:
    """Run server rank ``k`` for all rounds, its share matrix and sums on
    ``device``.

    ``plan_loader()`` is called once per round and returns
    ``(RoundPlan, event)``: rank 0 wires it to the artifact cache, peers
    to the offline-distributed plan.  Returns the per-rank report; rank
    0's includes the revealed aggregates."""
    rounds: list[RoundResult] = []
    plan_events: list[str] = []
    for rnd in range(spec.rounds):
        plan, event = plan_loader()
        plan_events.append(event)
        # the admission wait knows nothing of the baton: give it up
        released = transport.baton.give_up()
        try:
            grant = admission.admit(plan.frames, plan.mem_bytes,
                                    timeout=spec.round_timeout_s)
        finally:
            if released:
                transport.baton.acquire()
        with grant:
            buf = torch.zeros((spec.clients, spec.vec_len),
                              dtype=torch.int64, device=device)
            got = _ingest_round(transport, spec, plan, k, rnd, buf, latency)
            agreed = _agree_survivors(transport, spec, k, rnd, got)
            out = np.flatnonzero(got & ~agreed)
            if len(out):               # received here, dropped by the fleet
                buf[torch.from_numpy(out).to(device)] = 0
            # the round's entire arithmetic: one reduction on the device
            partial = buf.sum(dim=0)
            del buf
        survivors = [int(c) for c in np.flatnonzero(agreed)]
        if k != 0:
            transport.send(k, 0, partial_tag(rnd), partial, copy=False)
            rounds.append(RoundResult(rnd, None, survivors, spec.clients,
                                      event))
            continue
        total = partial
        for j in range(1, spec.servers):
            total = total + transport.recv(
                j, 0, partial_tag(rnd),
                timeout=spec.round_timeout_s).to(device)
        rounds.append(RoundResult(rnd, _host(total).view(np.uint64),
                                  survivors, spec.clients, event))
    return {
        "rank": k,
        "rounds": rounds,
        "plan_events": plan_events,
    }
