"""Secure-aggregation online phase, input side: the client swarm (the
port's copy of ``repro.aggregate.client``).

Thousands of *logical* clients are multiplexed over a few gateway
endpoints of the transport fabric (ranks ``[S, S+G)``): each client's
per-round share to server ``k`` is one tagged message on the shared
``gateway -> server`` link, under the per-(round, client) tag from the
offline plan.  Fan-in therefore scales in the TAG space (the fabric's
per-tag reorder buffers), not in sockets or threads.

The gateways are input-only clients (other machines in a deployment):
they draw their shares on the host in NumPy, as the reference does, and
send them as int64 tensors holding the uint64 bits.  Only the servers'
state lives on the card.

Flow control is the transport's own reorder-buffer bound: the server
bounds each gateway link's pending bytes, so a gateway running ahead of
the reduction blocks in ``send`` instead of materializing the round in
server memory (``reorder_stats`` high-water marks show it).

Straggler model: clients listed in ``drop`` for a round never send; the
gateway's per-round *manifest* (the client list it is about to stream)
tells each server exactly what to expect, so a missing client costs the
server a manifest diff, not a receive timeout.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .offline import AggSpec, RoundPlan, client_shares, data_tag, manifest_tag

__all__ = ["LatencyBook", "run_gateway", "words"]


def words(x: np.ndarray) -> torch.Tensor:
    """A host uint64 array as the int64 tensor of its bits (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint64)
                            .view(np.int64))


class LatencyBook:
    """Per-client share latency: send stamp at the gateway, ingest stamp
    at the server (same process only: wall-clock stamps do not cross the
    wire).  ``samples`` are seconds from a client emitting its shares to
    server 0 having its row gathered."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sent: dict[tuple[int, int], float] = {}
        self.samples: list[float] = []

    def sent(self, rnd: int, client: int) -> None:
        with self._lock:
            self._sent[(rnd, client)] = time.monotonic()

    def ingested(self, rnd: int, client: int) -> None:
        now = time.monotonic()
        with self._lock:
            t0 = self._sent.pop((rnd, client), None)
            if t0 is not None:
                self.samples.append(now - t0)

    def percentiles_ms(self, qs=(50, 90, 99)) -> dict[str, float]:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples) * 1e3
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


def run_gateway(transport, spec: AggSpec, plan: RoundPlan, g: int,
                drop: frozenset = frozenset(),
                latency: LatencyBook | None = None) -> dict:
    """Stream every round's shares for gateway ``g``'s client block.

    Per round: announce the surviving client list to every server (the
    manifest), then emit each surviving client's shares, one message per
    (client, server).  Returns per-gateway counters."""
    rank = spec.gateway_rank(g)
    mine = plan.gateway_clients[g]
    sent_msgs = 0
    for rnd in range(spec.rounds):
        alive = [c for c in mine if (rnd, c) not in drop]
        man = words(np.asarray(alive, dtype=np.uint64))
        for k in range(spec.servers):
            transport.send(rank, k, manifest_tag(rnd), man)
        for c in alive:
            if latency is not None:
                latency.sent(rnd, c)
            shares = client_shares(spec, c, rnd)
            for k in range(spec.servers):
                # freshly drawn arrays, never touched again: skip the
                # snapshot on in-process backends
                transport.send(rank, k, data_tag(spec, rnd, c),
                               words(shares[k]), copy=False)
            sent_msgs += spec.servers
    return {"gateway": g, "clients": len(mine), "sent_msgs": sent_msgs}
