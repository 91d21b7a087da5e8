"""Secure-aggregation offline phase: specs, key material, round plans
(the port's copy of ``repro.aggregate.offline``: host work in NumPy, the
same PRG draws bit for bit, the same plan keys and round-plan documents).

The production shape of MAGE's thesis — SC programs are oblivious, so
their resource schedule is computable ahead of time — is federated
secure aggregation: every round ingests the same number of shares, of
the same size, under tags known in advance.  This module is everything
that can be derived *before* any client connects:

* :class:`AggSpec` — the job description.  ``plan_key()`` hashes the
  plan-relevant subset (mirroring ``JobSpec.plan_hash``), so round
  plans are cacheable across rounds, runs and daemon restarts through
  ``ArtifactCache``'s ``agg`` kind.
* additive secret sharing mod 2**64: client ``c``'s round-``r`` vector
  splits into one share per compute server.  All but the last share are
  pseudorandom functions of ``(seed, client, server, round)`` — exactly
  the per-client mask/key material a real deployment would provision
  offline — and the last share is the vector minus the others.  Because
  every share is a pure function of ``(client, server, round)``, the
  revealed aggregate over any surviving-client subset is bitwise
  independent of *which run* produced it: a straggler-degraded round
  equals a straggler-free round over the same survivors.
* :func:`build_round_plan` — the per-round ingestion schedule (client →
  gateway assignment, tag layout, O(clients) admission estimates).  The
  online phase never recomputes this; it loads it (``load_round_plan``)
  from the artifact cache, where hot rounds hit with zero re-plans.

Tag layout: data/control tags live far above the DSL's small
non-negative tag space and far below the transport's deeply negative
barrier ranges, partitioned per purpose so a round's client shares,
manifests, survivor votes and partial sums can never collide.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

__all__ = [
    "AggSpec", "RoundPlan", "DEFAULT_SEED", "FRAME_BYTES",
    "build_round_plan", "load_round_plan", "client_vector",
    "client_shares", "expected_sum", "data_tag", "manifest_tag",
    "survivor_tag", "partial_tag",
]

DEFAULT_SEED = 7
#: admission accounting unit: one 64 KiB frame (the paper's GC page size)
FRAME_BYTES = 64 << 10

#: reserved control/data tag ranges (disjoint by construction)
TAG_MANIFEST_BASE = 1 << 32
TAG_DATA_BASE = 1 << 33
TAG_SURVIVOR_BASE = 1 << 34
TAG_PARTIAL_BASE = 1 << 35

#: domain-separation constants for the PRG seed tuples
_DOM_DATA = 0xDA7A
_DOM_MASK = 0xA11CE


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One secure-aggregation job: N input-only clients stream additive
    shares to ``servers`` compute endpoints via ``gateways`` transport
    endpoints (thousands of logical clients multiplexed over a few
    fabric ranks — the fan-in axis is the *tag* space, not the socket
    count)."""

    clients: int
    vec_len: int = 64
    rounds: int = 1
    servers: int = 2
    gateways: int = 2
    seed: int = DEFAULT_SEED
    # online-phase knobs (not plan-hashed: they shape resource use, never
    # the aggregate)
    max_inflight_msgs: int = 0
    max_inflight_bytes: int = 1 << 20
    round_timeout_s: float = 30.0
    frame_pool: int = 1 << 16

    #: fields the round plan is a pure function of
    PLAN_FIELDS = ("clients", "vec_len", "rounds", "servers", "gateways",
                   "seed")

    def __post_init__(self):
        if self.clients <= 0 or self.vec_len <= 0 or self.rounds <= 0:
            raise ValueError("clients, vec_len and rounds must be positive")
        if self.servers < 1 or self.gateways < 1:
            raise ValueError("need at least one server and one gateway")

    @property
    def num_endpoints(self) -> int:
        """Fabric rank space: servers are ranks [0, S), gateways
        [S, S+G)."""
        return self.servers + self.gateways

    def gateway_rank(self, g: int) -> int:
        return self.servers + g

    def gateway_of(self, client: int) -> int:
        return client % self.gateways

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AggSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def plan_key(self) -> str:
        doc = {k: getattr(self, k) for k in self.PLAN_FIELDS}
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


# -- tag layout --------------------------------------------------------------


def data_tag(spec: AggSpec, rnd: int, client: int) -> int:
    """Per-(round, client) share tag: every client on a shared
    gateway→server link is its own reorder-buffer lane."""
    return TAG_DATA_BASE + rnd * spec.clients + client


def manifest_tag(rnd: int) -> int:
    return TAG_MANIFEST_BASE + rnd


def survivor_tag(rnd: int) -> int:
    return TAG_SURVIVOR_BASE + rnd


def partial_tag(rnd: int) -> int:
    return TAG_PARTIAL_BASE + rnd


# -- key material / shares ---------------------------------------------------


def client_vector(seed: int, client: int, rnd: int,
                  vec_len: int) -> np.ndarray:
    """Client ``client``'s secret round-``rnd`` input (deterministic
    synthetic data, uint64)."""
    rng = np.random.default_rng((seed, _DOM_DATA, rnd, client))
    return rng.integers(0, 1 << 64, vec_len, dtype=np.uint64)


def _mask(seed: int, client: int, server: int, rnd: int,
          vec_len: int) -> np.ndarray:
    rng = np.random.default_rng((seed, _DOM_MASK, rnd, client, server))
    return rng.integers(0, 1 << 64, vec_len, dtype=np.uint64)


def client_shares(spec: AggSpec, client: int, rnd: int) -> list[np.ndarray]:
    """Additive shares of ``client_vector`` mod 2**64, one per server.

    Shares 0..S-2 are the offline-provisioned masks; the last share is
    the vector minus their sum (uint64 wraparound), so the shares sum to
    the vector and any S-1 of them are uniformly random."""
    x = client_vector(spec.seed, client, rnd, spec.vec_len)
    shares = [_mask(spec.seed, client, k, rnd, spec.vec_len)
              for k in range(spec.servers - 1)]
    used = np.zeros(spec.vec_len, dtype=np.uint64)
    for s in shares:
        used += s                     # uint64 wraparound is the group op
    shares.append(x - used)
    return shares


def expected_sum(spec: AggSpec, rnd: int,
                 survivors=None) -> np.ndarray:
    """The reference aggregate: sum of the surviving clients' vectors
    mod 2**64 (the single-process oracle the fleet must match bitwise)."""
    ids = range(spec.clients) if survivors is None else sorted(survivors)
    out = np.zeros(spec.vec_len, dtype=np.uint64)
    for c in ids:
        out += client_vector(spec.seed, c, rnd, spec.vec_len)
    return out


# -- round plan --------------------------------------------------------------


@dataclasses.dataclass
class RoundPlan:
    """The oblivious per-round ingestion schedule, derived offline.

    ``gateway_clients[g]`` is gateway g's client list (its send order);
    ``frames``/``mem_bytes`` are the O(clients) admission estimates one
    server pins per round (the gathered share matrix); ``share_bytes``
    is one client message's payload size, from which the server derives
    its per-link backpressure depth."""

    key: str
    clients: int
    gateway_clients: list[list[int]]
    frames: int
    mem_bytes: int
    share_bytes: int

    def to_dict(self) -> dict:
        return {"version": 1, **dataclasses.asdict(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "RoundPlan":
        if d.get("version") != 1:
            raise ValueError(f"unknown round-plan version {d.get('version')}")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def build_round_plan(spec: AggSpec) -> RoundPlan:
    """Derive the round plan from the spec (the re-plan path; the online
    phase should hit the cache instead — see :func:`load_round_plan`)."""
    gw: list[list[int]] = [[] for _ in range(spec.gateways)]
    for c in range(spec.clients):
        gw[spec.gateway_of(c)].append(c)
    share_bytes = spec.vec_len * 8
    mem_bytes = spec.clients * share_bytes
    frames = max(1, -(-mem_bytes // FRAME_BYTES))
    return RoundPlan(key=spec.plan_key(), clients=spec.clients,
                     gateway_clients=gw, frames=frames,
                     mem_bytes=mem_bytes, share_bytes=share_bytes)


def load_round_plan(cache, spec: AggSpec) -> tuple[RoundPlan, str]:
    """Round plan via the artifact cache: ``(plan, "hit"|"miss"|"none")``.

    ``cache=None`` (no cache configured) builds in memory and reports
    ``"none"``.  On a miss the freshly built plan is published, so every
    hot round — and every later run with the same plan-relevant spec —
    reuses it with zero re-plans (verified by ``CacheStats.agg_*``)."""
    if cache is None:
        return build_round_plan(spec), "none"
    doc = cache.get_agg(spec)
    if doc is not None:
        return RoundPlan.from_dict(doc), "hit"
    plan = build_round_plan(spec)
    cache.put_agg(spec, plan.to_dict())
    return plan, "miss"
