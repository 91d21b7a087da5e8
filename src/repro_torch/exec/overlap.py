"""Overlap planner: the port's copy of ``repro.exec.overlap`` (over a
program in memory or a program file; saving a schedule to disk and its
cache wait for a later slice).  It turns a memory program into an *overlap schedule*: planned
out-of-order issue windows that hide network latency.

MAGE's premise (§3) is that SC programs are oblivious: the instruction
stream, and therefore every ``NET_SEND``/``NET_RECV``, is known before
execution.  The in-order engine waits at every ``NET_RECV`` at its program
position; this pass precomputes, once per plan, an issue order in which

* each ``NET_SEND`` is hoisted to its *earliest* legal point (right
  after the last writer of its input span),
* each ``NET_RECV`` is posted as a deferred completion handle
  (``recv_async``) as soon as its anti-dependences allow, and its
  *completion* (the blocking receive) is deferred until the schedule has
  no independent local work left before an instruction that needs the
  data,
* independent local work is scheduled into the gap, grouped exactly like
  the batch planner's groups so the batched drivers keep batching.

The result is an :class:`OverlapSchedule`: flat int64 arrays,
chunk-aligned like :class:`~repro_torch.exec.batching.BatchSchedule`.

Correctness argument: within a window, two instructions conflict iff any
of their operand spans overlap (a ``NET_SEND`` *reads* its input span, a
``NET_RECV``'s completion *writes* its output span), and the builder
schedules from an explicit dependency DAG over those conflicts — RAW,
WAW and WAR edges plus per-``(peer, tag)`` channel-order chains (the
transport's FIFO is per ``(src, dst, tag)``, so two NET ops on the same
channel keep program order; distinct tags buffer independently).
Non-NET directives (swaps), ``INPUT``/``OUTPUT`` and float-immediate
rows stay barriers in exact program order — NET ops never cross a swap
boundary, so they only ever touch resident spans.  Every handle is
posted and waited within its window, so no completion outlives a
barrier.  Span-keyed conflict tracking assumes spans are pairwise
identical-or-disjoint; the builder verifies that per window and falls
back to scalar program order where it does not hold.
"""

from __future__ import annotations

import dataclasses
import os
from heapq import heapify, heappop, heappush

import numpy as np

from ..core.bytecode import (DEFAULT_CHUNK_INSTRS, DIRECTIVES, _IMM_OFF,
                             _IN_OFF, _OUT_OFF, Op, Program, ProgramFile,
                             iter_record_chunks, unpack_heads)
from .batching import _window_groups

#: the saved schedule's format (the JAX package's): an npz of int64 arrays
OVERLAP_VERSION = 1

#: group kinds (``OverlapSchedule.group_kind``)
K_LOCAL = 0      #: compute/directive rows; batched when group_op >= 0
K_SEND = 1       #: NET_SEND rows, issued (hoisted) at this point
K_RECV_POST = 2  #: NET_RECV rows: post deferred completion handles
K_RECV_WAIT = 3  #: NET_RECV rows: complete (wait) previously posted handles

#: ops that stay hard barriers for the overlap pass: every directive
#: *except* the NET traffic this pass exists to move, plus I/O against
#: the input provider / output channel and float-immediate rows.  NET
#: ops must not cross swap barriers (a hoisted send would read a
#: not-yet-resident span), so windows end at every swap directive.
_OVERLAP_BARRIER_OPS = (frozenset(int(o) for o in DIRECTIVES)
                        - {int(Op.NET_SEND), int(Op.NET_RECV)}) \
    | {int(Op.INPUT), int(Op.OUTPUT)}

_NET_SEND = int(Op.NET_SEND)
_NET_RECV = int(Op.NET_RECV)
_FREE = int(Op.FREE)


@dataclasses.dataclass
class OverlapSchedule:
    """Precomputed out-of-order issue schedule for one worker's program.

    Flat-array encoding (int64), chunk-aligned to ``chunk_instrs``:

    * ``order``        — chunk-LOCAL row indices, concatenated group by
                         group.  A ``NET_RECV`` row appears TWICE: once
                         in a ``K_RECV_POST`` group and once in a
                         ``K_RECV_WAIT`` group, so ``len(order)`` is
                         ``n_records + deferred_recvs``;
    * ``bounds``       — ``n_groups + 1`` offsets into ``order``;
    * ``group_kind``   — per group, one of ``K_LOCAL``/``K_SEND``/
                         ``K_RECV_POST``/``K_RECV_WAIT``;
    * ``group_op``     — per ``K_LOCAL`` group the shared opcode for
                         structurally batchable groups (same contract as
                         ``BatchSchedule.group_op``), else ``-1``;
    * ``chunk_groups`` — ``n_chunks + 1`` offsets into ``group_kind``.

    Groups never cross chunk or barrier boundaries, and every posted
    handle is waited inside its own chunk."""

    chunk_instrs: int
    n_records: int
    order: np.ndarray
    bounds: np.ndarray
    group_kind: np.ndarray
    group_op: np.ndarray
    chunk_groups: np.ndarray

    @property
    def n_groups(self) -> int:
        return len(self.group_kind)

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_groups) - 1

    def stats(self) -> dict:
        sizes = np.diff(self.bounds)
        send = self.group_kind == K_SEND
        wait = self.group_kind == K_RECV_WAIT
        local = self.group_kind == K_LOCAL
        batch = local & (self.group_op >= 0) & (sizes >= 2)
        return {
            "n_records": int(self.n_records),
            "n_chunks": int(self.n_chunks),
            "n_groups": int(self.n_groups),
            "hoisted_sends": int(sizes[send].sum()),
            "deferred_recvs": int(sizes[wait].sum()),
            "batchable_instructions": int(sizes[batch].sum()),
            "scalar_instructions": int(sizes[local & ~batch].sum()),
        }

    def save(self, path: str | os.PathLike) -> None:
        """Write the schedule as the JAX package's npz sidecar (the same
        keys, every array int64), so either package loads the other's."""
        with open(path, "wb") as f:
            np.savez(f,
                     version=np.array([OVERLAP_VERSION], dtype=np.int64),
                     chunk_instrs=np.array([self.chunk_instrs],
                                           dtype=np.int64),
                     n_records=np.array([self.n_records], dtype=np.int64),
                     order=self.order.astype(np.int64),
                     bounds=self.bounds.astype(np.int64),
                     group_kind=self.group_kind.astype(np.int64),
                     group_op=self.group_op.astype(np.int64),
                     chunk_groups=self.chunk_groups.astype(np.int64))

    @classmethod
    def load(cls, path: str | os.PathLike) -> "OverlapSchedule":
        with np.load(path) as z:
            ver = int(z["version"][0])
            if ver != OVERLAP_VERSION:
                raise ValueError(
                    f"overlap schedule version {ver} != {OVERLAP_VERSION}")
            return cls(chunk_instrs=int(z["chunk_instrs"][0]),
                       n_records=int(z["n_records"][0]),
                       order=z["order"], bounds=z["bounds"],
                       group_kind=z["group_kind"], group_op=z["group_op"],
                       chunk_groups=z["chunk_groups"])

    def validate_for(self, prog: Program | ProgramFile) -> None:
        n = len(prog)
        if n != self.n_records:
            raise ValueError(
                f"overlap schedule covers {self.n_records} records but the "
                f"program has {n}; stale sidecar?")


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

#: one scheduled group: (kind, batch op or -1, chunk-local rows)
_Group = tuple  # (int, int, list[int])


def _row_spans(row: list, no: int, ni: int, op: int
               ) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(writes, reads) as (addr, len) lists.  NET_SEND reads ins[0];
    NET_RECV (its completion) writes outs[0]; FREE touches nothing the
    engine can observe."""
    if op == _FREE:
        return [], []
    writes = [(row[_OUT_OFF + 2 * j], row[_OUT_OFF + 1 + 2 * j])
              for j in range(no) if row[_OUT_OFF + 1 + 2 * j] > 0]
    reads = [(row[_IN_OFF + 2 * j], row[_IN_OFF + 1 + 2 * j])
             for j in range(ni) if row[_IN_OFF + 1 + 2 * j] > 0]
    return writes, reads


def _spans_exact(spans: list[tuple[int, int]]) -> bool:
    """Pairwise identical-or-disjoint check (span-keyed maps are only
    sound under it)."""
    if not spans:
        return True
    seen: dict[int, int] = {}
    for a, ln in spans:
        if seen.setdefault(a, ln) != ln:
            return False
    ss = sorted(seen.items())
    return all(ss[i][0] + ss[i][1] <= ss[i + 1][0]
               for i in range(len(ss) - 1))


def _net_window_groups(rec: np.ndarray, rows: np.ndarray, op: np.ndarray,
                       n_outs: np.ndarray, n_ins: np.ndarray,
                       n_imm: np.ndarray) -> list[_Group]:
    """Greedy list-schedule of one barrier-free window containing NET
    traffic.  Builds the explicit conflict DAG, then repeatedly: issue
    every ready send, post every ready recv, run all ready local rows
    (grouped by shape for the batched drivers), and only when nothing
    else can make progress, complete the earliest outstanding receive."""
    m = len(rows)
    rows_l = rows.tolist()
    rec_l = rec[rows].tolist()
    op_l = op[rows].tolist()
    no_l, ni_l = n_outs[rows].tolist(), n_ins[rows].tolist()

    writes_l, reads_l, all_spans = [], [], []
    for k in range(m):
        wts, rds = _row_spans(rec_l[k], no_l[k], ni_l[k], op_l[k])
        writes_l.append(wts)
        reads_l.append(rds)
        all_spans += wts + rds
    if not _spans_exact(all_spans):
        # address-reuse overlap inside the window: run it in program order
        return [(K_LOCAL, -1, [int(r) for r in rows_l])]

    succ: list[list[int]] = [[] for _ in range(m)]
    indeg = [0] * m
    last_writer: dict[int, int] = {}
    readers: dict[int, list[int]] = {}
    chan: dict[tuple, int] = {}
    for k in range(m):
        deps: set[int] = set()
        for a, _ in reads_l[k]:
            lw = last_writer.get(a)
            if lw is not None:
                deps.add(lw)
            readers.setdefault(a, []).append(k)
        for a, _ in writes_l[k]:
            lw = last_writer.get(a)
            if lw is not None:
                deps.add(lw)
            for rd in readers.get(a, ()):
                if rd != k:
                    deps.add(rd)
            last_writer[a] = k
            readers[a] = []
        o = op_l[k]
        if o == _NET_SEND or o == _NET_RECV:
            # per-(direction, peer, tag) FIFO: keep channel program order
            key = (o, rec_l[k][_IMM_OFF], rec_l[k][_IMM_OFF + 1])
            prev = chan.get(key)
            if prev is not None:
                deps.add(prev)
            chan[key] = k
        for d in deps:
            succ[d].append(k)
            indeg[k] += 1

    r_send: list[int] = []
    r_recv: list[int] = []
    r_local: list[int] = []
    for k in range(m):
        if indeg[k] == 0:
            o = op_l[k]
            (r_send if o == _NET_SEND else
             r_recv if o == _NET_RECV else r_local).append(k)
    heapify(r_send), heapify(r_recv), heapify(r_local)
    posted: list[int] = []          # recv rows posted, not yet waited

    def complete(k: int) -> None:
        for s in succ[k]:
            indeg[s] -= 1
            if indeg[s] == 0:
                o = op_l[s]
                if o == _NET_SEND:
                    heappush(r_send, s)
                elif o == _NET_RECV:
                    heappush(r_recv, s)
                else:
                    heappush(r_local, s)

    groups: list[_Group] = []
    done = 0
    while done < m:
        if r_send:
            batch = []
            while r_send:
                batch.append(heappop(r_send))
            groups.append((K_SEND, -1, [rows_l[k] for k in batch]))
            for k in batch:
                done += 1
                complete(k)
        elif r_recv:
            batch = []
            while r_recv:
                k = heappop(r_recv)
                batch.append(k)
                heappush(posted, k)
            groups.append((K_RECV_POST, -1, [rows_l[k] for k in batch]))
        elif r_local:
            batch = []
            while r_local:
                batch.append(heappop(r_local))
            # all simultaneously-ready rows are pairwise independent
            # (conflicting rows are connected in the DAG); subgroup by
            # shape so the batched drivers can take them in one call
            shape: dict[tuple, list[int]] = {}
            for k in batch:
                row = rec_l[k]
                key = (row[0],
                       tuple(row[_OUT_OFF + 1 + 2 * j]
                             for j in range(no_l[k])),
                       tuple(row[_IN_OFF + 1 + 2 * j]
                             for j in range(ni_l[k])),
                       tuple(row[_IMM_OFF + j]
                             for j in range(int(n_imm[rows_l[k]]))))
                shape.setdefault(key, []).append(k)
            for key, ks in sorted(shape.items(),
                                  key=lambda kv: kv[1][0]):
                g_op = int(key[0] & 0xFFFF) if len(ks) >= 2 else -1
                groups.append((K_LOCAL, g_op, [rows_l[k] for k in ks]))
            for k in batch:
                done += 1
                complete(k)
        elif posted:
            k = heappop(posted)
            groups.append((K_RECV_WAIT, -1, [rows_l[k]]))
            done += 1
            complete(k)
        else:  # pragma: no cover - the DAG is acyclic by construction
            raise AssertionError("overlap scheduler stalled")
    return groups


def _chunk_overlap_groups(rec: np.ndarray | None, m: int) -> list[_Group]:
    """Schedule one program chunk; rows are chunk-local."""
    if rec is None:
        # inexpressible in-memory chunk: record columns unavailable
        return [(K_LOCAL, -1, list(range(m)))]
    op, n_outs, n_ins, n_imm = unpack_heads(rec[:, 0])
    fmask = (rec[:, 0] >> 28) & 0x3F
    barrier = np.isin(op, list(_OVERLAP_BARRIER_OPS)) | (fmask != 0)
    has_net = (op == _NET_SEND) | (op == _NET_RECV)
    free = (op == _FREE) & ~barrier
    groups: list[_Group] = []
    bpos = np.flatnonzero(barrier)
    w0 = 0
    for b in list(bpos) + [m]:
        if b > w0:
            win = np.arange(w0, b, dtype=np.int64)
            fr = win[free[win]]
            if len(fr):
                win = win[~free[win]]
            if len(win):
                if has_net[win].any():
                    groups.extend(_net_window_groups(
                        rec, win, op, n_outs, n_ins, n_imm))
                else:
                    # pure-local window: the batch planner's levelling is
                    # already the best issue order — reuse it verbatim
                    groups.extend(
                        (K_LOCAL, g_op, rws) for g_op, rws in
                        _window_groups(rec, win, op, n_outs, n_ins, n_imm))
            if len(fr):
                groups.append((K_LOCAL, -1, [int(r) for r in fr]))
        if b < m:
            groups.append((K_LOCAL, -1, [int(b)]))
        w0 = b + 1
    # merge adjacent scalar LOCAL groups; demote singleton batch groups
    merged: list[_Group] = []
    for kind, g_op, rws in groups:
        if kind == K_LOCAL and len(rws) < 2:
            g_op = -1
        if (kind == K_LOCAL and g_op == -1 and merged
                and merged[-1][0] == K_LOCAL and merged[-1][1] == -1):
            merged[-1][2].extend(rws)
        else:
            merged.append((kind, g_op, list(rws)))
    return merged


def build_overlap_schedule(prog: Program | ProgramFile,
                           chunk_instrs: int | None = None
                           ) -> OverlapSchedule:
    """One pass over the program's record chunks -> OverlapSchedule.
    Runs on any phase and is O(chunk) in memory; it runs once per plan.
    The engine walks the schedule with the same ``chunk_instrs``, since
    every handle is posted and waited within its chunk."""
    if chunk_instrs is None:
        chunk_instrs = DEFAULT_CHUNK_INSTRS
    order: list[np.ndarray] = []
    bounds = [0]
    group_kind: list[int] = []
    group_op: list[int] = []
    chunk_groups = [0]
    n_records = 0
    for start, rec, instrs in iter_record_chunks(prog, chunk_instrs):
        m = rec.shape[0] if rec is not None else len(instrs)
        n_records += m
        for kind, g_op, rws in _chunk_overlap_groups(rec, m):
            order.append(np.asarray(rws, dtype=np.int64))
            bounds.append(bounds[-1] + len(rws))
            group_kind.append(kind)
            group_op.append(g_op)
        chunk_groups.append(len(group_op))
    return OverlapSchedule(
        chunk_instrs=chunk_instrs,
        n_records=n_records,
        order=(np.concatenate(order) if order
               else np.zeros(0, dtype=np.int64)),
        bounds=np.asarray(bounds, dtype=np.int64),
        group_kind=np.asarray(group_kind, dtype=np.int64),
        group_op=np.asarray(group_op, dtype=np.int64),
        chunk_groups=np.asarray(chunk_groups, dtype=np.int64))
