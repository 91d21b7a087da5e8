"""Batch planner: turn a scheduled memory program into a *batch schedule*.

The port's copy of ``repro.exec.batching``, over a program in memory or
a program file, streamed chunk by chunk (saving a schedule to disk and
its cache wait for a later slice).

MAGE's premise is that SC programs are oblivious — the instruction stream
is fixed before execution.  The same property that lets the planner
precompute a memory plan lets this pass precompute, once per plan, which
instructions can be dispatched together: within every window of compute
instructions between engine-level barriers (swap/NET directives, INPUT,
OUTPUT), instructions are levelled by operand-span dependencies and grouped
by (level, op, signature).  Each group is a set of *independent, identically
shaped* instructions the batched drivers (``exec.batched_gc`` /
``exec.batched_ckks``) execute as one gathered call instead of one Python
dispatch per instruction.

Correctness argument for the reorder: two instructions conflict iff any of
their operand spans overlap (RAW, WAW and WAR all force ordering, and the
level recurrence bumps past all three), so any two instructions on the same
level are independent and groups emitted level-ascending form a valid
topological order of the window.  Barriers (directives, INPUT, OUTPUT,
float-immediate rows) are never reordered — channel, RNG and I/O order is
exactly program order.  Operand spans in this DSL are exact allocation
spans, so spans are pairwise identical-or-disjoint; the builder *verifies*
that per window (one vectorized sweep) and falls back to scalar order for
any window where it does not hold.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.bytecode import (DEFAULT_CHUNK_INSTRS, DIRECTIVES, MAX_INS,
                             MAX_OUTS, _IMM_OFF, _IN_OFF, _OUT_OFF, Op,
                             Program, ProgramFile, iter_record_chunks,
                             unpack_heads)

#: ops whose side effects pin them to program order: engine directives
#: (swaps, NET traffic) and I/O against the input provider / output
#: channel.  FREE is *not* a barrier: the engine executes it as a no-op
#: (allocator bookkeeping lives in the planner), and any reuse of a freed
#: address shows up as an ordinary span conflict to the leveller — so
#: unbounded/virtual traces, which carry one FREE per dead value, still
#: form large batchable windows.
_BARRIER_OPS = frozenset(int(o) for o in DIRECTIVES) | {
    int(Op.INPUT), int(Op.OUTPUT)}

#: below this window size, a failed span-exactness check falls back to
#: scalar order instead of bisecting further
_MIN_SPLIT = 32

#: the saved schedule's format (the JAX package's): an npz of int64 arrays
SCHEDULE_VERSION = 1


@dataclasses.dataclass
class BatchSchedule:
    """Precomputed execution order for one worker's memory program.

    Flat-array encoding (all int64), chunk-aligned to ``chunk_instrs`` so a
    streaming engine walks it with zero random access:

    * ``order``        — chunk-LOCAL row indices, concatenated group by
                         group over all chunks;
    * ``bounds``       — ``n_groups + 1`` offsets into ``order``;
    * ``group_op``     — per group, the shared opcode, or ``-1`` for a
                         scalar group (barriers and fallback windows) whose
                         rows run one by one in stored order;
    * ``chunk_groups`` — ``n_chunks + 1`` offsets into ``group_op``:
                         groups ``chunk_groups[c]:chunk_groups[c+1]``
                         belong to program chunk ``c``.

    Groups never cross chunk (or barrier) boundaries.  A group with
    ``group_op >= 0`` is *structurally* batchable — uniform op, immediates
    and span lengths, mutually independent; whether it actually runs
    batched is the driver's call (``batch_ops`` membership, group size).
    """

    chunk_instrs: int
    n_records: int
    order: np.ndarray
    bounds: np.ndarray
    group_op: np.ndarray
    chunk_groups: np.ndarray

    @property
    def n_groups(self) -> int:
        return len(self.group_op)

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_groups) - 1

    def stats(self) -> dict:
        sizes = np.diff(self.bounds)
        batchable = self.group_op >= 0
        big = batchable & (sizes >= 2)
        return {
            "n_records": int(self.n_records),
            "n_chunks": int(self.n_chunks),
            "n_groups": int(self.n_groups),
            "batchable_groups": int(big.sum()),
            "batchable_instructions": int(sizes[big].sum()),
            "scalar_instructions": int(sizes[~big].sum()),
            "max_batch": int(sizes[batchable].max()) if batchable.any()
            else 0,
        }

    def save(self, path: str | os.PathLike) -> None:
        """Write the schedule as the JAX package's npz sidecar (the same
        keys, every array int64), so either package loads the other's."""
        with open(path, "wb") as f:
            np.savez(f,
                     version=np.array([SCHEDULE_VERSION], dtype=np.int64),
                     chunk_instrs=np.array([self.chunk_instrs],
                                           dtype=np.int64),
                     n_records=np.array([self.n_records], dtype=np.int64),
                     order=self.order.astype(np.int64),
                     bounds=self.bounds.astype(np.int64),
                     group_op=self.group_op.astype(np.int64),
                     chunk_groups=self.chunk_groups.astype(np.int64))

    @classmethod
    def load(cls, path: str | os.PathLike) -> "BatchSchedule":
        with np.load(path) as z:
            ver = int(z["version"][0])
            if ver != SCHEDULE_VERSION:
                raise ValueError(
                    f"batch schedule version {ver} != {SCHEDULE_VERSION}")
            return cls(chunk_instrs=int(z["chunk_instrs"][0]),
                       n_records=int(z["n_records"][0]),
                       order=z["order"], bounds=z["bounds"],
                       group_op=z["group_op"],
                       chunk_groups=z["chunk_groups"])

    def validate_for(self, prog: Program | ProgramFile) -> None:
        n = len(prog)
        if n != self.n_records:
            raise ValueError(
                f"batch schedule covers {self.n_records} records but the "
                f"program has {n}; stale sidecar?")


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


def _bisect_window(rec: np.ndarray, rows: np.ndarray, op: np.ndarray,
                   n_outs: np.ndarray, n_ins: np.ndarray, n_imm: np.ndarray,
                   ) -> list[tuple[int, list[int]]]:
    """Span-exactness failed for this window: rather than running the
    whole window scalar, bisect it — the two halves execute in program
    order, so each only has to satisfy the check locally.  One address
    reuse at a phase boundary then costs ~log2(window) small fallbacks
    instead of poisoning thousands of batchable rows."""
    if len(rows) < 2 * _MIN_SPLIT:
        return [(-1, [int(r) for r in rows])]
    h = len(rows) // 2
    return (_window_groups(rec, rows[:h], op, n_outs, n_ins, n_imm)
            + _window_groups(rec, rows[h:], op, n_outs, n_ins, n_imm))


def _window_groups(rec: np.ndarray, rows: np.ndarray, op: np.ndarray,
                   n_outs: np.ndarray, n_ins: np.ndarray, n_imm: np.ndarray,
                   ) -> list[tuple[int, list[int]]]:
    """Level + group one barrier-free window; returns ``(op, rows)`` pairs
    in a dependency-valid execution order (op == -1 => scalar fallback)."""
    # all operand spans of the window, one (addr, len) pair per slot
    slot_offs = [_OUT_OFF + 2 * j for j in range(MAX_OUTS)] + \
        [_IN_OFF + 2 * j for j in range(MAX_INS)]
    addr_cols = rec[np.ix_(rows, slot_offs)]
    len_cols = rec[np.ix_(rows, [o + 1 for o in slot_offs])]
    arity = np.concatenate([n_outs[rows, None] > np.arange(MAX_OUTS),
                            n_ins[rows, None] > np.arange(MAX_INS)], axis=1)
    live = arity & (len_cols > 0)
    addrs = addr_cols[live]
    lens = len_cols[live]
    if len(addrs) == 0:
        # no operands at all: nothing to batch, keep program order
        return [(-1, [int(r) for r in rows])]
    # spans must be pairwise identical-or-disjoint for span-keyed levelling
    order = np.lexsort((lens, addrs))
    a, ln = addrs[order], lens[order]
    same = a[1:] == a[:-1]
    if np.any(same & (ln[1:] != ln[:-1])):
        return _bisect_window(rec, rows, op, n_outs, n_ins, n_imm)
    keep = np.concatenate([[True], ~same])
    ua, ul = a[keep], ln[keep]
    if np.any(ua[1:] < ua[:-1] + ul[:-1]):
        return _bisect_window(rec, rows, op, n_outs, n_ins, n_imm)
    # span id per live slot; -1 for dead slots
    sid = np.full(addr_cols.shape, -1, dtype=np.int64)
    sid[live] = np.searchsorted(ua, addrs)
    wl = np.zeros(len(ua), dtype=np.int64)   # last writer level per span
    rl = np.zeros(len(ua), dtype=np.int64)   # max reader level per span
    sid_l = sid.tolist()
    no_l, ni_l = n_outs[rows].tolist(), n_ins[rows].tolist()
    groups: dict[tuple, list[int]] = {}
    rec_l = rec[rows].tolist()
    rows_l = rows.tolist()
    for k, r in enumerate(rows_l):
        srow = sid_l[k]
        no, ni = no_l[k], ni_l[k]
        lvl = 0
        for j in range(no):
            s = srow[j]
            if s >= 0:
                if wl[s] > lvl:
                    lvl = wl[s]
                if rl[s] > lvl:
                    lvl = rl[s]
        for j in range(ni):
            s = srow[MAX_OUTS + j]
            if s >= 0 and wl[s] > lvl:
                lvl = wl[s]
        lvl += 1
        for j in range(ni):
            s = srow[MAX_OUTS + j]
            if s >= 0 and rl[s] < lvl:
                rl[s] = lvl
        for j in range(no):
            s = srow[j]
            if s >= 0:
                wl[s] = lvl
        row = rec_l[k]
        key = (lvl, row[0],
               tuple(row[_OUT_OFF + 1 + 2 * j] for j in range(no)),
               tuple(row[_IN_OFF + 1 + 2 * j] for j in range(ni)),
               tuple(row[_IMM_OFF + j] for j in range(int(n_imm[r]))))
        groups.setdefault(key, []).append(r)
    # level-ascending, then first-row order: a valid topological order
    out = sorted(groups.items(), key=lambda kv: (kv[0][0], kv[1][0]))
    return [(int(k[1] & 0xFFFF), rws) for k, rws in out]


def _chunk_groups(start: int, rec: np.ndarray | None, m: int
                  ) -> list[tuple[int, list[int]]]:
    """Group one program chunk; rows are chunk-local."""
    if rec is None:
        # inexpressible in-memory chunk (wide arity / object immediates):
        # the record columns are unavailable, run it scalar
        return [(-1, list(range(m)))]
    op, n_outs, n_ins, n_imm = unpack_heads(rec[:, 0])
    fmask = (rec[:, 0] >> 28) & 0x3F
    barrier = np.isin(op, list(_BARRIER_OPS)) | (fmask != 0)
    free = (op == int(Op.FREE)) & ~barrier
    groups: list[tuple[int, list[int]]] = []
    bpos = np.flatnonzero(barrier)
    w0 = 0
    for b in list(bpos) + [m]:
        if b > w0:
            win = np.arange(w0, b, dtype=np.int64)
            # FREE rows are engine no-ops: hoist them out of the window
            # (they would otherwise fragment the span-conflict levelling
            # with dead allocator spans) and replay them after it
            fr = win[free[win]]
            if len(fr):
                win = win[~free[win]]
            if len(win):
                groups.extend(
                    _window_groups(rec, win, op, n_outs, n_ins, n_imm))
            if len(fr):
                groups.append((-1, [int(r) for r in fr]))
        if b < m:
            groups.append((-1, [int(b)]))
        w0 = b + 1
    # merge adjacent scalar groups (their rows stay in program order);
    # singleton "batchable" groups are demoted first — the engine would
    # run them scalar anyway, and merging shrinks the group stream
    merged: list[tuple[int, list[int]]] = []
    for g_op, rws in groups:
        if len(rws) < 2:
            g_op = -1
        if g_op == -1 and merged and merged[-1][0] == -1:
            merged[-1][1].extend(rws)
        else:
            merged.append((g_op, list(rws)))
    return merged


def build_batch_schedule(prog: Program | ProgramFile,
                         chunk_instrs: int | None = None) -> BatchSchedule:
    """One pass over the memory program's record chunks -> BatchSchedule.
    Runs on any phase, streams a ProgramFile chunk by chunk and is
    O(chunk) in memory; intended to run once per plan."""
    if chunk_instrs is None:
        chunk_instrs = DEFAULT_CHUNK_INSTRS
    order: list[np.ndarray] = []
    bounds = [0]
    group_op: list[int] = []
    chunk_groups = [0]
    n_records = 0
    for start, rec, instrs in iter_record_chunks(prog, chunk_instrs):
        m = rec.shape[0] if rec is not None else len(instrs)
        n_records += m
        for g_op, rws in _chunk_groups(start, rec, m):
            order.append(np.asarray(rws, dtype=np.int64))
            bounds.append(bounds[-1] + len(rws))
            group_op.append(g_op)
        chunk_groups.append(len(group_op))
    return BatchSchedule(
        chunk_instrs=chunk_instrs,
        n_records=n_records,
        order=(np.concatenate(order) if order
               else np.zeros(0, dtype=np.int64)),
        bounds=np.asarray(bounds, dtype=np.int64),
        group_op=np.asarray(group_op, dtype=np.int64),
        chunk_groups=np.asarray(chunk_groups, dtype=np.int64))
