"""Deterministic storage-timing simulator: the port's copy of
``repro.core.simulator``, host code on NumPy (it prices instructions and
never executes them, so nothing here touches a device).

The paper's headline numbers (Fig. 8-10) are wall-clock on Azure VMs with a
local SSD.  The simulator validates the *memory management* content with a
calibrated replay: per-instruction compute cost from the protocol's cost
model, and a single-queue storage device with latency + bandwidth (§6.4
uses 10 GB/s and 1 ms for the Little's-law sizing of the prefetch buffer;
the default is a cloud-SSD-flavored 1 GB/s / 200 us, both configurable).
Its seconds are outputs of that model, not times taken on any device.

Three scenarios, matching §8.2:
  * Unbounded: sum of compute costs;
  * OS:        demand paging over the *virtual* trace: reactive (a fault
               blocks for the whole transfer), LRU/CLOCK-style eviction,
               optional sequential readahead, asynchronous write-back that
               contends for device bandwidth; per-fault CPU overhead;
  * MAGE:      replay of the planned memory program: ISSUE_* overlap with
               compute; FINISH_* block only until the transfer completes.

Each simulator has TWO cores behind a ``core="array"|"scalar"`` knob
(array is the default; the scalar loops are the JAX package's reference):

  * the array cores consume record chunks and price each chunk with ONE
    vectorized ``cost_chunk`` call (see ``GCCostModel.cost_chunk`` /
    ``CkksCostModel.cost_chunk`` and the rec-level wrapper the scenarios
    harness provides), dropping to scalar handlers only at *events*:
    swap/NET directives in the memory-program replay, residency misses in
    the OS baseline (found by a vectorized probe over the touch arrays,
    the same adaptive-window pattern as replacement's ``_ArrayCore``);

  * results are EXACTLY equal to the scalar cores for any chunk size:
    per-instruction costs are bitwise-identical by the cost models'
    chunk contract, and both cores add compute in turn between events,
    folding it into the clock at the same points.

Where the port departs from the JAX package: the reference's array cores
fold a chunk's costs with the builtin ``sum(costs, start)``, which since
Python 3.12 adds floats with Neumaier's compensated summation, while its
scalar cores add with ``+=``; so under 3.12 its two cores differ in the
last bits.  The port's array cores add one cost at a time
(:func:`_add_in_turn`), so they equal the scalar cores, and the scalar
cores equal the reference's, exactly.

Costs: ``cost`` is a per-instruction callable; if it also exposes
``cost_chunk(rec) -> float64[m]`` over raw record chunks (the scenarios
harness's cost objects do), the array cores use it; otherwise they fall
back to calling the scalar cost per instruction, keeping results
identical but losing the speed edge.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

import numpy as np

from .bytecode import (DEFAULT_CHUNK_INSTRS, INF, _IMM_OFF, _IN_OFF, Instr,
                       Op, Program, ProgramFile, decode_chunk,
                       iter_instructions, iter_record_chunks, unpack_heads)
from .liveness import W_WRITE, iter_touch_chunks
from .replacement import ARRAY_MAX_VPAGES, _check_core


@dataclasses.dataclass
class DeviceModel:
    bandwidth: float = 1.0e9       # bytes/s
    latency: float = 200e-6        # seconds per I/O op (pipelined: adds to
    #                                completion delay, not device occupancy)
    fault_overhead: float = 5e-6   # OS page-fault CPU cost (trap+map+TLB)
    readahead: int = 8             # OS sequential readahead window (pages)
    os_writeback_throttle_s: float = 0.02  # direct-reclaim blocking point


@dataclasses.dataclass
class SimResult:
    total: float = 0.0
    compute: float = 0.0
    stall: float = 0.0
    reads: int = 0
    writes: int = 0
    read_bytes: int = 0        # bytes the device actually transferred
    write_bytes: int = 0
    net_msgs: int = 0          # NET_SEND directives replayed
    net_bytes: int = 0         # bytes those sends would move on the fabric
    net_stall: float = 0.0     # seconds the clock waited on the network

    @property
    def overhead(self) -> float:
        return self.total / self.compute if self.compute else 1.0


CostFn = Callable[[Instr], float]


def _add_in_turn(start: float, costs) -> float:
    """``start + costs[0] + costs[1] + ...``, one addition at a time, as
    the scalar cores' ``+=`` adds (the builtin ``sum`` of floats is
    compensated since Python 3.12, and so would differ in the last bits)."""
    for c in costs:
        start += c
    return start


def _chunk_costs(cost: CostFn, rec: np.ndarray | None, instrs,
                 skip: frozenset) -> list[float]:
    """Per-instruction seconds for one chunk, as a Python float list.

    Prefers the cost object's vectorized ``cost_chunk(rec)``; otherwise
    prices instructions with the scalar callable (ops in ``skip`` — rows
    the scalar reference never prices — get 0.0, which is what the array
    cores' sequential sums need: adding 0.0 is exact)."""
    ck = getattr(cost, "cost_chunk", None)
    if ck is not None and rec is not None:
        costs = np.asarray(ck(rec), dtype=np.float64)
        if skip:
            ops = unpack_heads(rec[:, 0])[0]
            costs = np.where(np.isin(ops, list(skip)), 0.0, costs)
        return costs.tolist()
    if instrs is None:
        instrs = decode_chunk(rec)
    return [0.0 if int(i.op) in skip else cost(i) for i in instrs]


class _Device:
    """Single in-order I/O channel."""

    def __init__(self, model: DeviceModel, page_bytes: int):
        self.m = model
        self.page_bytes = page_bytes
        self.free_at = 0.0
        self.xfer = page_bytes / model.bandwidth

    def submit(self, now: float, pages: int = 1,
               nbytes: int | None = None) -> float:
        """Queue an I/O; returns completion time.  The device pipelines:
        occupancy grows by transfer time only; per-op latency delays the
        completion (queue-depth > 1, as `aio` exploits)."""
        start = max(now, self.free_at)
        xfer = (nbytes / self.m.bandwidth if nbytes is not None
                else pages * self.xfer)
        self.free_at = start + xfer
        return start + xfer + self.m.latency


# ---------------------------------------------------------------------------
# Unbounded
# ---------------------------------------------------------------------------

_SKIP_FREE = frozenset({int(Op.FREE)})


def simulate_unbounded(prog: Program | ProgramFile, cost: CostFn,
                       core: str = "array",
                       chunk_instrs: int = DEFAULT_CHUNK_INSTRS) -> SimResult:
    _check_core(core)
    r = SimResult()
    if core == "scalar":
        for ins in iter_instructions(prog):
            if ins.op not in (Op.FREE,):
                r.compute += cost(ins)
    else:
        comp = 0.0
        for _s, rec, instrs in iter_record_chunks(prog, chunk_instrs):
            comp = _add_in_turn(comp, _chunk_costs(cost, rec, instrs,
                                                  _SKIP_FREE))
        r.compute = comp
    r.total = r.compute
    return r


# ---------------------------------------------------------------------------
# MAGE: memory-program replay
# ---------------------------------------------------------------------------

_E_SWAP_IN = int(Op.SWAP_IN)
_E_SWAP_OUT = int(Op.SWAP_OUT)
_E_ISSUE_IN = int(Op.ISSUE_SWAP_IN)
_E_FINISH_IN = int(Op.FINISH_SWAP_IN)
_E_COPY_OUT = int(Op.COPY_OUT)
_E_ISSUE_OUT = int(Op.ISSUE_SWAP_OUT)
_E_FINISH_OUT = int(Op.FINISH_SWAP_OUT)
_E_NET_SEND = int(Op.NET_SEND)

_MEM_EVENTS = frozenset({_E_SWAP_IN, _E_SWAP_OUT, _E_ISSUE_IN, _E_FINISH_IN,
                         _E_COPY_OUT, _E_ISSUE_OUT, _E_FINISH_OUT,
                         _E_NET_SEND})
_MEM_EVENTS_ARR = np.array(sorted(_MEM_EVENTS), dtype=np.int64)
_MEM_SKIP = frozenset({int(Op.NET_RECV), int(Op.NET_BARRIER), int(Op.FREE)})
_MEM_NONCOMPUTE = _MEM_EVENTS | _MEM_SKIP


class _MemoryReplay:
    """Event-time state of the memory-program replay, shared by both cores:
    the simulated clock, the device, and the in-flight pf-slot completions.
    Pending compute is folded in via :meth:`flush` only at events (and once
    at the end), so both cores add the same floats in the same order."""

    def __init__(self, model: DeviceModel, page_bytes: int, slot_bytes: int,
                 r: SimResult, net_latency_s: float = 0.0,
                 net_bandwidth: float | None = None,
                 net_mode: str = "inorder"):
        self.dev = _Device(model, page_bytes)
        self.page_bytes = page_bytes
        self.slot_bytes = slot_bytes
        self.r = r
        self.t = 0.0
        self.slot_done: dict[int, float] = {}
        self.net_lat = net_latency_s
        self.net_bw = net_bandwidth
        self.net_overlap = net_mode == "overlap"
        # overlap mode: the one-deep latency window of the last message
        # still in flight; local compute between sends hides it
        self.net_due = 0.0

    def settle_net(self) -> None:
        """Charge any still-hidden latency residue (the trailing recv)."""
        if self.net_due > self.t:
            self.r.net_stall += self.net_due - self.t
            self.t = self.net_due

    def flush(self, sub: float) -> None:
        self.t += sub
        self.r.compute += sub

    def event(self, op: int, a: int, b: int, n0: int) -> None:
        """One directive: ``a``/``b`` are imm[0]/imm[1], ``n0`` is
        ins[0]'s slot count (NET_SEND accounting)."""
        r, dev, t = self.r, self.dev, self.t
        if self.net_overlap and self.net_due > 0.0 and op != _E_NET_SEND:
            # swap directives are reorder barriers for NET (the planned
            # scheduler never moves a send/recv across one — residency):
            # every posted recv window must settle before the swap
            if self.net_due > t:
                r.net_stall += self.net_due - t
                t = self.net_due
            self.net_due = 0.0
        if op == _E_SWAP_IN or op == _E_SWAP_OUT:
            done = dev.submit(t)
            r.stall += done - t
            t = done
            if op == _E_SWAP_IN:
                r.reads += 1
                r.read_bytes += self.page_bytes
            else:
                r.writes += 1
                r.write_bytes += self.page_bytes
        elif op == _E_ISSUE_IN:
            self.slot_done[b] = dev.submit(t)
            r.reads += 1
            r.read_bytes += self.page_bytes
        elif op == _E_ISSUE_OUT:
            self.slot_done[b] = dev.submit(t)
            r.writes += 1
            r.write_bytes += self.page_bytes
        elif op == _E_FINISH_IN or op == _E_FINISH_OUT:
            slot = b if op == _E_FINISH_IN else a
            done = self.slot_done.pop(slot, t)
            if done > t:
                r.stall += done - t
                t = done
            if op == _E_FINISH_IN:
                t += self.page_bytes / 50e9  # pf->frame memcpy (~DRAM bw)
        elif op == _E_COPY_OUT:
            t += self.page_bytes / 50e9
        elif op == _E_NET_SEND:
            # accounted like the transport fabric does (send side): the
            # span's slots at the protocol's slot width
            nbytes = n0 * self.slot_bytes
            r.net_msgs += 1
            r.net_bytes += nbytes
            if self.net_lat or self.net_bw:
                xfer = nbytes / self.net_bw if self.net_bw else 0.0
                if self.net_overlap:
                    # sends are hoisted and recv waits deferred, so the
                    # latency windows of every exchange in the barrier
                    # window run concurrently; only the residue of the
                    # latest one past the local work stalls (at the next
                    # barrier or at the end of the program)
                    t += xfer
                    due = t + self.net_lat
                    if due > self.net_due:
                        self.net_due = due
                else:
                    # in-order issue: every exchange is a blocking round
                    r.net_stall += self.net_lat
                    t += xfer + self.net_lat
        self.t = t


def _mem_walk(instrs, cost: CostFn, rp: _MemoryReplay, sub: float) -> float:
    """The scalar reference walk (also prices array-core fallback chunks):
    accumulate compute sequentially, fold at events."""
    for ins in instrs:
        op = int(ins.op)
        if op in _MEM_SKIP:
            continue
        if op in _MEM_EVENTS:
            rp.flush(sub)
            sub = 0.0
            imm = ins.imm
            rp.event(op, imm[0] if imm else 0,
                     imm[1] if len(imm) > 1 else 0,
                     ins.ins[0][1] if ins.ins else 0)
        else:
            sub += cost(ins)
    return sub


def simulate_memory_program(prog: Program | ProgramFile, cost: CostFn,
                            page_bytes: int,
                            model: DeviceModel | None = None,
                            core: str = "array",
                            chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                            net_latency_s: float = 0.0,
                            net_bandwidth: float | None = None,
                            net_mode: str = "inorder") -> SimResult:
    """Replay a 'physical' or 'memory' phase program.

    ``net_latency_s``/``net_bandwidth`` price NET_SEND exchanges on a
    modelled link (both default off — NET then costs nothing, as before).
    ``net_mode`` selects the issue discipline being predicted:

    * ``"inorder"`` — every exchange is a blocking round:
      ``t += xfer + latency`` at each NET_SEND.
    * ``"overlap"`` — the planned out-of-order engine (docs/OVERLAP.md):
      sends are hoisted and recv waits deferred, so the latency windows
      of every exchange between two swap barriers run concurrently and
      hide behind local compute; only the residue of the latest window
      still open at the next barrier (or program end) stalls.
    """
    _check_core(core)
    if net_mode not in ("inorder", "overlap"):
        raise ValueError(f"net_mode must be 'inorder' or 'overlap', "
                         f"got {net_mode!r}")
    model = model or DeviceModel()
    r = SimResult()
    slot_bytes = max(page_bytes // max(prog.page_slots, 1), 1)
    rp = _MemoryReplay(model, page_bytes, slot_bytes, r,
                       net_latency_s=net_latency_s,
                       net_bandwidth=net_bandwidth, net_mode=net_mode)
    if core == "scalar":
        rp.flush(_mem_walk(iter_instructions(prog), cost, rp, 0.0))
    else:
        sub = 0.0
        for _s, rec, instrs in iter_record_chunks(prog, chunk_instrs):
            if rec is None:
                sub = _mem_walk(instrs, cost, rp, sub)
                continue
            costs = _chunk_costs(cost, rec, instrs, _MEM_NONCOMPUTE)
            ops = unpack_heads(rec[:, 0])[0]
            prev = 0
            for e in np.nonzero(np.isin(ops, _MEM_EVENTS_ARR))[0].tolist():
                rp.flush(_add_in_turn(sub, costs[prev:e]))
                sub = 0.0
                row = rec[e]
                rp.event(int(ops[e]), int(row[_IMM_OFF]),
                         int(row[_IMM_OFF + 1]), int(row[_IN_OFF + 1]))
                prev = e + 1
            sub = _add_in_turn(sub, costs[prev:])
        rp.flush(sub)
    rp.settle_net()
    r.total = rp.t
    return r


# ---------------------------------------------------------------------------
# OS demand paging
# ---------------------------------------------------------------------------


class _OsReplay:
    """Event-time state of the OS-paging baseline, shared by both cores:
    the clock, the device, the OS-granularity fault-cluster geometry and
    the write-back throttle.  Residency structures stay core-specific
    (dict/LRU list vs. flat arrays); only the event arithmetic lives here,
    so the two cores cannot drift."""

    def __init__(self, model: DeviceModel, page_bytes: int,
                 os_page_bytes: int | None, r: SimResult):
        self.m = model
        self.dev = _Device(model, page_bytes)
        os_page = os_page_bytes or page_bytes
        self.os_pages_per = max(page_bytes // os_page, 1)
        self.clusters = max(
            (self.os_pages_per + model.readahead - 1) // model.readahead, 1)
        self.cluster_bytes = min(model.readahead * os_page, page_bytes)
        self.page_bytes = page_bytes
        self.r = r
        self.t = 0.0

    def flush(self, sub: float) -> None:
        self.t += sub
        self.r.compute += sub

    def major_fault(self) -> None:
        """Blocking reads at OS granularity: ceil(page/os_page/readahead)
        I/O clusters (Linux swap readahead) plus per-OS-page trap cost."""
        r = self.r
        t = self.t + self.m.fault_overhead * self.os_pages_per
        for _ in range(self.clusters):
            done = self.dev.submit(t, nbytes=self.cluster_bytes)
            r.stall += done - t
            t = done
            r.read_bytes += self.cluster_bytes
        r.reads += 1
        self.t = t

    def writeback(self) -> None:
        """Async write-back of a dirty victim: contends for the device;
        direct-reclaim throttling blocks the faulting process once the
        write-back queue is deep."""
        r = self.r
        now = self.t
        self.dev.submit(now, nbytes=self.page_bytes)
        r.writes += 1
        r.write_bytes += self.page_bytes
        lag = self.dev.free_at - now
        if lag > self.m.os_writeback_throttle_s:
            blocked = lag - self.m.os_writeback_throttle_s
            r.stall += blocked
            self.t = now + blocked

    def fault_run(self, flushes: list, majors: list, wbs: list) -> None:
        """Replay one fault run's per-touch (flush?, major_fault?,
        writeback?) event sequence in a single loop with all clock/device
        state hoisted to locals — arithmetic, operation order and float
        associativity identical to calling ``flush``/``major_fault``/
        ``writeback`` one by one, minus three attribute-dispatched calls
        per faulting touch.  This is the array core's batched thrash
        path; the per-call methods stay the reference (and the scalar
        core's only) entry points."""
        m, dev, r = self.m, self.dev, self.r
        t = self.t
        free_at = dev.free_at
        compute, stall = r.compute, r.stall
        reads, writes = r.reads, r.writes
        read_b, write_b = r.read_bytes, r.write_bytes
        ov = m.fault_overhead * self.os_pages_per
        lat = m.latency
        bw = m.bandwidth
        cb = self.cluster_bytes
        xc = cb / bw
        clusters = self.clusters
        pb = self.page_bytes
        xp = pb / bw
        thr = m.os_writeback_throttle_s
        for j in range(len(majors)):
            f = flushes[j]
            if f is not None:
                t += f
                compute += f
            if majors[j]:
                tt = t + ov
                for _ in range(clusters):
                    start = tt if tt > free_at else free_at
                    free_at = start + xc
                    done = free_at + lat
                    stall += done - tt
                    tt = done
                    read_b += cb
                reads += 1
                t = tt
            if wbs[j]:
                start = t if t > free_at else free_at
                free_at = start + xp
                writes += 1
                write_b += pb
                lag = free_at - t
                if lag > thr:
                    blocked = lag - thr
                    stall += blocked
                    t = t + blocked
        self.t = t
        dev.free_at = free_at
        r.compute, r.stall = compute, stall
        r.reads, r.writes = reads, writes
        r.read_bytes, r.write_bytes = read_b, write_b


def _os_scalar(prog, cost: CostFn, num_frames: int, rp: _OsReplay,
               chunk_instrs: int) -> None:
    """The scalar reference: reactive LRU with blocking major faults."""
    lru: OrderedDict[int, None] = OrderedDict()    # resident pages, LRU order
    dirty: set[int] = set()
    stored: set[int] = set()
    sub = 0.0
    for instrs, offs, pg, fl in iter_touch_chunks(prog, chunk_instrs):
        offs_l = offs.tolist()
        pg_l = pg.tolist()
        fl_l = fl.tolist()
        for i, ins in enumerate(instrs):
            for k in range(offs_l[i], offs_l[i + 1]):
                p = pg_l[k]
                if p in lru:
                    lru.move_to_end(p)
                else:
                    rp.flush(sub)
                    sub = 0.0
                    if p in stored:
                        rp.major_fault()
                    # else: first touch, anonymous page, no I/O
                    while len(lru) >= num_frames:
                        victim, _ = lru.popitem(last=False)
                        if victim in dirty:
                            dirty.discard(victim)
                            stored.add(victim)
                            rp.writeback()
                    lru[p] = None
                if fl_l[k] & W_WRITE:
                    dirty.add(p)
            sub += cost(ins)
    rp.flush(sub)


class _OsArrayCore:
    """Vectorized residency probe over the touch arrays; scalar fault /
    evict handling only on misses (the ``_ArrayCore`` adaptive-window
    pattern).  State: per-frame page/last-touch/dirty vectors plus
    growable per-page slot/stored vectors — array analogues of the
    scalar core's LRU dict, with the LRU order recovered exactly as the
    argmin of last-touch indices (touch indices are globally unique, so
    the victim matches the OrderedDict's pop order)."""

    def __init__(self, num_frames: int, rp: _OsReplay):
        self.nf = num_frames
        self.rp = rp
        self.slot_of = np.full(1024, -1, dtype=np.int64)
        self.stored = np.zeros(1024, dtype=bool)
        self.page_of = np.full(num_frames, -1, dtype=np.int64)
        self.last_touch = np.full(num_frames, INF, dtype=np.int64)
        self.dirty_of = np.zeros(num_frames, dtype=bool)
        self.free = list(range(num_frames - 1, -1, -1))
        self.used = 0
        self.base = 0                  # global touch index of chunk start
        self.win = _OS_PROBE_MAX
        self._cand: list[tuple[int, int]] = []   # LRU victim candidates
        self._ci = 0

    def _grow(self, max_page: int) -> None:
        if max_page < self.slot_of.shape[0]:
            return
        n = max(max_page + 1, 2 * self.slot_of.shape[0])
        s2 = np.full(n, -1, dtype=np.int64)
        s2[:self.slot_of.shape[0]] = self.slot_of
        self.slot_of = s2
        st2 = np.zeros(n, dtype=bool)
        st2[:self.stored.shape[0]] = self.stored
        self.stored = st2

    def _evict_frame(self) -> int:
        """The LRU victim: the frame with the globally smallest last-touch
        index.  Per-eviction argmin is O(frames) — too slow at fig9-scale
        working sets — so victims come from a snapshot of the 1024 smallest
        keys (one argpartition, amortized over the burst of evictions that
        follows).  Touch indices only ever grow, so a candidate whose key
        is unchanged since the snapshot is still the global minimum: every
        non-candidate exceeded the snapshot's largest key then and has only
        grown, and any candidate touched since (or any newly faulted-in
        page) carries a more recent — larger — index.  Stale entries are
        skipped; an exhausted queue re-snapshots.  Exactly the argmin (and
        the scalar OrderedDict pop order), tested bitwise."""
        lt = self.last_touch
        while True:
            while self._ci < len(self._cand):
                key, f = self._cand[self._ci]
                self._ci += 1
                if key < INF and lt[f] == key:
                    return f
            k = min(self.nf, 1024)
            if k == self.nf:
                idx = np.argsort(lt)
            else:
                part = np.argpartition(lt, k - 1)[:k]
                idx = part[np.argsort(lt[part])]
            self._cand = list(zip(lt[idx].tolist(), idx.tolist()))
            self._ci = 0
            if not self._cand:
                raise RuntimeError("no frame to evict (num_frames == 0)")

    def _take_victims(self, want: int) -> list[int]:
        """Up to ``want`` LRU victim frames from the candidate snapshot,
        in eviction order, WITHOUT booking the evictions — the batched
        fault-run path books them in one vectorized sweep.  Exactly the
        frames ``_evict_frame`` would return: candidate validity is
        static during a run (evicted frames go to ``INF``, and only
        already-consumed or free — ``INF``-keyed, hence invalid —
        candidates are ever reassigned), so the stale-check can run as
        one vectorized pass over the remaining snapshot.  May return
        fewer than ``want`` (snapshot exhausted): the caller shrinks the
        run and the scalar path re-snapshots."""
        out: list[int] = []
        lt = self.last_touch
        while len(out) < want and self._ci < len(self._cand):
            # bounded block scan: short runs must not pay a rescan of the
            # whole (possibly stale) remainder on every call
            blk = max(2 * (want - len(out)), 64)
            rem = self._cand[self._ci:self._ci + blk]
            keys = np.fromiter((c[0] for c in rem), np.int64, count=len(rem))
            frs = np.fromiter((c[1] for c in rem), np.int64, count=len(rem))
            vpos = np.flatnonzero((keys < INF) & (lt[frs] == keys))
            vpos = vpos[:want - len(out)]
            if vpos.size:
                out.extend(frs[vpos].tolist())
                self._ci += int(vpos[-1]) + 1
            else:
                self._ci += len(rem)
        return out

    def _fault_run(self, m0: int, stop: int, pg: np.ndarray, wm: np.ndarray,
                   rows_l: list, costs: list, ci: int, sub: float) -> int:
        """Batch one run of consecutive all-miss touches on pairwise-
        distinct pages (the thrash pattern: every touch faults, one page
        per touch).  Replay events — compute flushes at instruction
        boundaries, major faults, victim write-backs — fire one by one in
        exactly the scalar order (the device model is order-sensitive),
        but all residency bookkeeping (LRU stamps, slot/frame/dirty/
        stored vectors, victim selection) runs as vectorized sweeps.
        Returns the first unprocessed touch (== ``m0`` when the victim
        snapshot is empty and the caller should take the scalar path).

        Exactness: probe misses stay misses (evictions never make a page
        resident, and distinct pages rule out an earlier fault of the
        run resupplying a later touch), victim pages are resident and so
        disjoint from the run's pages (their ``stored`` promotion cannot
        retag a run page), and the touch→frame pairing replays the
        scalar free-list pops and candidate consumption in order."""
        rp = self.rp
        n = stop - m0
        pages = pg[m0:stop]
        stored_f = self.stored[pages]
        nf0 = min(n, self.nf - self.used)
        vf_list = self._take_victims(n - nf0) if n > nf0 else []
        if nf0 + len(vf_list) < n:
            n = nf0 + len(vf_list)
            if n < _OS_RUN_MIN:
                return m0
            stop = m0 + n
            pages = pages[:n]
            stored_f = stored_f[:n]
        nev = len(vf_list)
        vf = np.asarray(vf_list, dtype=np.int64)
        vdirty = self.dirty_of[vf] if nev else np.zeros(0, dtype=bool)
        # replay events in exact scalar order: per missing touch, flush
        # the compute accrued since the last fault, then the major fault,
        # then its eviction's write-back — one hoisted-locals loop
        st_l = stored_f.tolist()
        wb_l = [False] * nf0 + vdirty.tolist()
        flushes: list = [None] * n
        cur = ci
        for j in range(n):
            r = rows_l[m0 + j]
            if j == 0 or r > cur:
                flushes[j] = _add_in_turn(sub, costs[cur:r])
                sub = 0.0
                cur = r
        rp.fault_run(flushes, st_l, wb_l)
        # vectorized bookkeeping: release victims, then assign frames in
        # scalar pairing order (free-list tail pops first, then victims)
        if nev:
            vq = self.page_of[vf]
            self.stored[vq[vdirty]] = True
            self.slot_of[vq] = -1
        if nf0:
            frames = self.free[-nf0:][::-1] + vf_list
            del self.free[-nf0:]
        else:
            frames = vf_list
        fr = np.asarray(frames, dtype=np.int64)
        self.slot_of[pages] = fr
        self.page_of[fr] = pages
        self.dirty_of[fr] = wm[m0:stop]
        self.last_touch[fr] = self.base + np.arange(m0, stop, dtype=np.int64)
        self.used += n - nev
        return stop

    def _touch(self, k: int, pg_l: list, fl_l: list) -> None:
        """One scalar touch: exactly ``_os_scalar``'s per-touch body."""
        p = pg_l[k]
        s = int(self.slot_of[p])
        if s < 0:
            rp = self.rp
            if self.stored[p]:
                rp.major_fault()
            while self.used >= self.nf:
                vf = self._evict_frame()
                vq = int(self.page_of[vf])
                if self.dirty_of[vf]:
                    self.dirty_of[vf] = False
                    self.stored[vq] = True
                    rp.writeback()
                self.slot_of[vq] = -1
                self.page_of[vf] = -1
                self.last_touch[vf] = INF
                self.free.append(vf)
                self.used -= 1
            s = self.free.pop()
            self.slot_of[p] = s
            self.page_of[s] = p
            self.dirty_of[s] = False
            self.used += 1
        self.last_touch[s] = self.base + k
        if fl_l[k] & W_WRITE:
            self.dirty_of[s] = True

    def process_chunk(self, m: int, offs: np.ndarray, pg: np.ndarray,
                      fl: np.ndarray, costs: list[float],
                      sub: float) -> float:
        """Transduce one chunk's touches; returns the pending compute."""
        T = pg.shape[0]
        if T:
            self._grow(int(pg.max()))
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(offs))
        wm = (fl & W_WRITE) != 0
        offs_l = offs.tolist()
        pg_l = pg.tolist()
        fl_l = fl.tolist()
        rows_l = rows.tolist()
        slot_of = self.slot_of
        ci = 0                     # first instruction not yet priced
        k = 0
        win = self.win
        while k < T:
            end = min(k + win, T)
            sl = slot_of[pg[k:end]]
            missrel = np.nonzero(sl < 0)[0]
            m0 = k + int(missrel[0]) if missrel.size else end
            if m0 > k:
                seg = slice(k, m0)
                ssl = sl[:m0 - k]
                # hits never evict, so the probe's verdict holds for the
                # whole clean prefix: batch the LRU/dirty bookkeeping
                self.last_touch[ssl] = self.base + np.arange(
                    k, m0, dtype=np.int64)
                self.dirty_of[ssl[wm[seg]]] = True
            if m0 < end:
                # maximal run of consecutive probe-miss touches with
                # pairwise-distinct pages: thrash traces fault on every
                # touch, and handling those runs one by one in Python is
                # what degenerated the array core to ~2-5x scalar — batch
                # them through _fault_run instead
                mrel = sl[m0 - k:]
                res = np.flatnonzero(mrel >= 0)
                stop = m0 + (int(res[0]) if res.size else len(mrel))
                if stop - m0 >= _OS_RUN_MIN:
                    stop = _unique_prefix(pg, m0, stop)
                done = m0
                if stop - m0 >= _OS_RUN_MIN:
                    done = self._fault_run(m0, stop, pg, wm, rows_l,
                                           costs, ci, sub)
                if done > m0:
                    ci = rows_l[done - 1]
                    sub = 0.0
                    if done == end:   # all-miss probe: thrash, widen
                        win = min(win * 2, _OS_PROBE_MAX)
                    else:
                        win = max(_OS_PROBE_MIN, min(win, 2 * (m0 - k + 8)))
                    k = done
                    continue
                i = rows_l[m0]
                self.rp.flush(_add_in_turn(sub, costs[ci:i]))
                sub = 0.0
                ci = i
                row_end = offs_l[i + 1]
                for kk in range(m0, row_end):
                    self._touch(kk, pg_l, fl_l)
                win = max(_OS_PROBE_MIN, min(win, 2 * (m0 - k + 8)))
                k = row_end
            else:
                k = end
                win = min(win * 2, _OS_PROBE_MAX)
        self.win = win
        self.base += T
        return _add_in_turn(sub, costs[ci:m])


_OS_PROBE_MAX = 8192
_OS_PROBE_MIN = 32
#: below this, a fault run is not worth the vectorized setup
_OS_RUN_MIN = 8


def _unique_prefix(pg: np.ndarray, m0: int, stop: int) -> int:
    """Largest ``stop' <= stop`` such that ``pg[m0:stop']`` has pairwise
    distinct pages (the fault-run batcher's precondition: a duplicate
    would be a hit after its first occurrence faults the page in)."""
    run = pg[m0:stop]
    srt = np.argsort(run, kind="stable")
    v = run[srt]
    dup = v[1:] == v[:-1]
    if not dup.any():
        return stop
    # stable sort keeps equal pages in touch order, so srt[1:][dup] are
    # second-and-later occurrences; the earliest one ends the prefix
    return m0 + int(srt[1:][dup].min())


def simulate_os_paging(virtual_prog: Program | ProgramFile, cost: CostFn,
                       num_frames: int, page_bytes: int,
                       model: DeviceModel | None = None,
                       os_page_bytes: int | None = None,
                       chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                       core: str = "array") -> SimResult:
    """Demand paging over the virtual trace: the OS-swapping baseline.

    Reactive LRU with blocking major faults.  The OS works at its own page
    granularity (``os_page_bytes``, default = MAGE page size): faulting one
    MAGE-page worth of data costs ceil(page/os_page/readahead) blocking I/O
    clusters (Linux swap readahead) plus a per-OS-page fault overhead
    (trap + map + TLB).  Dirty evictions write back asynchronously but
    contend for the device.  No future knowledge (no dead-page drop, no
    planned prefetch) — that is exactly what MAGE adds.

    ``read_bytes``/``write_bytes`` report what the device actually
    transferred: fault clusters at OS readahead granularity (which can
    exceed the page size when the cluster count rounds up) and
    whole-page write-backs.

    Streaming-capable: the trace is consumed as chunks (a ``ProgramFile``
    is never materialized, and in-memory programs never grow a
    program-length touch sidecar), so the full §8.2 scenario path is
    O(frames + chunk) in simulator memory.
    """
    _check_core(core)
    if core == "array" and virtual_prog.num_vpages() >= ARRAY_MAX_VPAGES:
        # the array core keeps O(num_vpages) slot/stored vectors (the
        # analogue of replacement's per-page state); past this bound the
        # scalar core's dicts — O(touched pages) — are the leaner choice.
        # Results are identical either way.
        core = "scalar"
    model = model or DeviceModel()
    r = SimResult()
    rp = _OsReplay(model, page_bytes, os_page_bytes, r)
    if core == "scalar":
        _os_scalar(virtual_prog, cost, num_frames, rp, chunk_instrs)
    else:
        ac = _OsArrayCore(num_frames, rp)
        need_instrs = getattr(cost, "cost_chunk", None) is None
        sub = 0.0
        for head, offs, pg, fl, rec in iter_touch_chunks(
                virtual_prog, chunk_instrs, decode=need_instrs,
                records=True):
            if rec is not None and not need_instrs:
                m = head if isinstance(head, int) else len(head)
                costs = np.asarray(cost.cost_chunk(rec),
                                   dtype=np.float64).tolist()
            else:
                m = len(head)
                costs = [cost(i) for i in head]
            sub = ac.process_chunk(m, offs, pg, fl, costs, sub)
        rp.flush(sub)
    r.total = rp.t
    return r
