"""MAGE planner stage 3: scheduling (§6.4).

The port's copy of ``repro.core.scheduling``: the scalar reference core,
the record-array core (instruction-identical to it) and the out-of-core
file stage.

Transforms the 'physical' program (synchronous SWAP_IN/SWAP_OUT) into the
final memory program: every swap-in is split into an ISSUE_SWAP_IN hoisted up
to ``lookahead`` instructions earlier — into a slot of a ``prefetch_pages``-
sized prefetch buffer — and a FINISH_SWAP_IN at the use site that waits and
copies the page into its destination frame.  Evictions become COPY_OUT (frame
→ buffer) + ISSUE_SWAP_OUT, with FINISH_SWAP_OUT deferred until a buffer slot
must be reclaimed (oldest-first), exactly as in the paper.

Hazards handled:
  * read-after-write: an ISSUE_SWAP_IN for page p never overtakes an
    outstanding ISSUE_SWAP_OUT of p — we force a FINISH_SWAP_OUT first
    (or, with ``swap_bypass`` — beyond-paper — serve the read straight from
    the write's buffer slot with zero I/O);
  * buffer pressure: if no slot is free we first retire the oldest write;
    if none exists we cancel the youngest not-yet-needed prefetch; as a last
    resort the swap-in degrades to a synchronous issue+finish at the use site
    (the paper's FINISH-SWAP-IN fallback).

The replacement stage must have been run with T - B frames; the planner
pipeline (planner.py) owns that arithmetic.
"""

from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict, deque
from typing import Callable, Iterable, Iterator

import numpy as np

from .bytecode import (DEFAULT_CHUNK_INSTRS, RECORD_WORDS, _IMM_OFF, _IN_OFF,
                       _OUT_OFF, Instr, Op, Program, ProgramFile,
                       decode_chunk, encode_chunk, pack_row, unpack_heads,
                       writer_like)


@dataclasses.dataclass
class ScheduleStats:
    prefetched: int = 0          # swap-ins issued ahead of use
    sync_fallbacks: int = 0      # swap-ins issued at the use site
    canceled_prefetches: int = 0
    forced_write_finishes: int = 0
    bypass_hits: int = 0         # reads served from a pending write's slot
    swap_outs: int = 0
    lookahead: int = 0
    prefetch_pages: int = 0


@dataclasses.dataclass
class _PendingWrite:
    vpage: int
    slot: int
    order: int


def _schedule_core(src: Iterable[Instr], lookahead: int, B: int,
                   swap_bypass: bool, reserve: int,
                   emit: Callable[[Instr], None],
                   stats: ScheduleStats) -> None:
    """Streaming prefetch transducer: O(lookahead + B) state.

    Instead of pre-scanning the whole program for upcoming swap-ins (which
    would materialize it), the core keeps a sliding window of the next
    ``lookahead`` instructions — by construction the only ones an
    ISSUE_SWAP_IN may be hoisted across — and discovers reads as the window
    advances.  A read of page p must not be issued before p's latest
    preceding SWAP_OUT site (the page is not on storage yet before that
    point); ``last_out`` tracks those sites as they are scanned.
    """
    it = iter(src)
    window: deque[Instr] = deque()          # instructions [pos, scanned)
    reads: deque[tuple[int, int, tuple, int]] = deque()
    last_out: dict[int, int] = {}
    scanned = 0
    exhausted = False

    def scan_to(limit: int) -> None:
        # ensure every position <= limit has been scanned into the window
        nonlocal scanned, exhausted
        while not exhausted and scanned <= limit:
            nxt = next(it, None)
            if nxt is None:
                exhausted = True
                return
            if nxt.op == Op.SWAP_OUT:
                last_out[nxt.imm[0]] = scanned
            elif nxt.op == Op.SWAP_IN:
                p = nxt.imm[0]
                reads.append((scanned, p, nxt.outs[0],
                              last_out.get(p, -1) + 1))
            window.append(nxt)
            scanned += 1

    free_slots = list(range(B - 1, -1, -1))
    # issued reads keyed by their USE SITE position (unique — a page can
    # have several in-flight reads when clean evictions skip write-backs)
    read_slot: dict[int, int] = {}             # use_pos -> slot
    issue_order: list[int] = []                # use_pos, youngest last
    writes: OrderedDict[int, _PendingWrite] = OrderedDict()  # vpage -> pending
    bypass_ready: dict[int, int] = {}          # use_pos -> slot
    wcount = 0

    def finish_oldest_write() -> bool:
        if not writes:
            return False
        vp, pw = writes.popitem(last=False)
        emit(Instr(Op.FINISH_SWAP_OUT, imm=(pw.slot,)))
        free_slots.append(pw.slot)
        stats.forced_write_finishes += 1
        return True

    def cancel_youngest_read() -> bool:
        # cancel an issued-but-unused prefetch to reclaim its slot; its use
        # site then takes the sync-fallback path
        while issue_order:
            up = issue_order.pop()
            if up in read_slot:
                slot = read_slot.pop(up)
                # engine must still drain the in-flight DMA before reuse:
                emit(Instr(Op.FINISH_SWAP_OUT, imm=(slot,)))  # wait
                free_slots.append(slot)
                stats.canceled_prefetches += 1
                return True
        return False

    def get_slot(allow_cancel: bool) -> int | None:
        if free_slots:
            return free_slots.pop()
        if finish_oldest_write():
            return free_slots.pop()
        if allow_cancel and cancel_youngest_read():
            return free_slots.pop()
        return None

    def try_issue_read(pos_now: int) -> None:
        while reads and reads[0][0] - lookahead <= pos_now:
            if len(read_slot) >= B - reserve:
                break  # keep `reserve` slots available for evictions
            use_pos, vpage, frame_span, min_issue = reads[0]
            if use_pos <= pos_now:
                break  # its own use site handles it (sync fallback)
            if min_issue > pos_now:
                break  # page not on storage yet: wait for its swap-out site
            if vpage in writes:
                pw = writes[vpage]
                if swap_bypass:
                    # serve the future read straight from the write's slot
                    del writes[vpage]
                    bypass_ready[use_pos] = pw.slot
                    stats.bypass_hits += 1
                    reads.popleft()
                    continue
                emit(Instr(Op.FINISH_SWAP_OUT, imm=(pw.slot,)))
                free_slots.append(pw.slot)
                del writes[vpage]
                stats.forced_write_finishes += 1
            slot = get_slot(allow_cancel=False)
            if slot is None:
                break  # buffer full of useful work; retry next step
            emit(Instr(Op.ISSUE_SWAP_IN, imm=(vpage, slot)))
            read_slot[use_pos] = slot
            issue_order.append(use_pos)
            stats.prefetched += 1
            reads.popleft()

    pos = 0
    while True:
        scan_to(pos + lookahead)
        if not window:
            break
        ins = window.popleft()
        try_issue_read(pos)
        if ins.op == Op.SWAP_IN:
            vpage = ins.imm[0]
            if reads and reads[0][0] == pos:
                reads.popleft()  # this site was not prefetched
            if pos in bypass_ready:
                slot = bypass_ready.pop(pos)
                # data already sits in the buffer: plain copy, no wait
                emit(Instr(Op.FINISH_SWAP_IN, outs=ins.outs,
                           imm=(vpage, slot, 1)))
                free_slots.append(slot)
            elif pos in read_slot:
                slot = read_slot.pop(pos)
                emit(Instr(Op.FINISH_SWAP_IN, outs=ins.outs,
                           imm=(vpage, slot, 0)))
                free_slots.append(slot)
            else:
                # sync fallback at the use site
                if vpage in writes:
                    pw = writes.pop(vpage)
                    emit(Instr(Op.FINISH_SWAP_OUT, imm=(pw.slot,)))
                    free_slots.append(pw.slot)
                    stats.forced_write_finishes += 1
                slot = get_slot(allow_cancel=True)
                if slot is None:
                    raise RuntimeError("prefetch buffer unusable (B too small)")
                emit(Instr(Op.ISSUE_SWAP_IN, imm=(vpage, slot)))
                emit(Instr(Op.FINISH_SWAP_IN, outs=ins.outs,
                           imm=(vpage, slot, 0)))
                free_slots.append(slot)
                stats.sync_fallbacks += 1
        elif ins.op == Op.SWAP_OUT:
            vpage = ins.imm[0]
            # paper §6.4: reclaim only the oldest *write* slot; never steal a
            # prefetched read for an eviction — degrade to sync swap-out.
            slot = get_slot(allow_cancel=False)
            if slot is None:
                emit(ins)  # degraded: synchronous swap-out
                stats.swap_outs += 1
                pos += 1
                continue
            emit(Instr(Op.COPY_OUT, ins=ins.ins, imm=(slot,)))
            emit(Instr(Op.ISSUE_SWAP_OUT, imm=(vpage, slot)))
            writes[vpage] = _PendingWrite(vpage, slot, wcount)
            wcount += 1
            stats.swap_outs += 1
        else:
            emit(ins)
        pos += 1

    for vp, pw in writes.items():
        emit(Instr(Op.FINISH_SWAP_OUT, imm=(pw.slot,)))


# ---------------------------------------------------------------------------
# The record-array core (core="array", the default).
#
# Scheduling is event-sparse: only SWAP_IN/SWAP_OUT rows and prefetch-issue
# points mutate state; every other instruction passes through verbatim.  The
# array core therefore scans chunks once to extract the swap rows (a
# vectorized op-mask), computes the next event position (head swap row, or
# the head read's earliest legal issue point max(use - lookahead,
# min_issue)), block-copies the records in between untouched, and runs the
# scalar event logic only at event positions.  A forced retry one position
# after any state change reproduces the scalar core's emission order
# exactly: the scalar loop calls try_issue_read at *every* position, but
# between state changes those calls are provably no-ops.  State is
# O(lookahead + B + chunk); outputs are instruction-identical to
# ``_schedule_core`` (tested bitwise).
# ---------------------------------------------------------------------------

_OP_SWAP_IN = int(Op.SWAP_IN)
_OP_SWAP_OUT = int(Op.SWAP_OUT)


class _ArraySchedule:
    """Event-driven prefetch transducer over record chunks."""

    def __init__(self, lookahead: int, B: int, swap_bypass: bool,
                 reserve: int, sink: Callable[[np.ndarray], None],
                 stats: ScheduleStats,
                 flush_rows: int = DEFAULT_CHUNK_INSTRS):
        self.lookahead = lookahead
        self.B = B
        self.swap_bypass = swap_bypass
        self.reserve = reserve
        self.sink = sink
        self.stats = stats
        self.flush_rows = flush_rows

        self.buf: deque[tuple[int, np.ndarray]] = deque()
        self.scanned = 0
        self.exhausted = False
        self.upcoming: deque[int] = deque()       # positions of swap rows
        self.reads: deque[tuple[int, int, tuple, int]] = deque()
        self.last_out: dict[int, int] = {}

        self.free_slots = list(range(B - 1, -1, -1))
        self.read_slot: dict[int, int] = {}
        self.issue_order: list[int] = []
        self.writes: OrderedDict[int, _PendingWrite] = OrderedDict()
        self.bypass_ready: dict[int, int] = {}
        self.wcount = 0

        # flat output buffer: single rows and verbatim ranges both land
        # here, so dense directive interleaves don't churn tiny arrays
        self.obuf = np.empty((flush_rows + 8, RECORD_WORDS), dtype=np.int64)
        self.on = 0
        self.changed = False     # any state mutation since the last event
        self._cur: tuple[int, np.ndarray] | None = None   # _row_at cache

    # -- output assembly ------------------------------------------------------

    def _emit_row(self, row: list[int]) -> None:
        self.obuf[self.on] = row
        self.on += 1
        self.changed = True
        if self.on >= self.flush_rows:
            self._flush(force=True)

    def _emit_arr(self, arr: np.ndarray) -> None:
        m = arr.shape[0]
        lo = 0
        while m - lo > 0:
            take = min(m - lo, self.obuf.shape[0] - self.on)
            self.obuf[self.on:self.on + take] = arr[lo:lo + take]
            self.on += take
            lo += take
            if self.on >= self.flush_rows:
                self._flush(force=True)

    def _flush(self, force: bool = False) -> None:
        if self.on and (force or self.on >= self.flush_rows):
            self.sink(self.obuf[:self.on].copy())
            self.on = 0

    # -- scanning -------------------------------------------------------------

    def _pull(self, chunks: Iterator[tuple[int, np.ndarray]]) -> None:
        nxt = next(chunks, None)
        if nxt is None:
            self.exhausted = True
            return
        s, rec = nxt
        self.buf.append((s, rec))
        ops = unpack_heads(rec[:, 0])[0]
        for r in np.nonzero((ops == _OP_SWAP_IN)
                            | (ops == _OP_SWAP_OUT))[0].tolist():
            p = s + r
            row = rec[r]
            vp = int(row[_IMM_OFF])
            if int(row[0]) & 0xFFFF == _OP_SWAP_OUT:
                self.last_out[vp] = p
            else:
                self.reads.append((p, vp,
                                   (int(row[_OUT_OFF]),
                                    int(row[_OUT_OFF + 1])),
                                   self.last_out.get(vp, -1) + 1))
            self.upcoming.append(p)
        self.scanned = s + rec.shape[0]

    def _trim(self, pos: int) -> None:
        buf = self.buf
        while buf and buf[0][0] + buf[0][1].shape[0] <= pos:
            buf.popleft()

    def _copy(self, a: int, b: int) -> None:
        """Pass rows [a, b) through verbatim."""
        for s, rec in self.buf:
            if s >= b:
                break
            lo, hi = max(a - s, 0), min(b - s, rec.shape[0])
            if lo < hi:
                self._emit_arr(rec[lo:hi])
        self._trim(b)
        self._flush()

    def _row_at(self, pos: int) -> np.ndarray:
        cur = self._cur
        if cur is not None and cur[0] <= pos < cur[0] + cur[1].shape[0]:
            return cur[1][pos - cur[0]]
        for s, rec in self.buf:
            if s <= pos < s + rec.shape[0]:
                self._cur = (s, rec)
                return rec[pos - s]
        raise AssertionError(f"position {pos} not buffered")

    # -- slot management (scalar logic, row emission) -------------------------

    def _finish_oldest_write(self) -> bool:
        if not self.writes:
            return False
        _vp, pw = self.writes.popitem(last=False)
        self._emit_row(pack_row(Op.FINISH_SWAP_OUT, imm=(pw.slot,)))
        self.free_slots.append(pw.slot)
        self.stats.forced_write_finishes += 1
        return True

    def _cancel_youngest_read(self) -> bool:
        while self.issue_order:
            up = self.issue_order.pop()
            if up in self.read_slot:
                slot = self.read_slot.pop(up)
                # engine must still drain the in-flight DMA before reuse:
                self._emit_row(pack_row(Op.FINISH_SWAP_OUT, imm=(slot,)))
                self.free_slots.append(slot)
                self.stats.canceled_prefetches += 1
                return True
        return False

    def _get_slot(self, allow_cancel: bool) -> int | None:
        if self.free_slots:
            return self.free_slots.pop()
        if self._finish_oldest_write():
            return self.free_slots.pop()
        if allow_cancel and self._cancel_youngest_read():
            return self.free_slots.pop()
        return None

    def _try_issue(self, pos_now: int) -> None:
        reads = self.reads
        while reads and reads[0][0] - self.lookahead <= pos_now:
            if len(self.read_slot) >= self.B - self.reserve:
                break
            use_pos, vpage, span, min_issue = reads[0]
            if use_pos <= pos_now:
                break
            if min_issue > pos_now:
                break
            if vpage in self.writes:
                pw = self.writes[vpage]
                if self.swap_bypass:
                    del self.writes[vpage]
                    self.bypass_ready[use_pos] = pw.slot
                    self.stats.bypass_hits += 1
                    reads.popleft()
                    self.changed = True   # the only mutation with no emit
                    continue
                self._emit_row(pack_row(Op.FINISH_SWAP_OUT, imm=(pw.slot,)))
                self.free_slots.append(pw.slot)
                del self.writes[vpage]
                self.stats.forced_write_finishes += 1
            slot = self._get_slot(allow_cancel=False)
            if slot is None:
                break
            self._emit_row(pack_row(Op.ISSUE_SWAP_IN, imm=(vpage, slot)))
            self.read_slot[use_pos] = slot
            self.issue_order.append(use_pos)
            self.stats.prefetched += 1
            reads.popleft()

    # -- event handling -------------------------------------------------------

    def _handle(self, pos: int) -> bool:
        """Process position ``pos`` exactly like one scalar loop step;
        returns whether scheduler state changed (→ retry at pos + 1)."""
        self.changed = False
        row = self._row_at(pos)
        op = int(row[0]) & 0xFFFF
        self._try_issue(pos)
        if op == _OP_SWAP_IN:
            vpage = int(row[_IMM_OFF])
            span = (int(row[_OUT_OFF]), int(row[_OUT_OFF + 1]))
            if self.reads and self.reads[0][0] == pos:
                self.reads.popleft()   # this site was not prefetched
            if pos in self.bypass_ready:
                slot = self.bypass_ready.pop(pos)
                # data already sits in the buffer: plain copy, no wait
                self._emit_row(pack_row(Op.FINISH_SWAP_IN, outs=(span,),
                                        imm=(vpage, slot, 1)))
                self.free_slots.append(slot)
            elif pos in self.read_slot:
                slot = self.read_slot.pop(pos)
                self._emit_row(pack_row(Op.FINISH_SWAP_IN, outs=(span,),
                                        imm=(vpage, slot, 0)))
                self.free_slots.append(slot)
            else:
                # sync fallback at the use site
                if vpage in self.writes:
                    pw = self.writes.pop(vpage)
                    self._emit_row(pack_row(Op.FINISH_SWAP_OUT,
                                            imm=(pw.slot,)))
                    self.free_slots.append(pw.slot)
                    self.stats.forced_write_finishes += 1
                slot = self._get_slot(allow_cancel=True)
                if slot is None:
                    raise RuntimeError("prefetch buffer unusable "
                                       "(B too small)")
                self._emit_row(pack_row(Op.ISSUE_SWAP_IN,
                                        imm=(vpage, slot)))
                self._emit_row(pack_row(Op.FINISH_SWAP_IN, outs=(span,),
                                        imm=(vpage, slot, 0)))
                self.free_slots.append(slot)
                self.stats.sync_fallbacks += 1
        elif op == _OP_SWAP_OUT:
            vpage = int(row[_IMM_OFF])
            span = (int(row[_IN_OFF]), int(row[_IN_OFF + 1]))
            # paper §6.4: reclaim only the oldest *write* slot; never steal
            # a prefetched read for an eviction — degrade to sync swap-out.
            slot = self._get_slot(allow_cancel=False)
            if slot is None:
                self._emit_arr(row.reshape(1, RECORD_WORDS))  # degraded
                self.stats.swap_outs += 1
            else:
                self._emit_row(pack_row(Op.COPY_OUT, ins=(span,),
                                        imm=(slot,)))
                self._emit_row(pack_row(Op.ISSUE_SWAP_OUT,
                                        imm=(vpage, slot)))
                self.writes[vpage] = _PendingWrite(vpage, slot, self.wcount)
                self.wcount += 1
                self.stats.swap_outs += 1
        else:
            self._emit_arr(row.reshape(1, RECORD_WORDS))
        if self.upcoming and self.upcoming[0] == pos:
            self.upcoming.popleft()
        return self.changed

    # -- the drive loop -------------------------------------------------------

    def run(self, chunks: Iterator[tuple[int, np.ndarray]],
            total: int) -> None:
        pos = 0
        retry_at: int | None = 0   # attempt issuance at program start
        while pos < total:
            while not self.exhausted and self.scanned <= pos + self.lookahead:
                self._pull(chunks)
            e = total
            if self.upcoming:
                e = min(e, self.upcoming[0])
            if retry_at is not None and retry_at >= pos:
                e = min(e, retry_at)
            if self.reads:
                r0 = self.reads[0]
                # the head read's earliest legal issue point; if it is
                # already behind us the read is state-blocked and a retry
                # event (or the next swap site) will pick it up
                cand = max(r0[0] - self.lookahead, r0[3])
                if cand >= pos:
                    e = min(e, cand)
            if not self.exhausted:
                # never step past scan coverage; copy up to it and rescan
                cover = self.scanned - self.lookahead - 1
                if e > cover:
                    if cover + 1 > pos:
                        self._copy(pos, cover + 1)
                        pos = cover + 1
                    continue
            if e > pos:
                self._copy(pos, e)
                pos = e
                if pos >= total:
                    break
            changed = self._handle(pos)
            self._trim(pos + 1)
            self._flush()
            retry_at = pos + 1 if changed else None
            pos += 1
        for _vp, pw in self.writes.items():
            self._emit_row(pack_row(Op.FINISH_SWAP_OUT, imm=(pw.slot,)))
        self._flush(force=True)


def _schedule_core_array(chunks: Iterator[tuple[int, np.ndarray]],
                         total: int, lookahead: int, B: int,
                         swap_bypass: bool, reserve: int,
                         sink: Callable[[np.ndarray], None],
                         stats: ScheduleStats) -> None:
    _ArraySchedule(lookahead, B, swap_bypass, reserve, sink,
                   stats).run(chunks, total)


def schedule_records(chunks: list[np.ndarray], lookahead: int,
                     prefetch_pages: int,
                     sink: Callable[[np.ndarray], None],
                     swap_bypass: bool = False,
                     write_reserve: int | None = None) -> ScheduleStats:
    """Stage 3 over in-memory record chunks (records in → records out via
    ``sink``): the fused ``plan()`` pipeline's scheduling entry.  Owns the
    B<=0 pass-through, the write-reserve default and the stats
    construction, so the fused and staged paths cannot diverge."""
    B = prefetch_pages
    stats = ScheduleStats(lookahead=lookahead, prefetch_pages=B)
    if B <= 0:
        for c in chunks:
            sink(c)
        return stats

    def _gen():
        s = 0
        for c in chunks:
            yield s, c
            s += c.shape[0]

    _schedule_core_array(_gen(), sum(c.shape[0] for c in chunks),
                         lookahead, B, swap_bypass,
                         _reserve_for(B, write_reserve), sink, stats)
    return stats


def _reserve_for(B: int, write_reserve: int | None) -> int:
    # Reserve a slice of the buffer for eviction traffic: if prefetched
    # reads may occupy every slot, each eviction degrades to a synchronous
    # (blocking) swap-out — measured to dominate MAGE's stall time on
    # sort/merge (see EXPERIMENTS.md §Perf).
    return (max(B // 4, 1) if write_reserve is None else write_reserve) \
        if B > 1 else 0


def plan_schedule(prog: Program, lookahead: int, prefetch_pages: int,
                  swap_bypass: bool = False,
                  write_reserve: int | None = None,
                  core: str = "scalar",
                  chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                  ) -> tuple[Program, ScheduleStats]:
    """Stage 3 over an in-memory 'physical' Program.

    Defaults to the scalar core: for Instr-list inputs the
    encode/decode round-trip costs more than the event loop saves, so
    the array core only pays off where records already exist —
    ``plan()``'s fused pipeline and :func:`plan_schedule_file` (both
    default to it).  ``core="array"`` here is for equivalence testing;
    outputs are identical either way."""
    from .replacement import _check_core
    _check_core(core)
    assert prog.phase == "physical", prog.phase
    stats = ScheduleStats(lookahead=lookahead, prefetch_pages=prefetch_pages)
    B = prefetch_pages
    if B <= 0:  # degenerate: scheduling disabled, keep sync directives
        out_prog = dataclasses.replace(prog, phase="memory", prefetch_slots=0)
        return out_prog, stats
    out: list[Instr] = []
    rec = None
    if core == "array":
        try:
            rec = encode_chunk(prog.instrs)
        except (TypeError, ValueError):
            rec = None                # unencodable program: scalar reference
    if rec is not None:
        chunks = ((s, rec[s:s + chunk_instrs])
                  for s in range(0, rec.shape[0], chunk_instrs))
        _schedule_core_array(chunks, rec.shape[0], lookahead, B, swap_bypass,
                             _reserve_for(B, write_reserve),
                             lambda arr: out.extend(decode_chunk(arr)), stats)
    else:
        _schedule_core(prog.instrs, lookahead, B, swap_bypass,
                       _reserve_for(B, write_reserve), out.append, stats)
    res = dataclasses.replace(prog, instrs=out, phase="memory",
                              prefetch_slots=B)
    return res, stats


def plan_schedule_file(pf: ProgramFile, out_path: str | os.PathLike,
                       lookahead: int, prefetch_pages: int,
                       swap_bypass: bool = False,
                       write_reserve: int | None = None,
                       chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                       meta: dict | None = None,
                       core: str = "array",
                       ) -> tuple[ProgramFile, ScheduleStats]:
    """Stage 3, out-of-core: stream a 'physical' bytecode file into the
    final memory-program file, holding O(lookahead + B + chunk) state.
    With the default ``core="array"`` the no-hazard fast path block-copies
    record chunks without ever decoding an instruction."""
    from .replacement import _check_core
    _check_core(core)
    assert pf.phase == "physical", pf.phase
    stats = ScheduleStats(lookahead=lookahead, prefetch_pages=prefetch_pages)
    B = prefetch_pages
    with writer_like(pf, out_path, phase="memory", prefetch_slots=max(B, 0),
                     meta=meta, chunk_instrs=chunk_instrs) as w:
        if B <= 0:
            # records are unchanged; copy raw chunks instead of paying the
            # per-instruction decode/encode cost just to rewrite the header
            for _, arr in pf.iter_chunks(chunk_instrs):
                w.append_records(arr)
        elif core == "array":
            _schedule_core_array(pf.iter_chunks(chunk_instrs),
                                 pf.num_records, lookahead, B, swap_bypass,
                                 _reserve_for(B, write_reserve),
                                 w.append_records, stats)
        else:
            _schedule_core(pf.iter_instrs(chunk_instrs), lookahead, B,
                           swap_bypass, _reserve_for(B, write_reserve),
                           w.append, stats)
    return ProgramFile(os.fspath(out_path)), stats
