"""MAGE planner stage 3: scheduling (§6.4).

The port's copy of the scalar reference core of ``repro.core.scheduling``
(the record-array core waits; it is instruction-identical).

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
from collections import OrderedDict, deque
from typing import Callable, Iterable

from .bytecode import Instr, Op, Program


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
                  ) -> tuple[Program, ScheduleStats]:
    """Stage 3 over an in-memory 'physical' Program."""
    assert prog.phase == "physical", prog.phase
    stats = ScheduleStats(lookahead=lookahead, prefetch_pages=prefetch_pages)
    B = prefetch_pages
    if B <= 0:  # degenerate: scheduling disabled, keep sync directives
        out_prog = dataclasses.replace(prog, phase="memory", prefetch_slots=0)
        return out_prog, stats
    out: list[Instr] = []
    _schedule_core(prog.instrs, lookahead, B, swap_bypass,
                   _reserve_for(B, write_reserve), out.append, stats)
    res = dataclasses.replace(prog, instrs=out, phase="memory",
                              prefetch_slots=B)
    return res, stats
