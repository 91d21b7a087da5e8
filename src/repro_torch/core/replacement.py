"""MAGE planner stage 2: replacement (§6.3).

The port's copy of the scalar reference core of ``repro.core.replacement``
with Belady's MIN (the record-array core and the other policies wait; the
array core is instruction-identical, tests/test_array_core.py).

Applies Belady's MIN directly — the clairvoyance that is unrealizable for an
OS is free here, because the bytecode *is* the access pattern.  Emits
synchronous SWAP_IN / SWAP_OUT directives and rewrites every operand from
MAGE-virtual to MAGE-physical addresses via a page table maintained in
software during planning (§4.1).

Write-back rule (see liveness.py): a dirty victim is written back only if its
next READ is finite; otherwise it is dropped — no later instruction can
observe it.  A swap-in is elided when the missing page is about to be fully
overwritten by the touching instruction (write-allocate elision).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterable, Iterator

import numpy as np

from .bytecode import INF, Instr, Op, Program
from .liveness import (W_FULL_WRITE, W_WRITE, Touches, max_pages_per_instr,
                       stripped_touches)


class EvictionPolicy:
    """Planner calls touch() on every page touch and evict() on frame need.

    ``resident`` / ``dirty`` are mappings/sets of page ids — plain dict/set
    or the scalar core's dense-array equivalents (:class:`_DensePageMap` /
    :class:`_DensePageSet`); policies must only rely on membership,
    indexing and iteration."""

    name = "abstract"

    def touch(self, page: int, next_use: int, now: int) -> None:
        raise NotImplementedError

    def evict(self, pinned: set[int], resident, dirty) -> int:
        raise NotImplementedError

    def remove(self, page: int) -> None:
        pass


class _HeapPolicy(EvictionPolicy):
    """Lazy-deletion heap over per-page keys (max-heap iff maximize)."""

    def __init__(self, maximize: bool):
        self._sign = -1 if maximize else 1
        self._heap: list[tuple[int, int]] = []
        self._cur: dict[int, int] = {}

    def _push(self, page: int, key: int) -> None:
        self._cur[page] = key
        heapq.heappush(self._heap, (self._sign * key, page))
        if len(self._heap) > 64 + 4 * len(self._cur):
            # compact stale lazy-deletion entries: without this the heap
            # grows with total touches, breaking the planner's O(frames)
            # memory bound.  Rebuilding from _cur keeps exactly the valid
            # entries; duplicates later re-pushed from an evict stash are
            # harmless (they turn stale once the page leaves _cur).
            self._heap = [(self._sign * k, p) for p, k in self._cur.items()]
            heapq.heapify(self._heap)

    def touch(self, page: int, next_use: int, now: int) -> None:
        self._push(page, next_use)

    def remove(self, page: int) -> None:
        self._cur.pop(page, None)

    def _pop_valid(self, pinned: set[int], resident: dict[int, int],
                   stash: list[tuple[int, int]]) -> tuple[int, int] | None:
        """Pop the best non-stale, non-pinned resident entry, or None."""
        while self._heap:
            k, p = heapq.heappop(self._heap)
            cur = self._cur.get(p)
            if cur is None or self._sign * cur != k or p not in resident:
                continue
            if p in pinned:
                stash.append((k, p))
                continue
            return (k, p)
        return None

    def _finish(self, chosen: int, stash: list[tuple[int, int]]) -> int:
        for e in stash:
            if e[1] != chosen:
                heapq.heappush(self._heap, e)
        del self._cur[chosen]
        return chosen

    def evict(self, pinned, resident, dirty) -> int:
        stash: list[tuple[int, int]] = []
        got = self._pop_valid(pinned, resident, stash)
        if got is None:
            for e in stash:
                heapq.heappush(self._heap, e)
            raise RuntimeError(
                "no evictable page: num_frames smaller than one instruction's "
                "working set — raise the memory budget or shrink DSL chunks")
        return self._finish(got[1], stash)


class MinPolicy(_HeapPolicy):
    """Belady's MIN: evict the resident page whose next use is farthest."""

    name = "min"

    def __init__(self):
        super().__init__(maximize=True)


POLICIES: dict[str, type[EvictionPolicy]] = {"min": MinPolicy}


@dataclasses.dataclass
class ReplacementStats:
    swap_ins: int = 0
    swap_outs: int = 0
    dropped_dirty: int = 0       # dirty pages dropped: never read again
    elided_swap_ins: int = 0     # write-allocate elisions
    num_frames: int = 0
    num_vpages: int = 0
    instructions: int = 0
    policy: str = "min"

    @property
    def total_swaps(self) -> int:
        return self.swap_ins + self.swap_outs


# One instruction plus its annotated page touches, in touch order:
# (instr, [(page, flags, next_any, next_read), ...]).  Both the in-memory
# and the file-streaming paths feed this shape to the same transducer core,
# which is what makes their outputs instruction-identical by construction.
_TouchRow = tuple[int, int, int, int]
_AnnotatedInstr = tuple[Instr, list[_TouchRow]]

_MISSING = object()


class _DensePageMap:
    """int→int map over a grow-on-demand page-indexed int64 array.

    Drop-in for the dicts the scalar core keeps per page (software page
    table, per-page next-read): page ids are dense small integers here,
    so direct array indexing replaces boxed-int hashing on every touch.
    Values are non-negative (frames, instruction indices, INF); -1 marks
    absent.  Exposes the dict surface the eviction policies consume
    (membership, indexing, ``pop``, ``len``, iteration)."""

    __slots__ = ("_arr", "_n")

    def __init__(self, cap: int = 1024):
        self._arr = np.full(cap, -1, dtype=np.int64)
        self._n = 0

    def _ensure(self, p: int) -> None:
        cap = self._arr.shape[0]
        if p >= cap:
            arr = np.full(max(p + 1, 2 * cap), -1, dtype=np.int64)
            arr[:cap] = self._arr
            self._arr = arr

    def __contains__(self, p: int) -> bool:
        return 0 <= p < self._arr.shape[0] and self._arr[p] >= 0

    def __getitem__(self, p: int) -> int:
        if p not in self:
            raise KeyError(p)
        return int(self._arr[p])

    def __setitem__(self, p: int, v: int) -> None:
        self._ensure(p)
        if self._arr[p] < 0:
            self._n += 1
        self._arr[p] = v

    def pop(self, p: int, default=_MISSING) -> int:
        if p in self:
            v = int(self._arr[p])
            self._arr[p] = -1
            self._n -= 1
            return v
        if default is _MISSING:
            raise KeyError(p)
        return default

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(np.nonzero(self._arr >= 0)[0].tolist())

    def keys(self):
        return iter(self)


class _DensePageSet:
    """Set of page ids over a grow-on-demand boolean array (see
    :class:`_DensePageMap` for why arrays beat dict/set here)."""

    __slots__ = ("_arr", "_n")

    def __init__(self, cap: int = 1024):
        self._arr = np.zeros(cap, dtype=bool)
        self._n = 0

    def add(self, p: int) -> None:
        cap = self._arr.shape[0]
        if p >= cap:
            arr = np.zeros(max(p + 1, 2 * cap), dtype=bool)
            arr[:cap] = self._arr
            self._arr = arr
        if not self._arr[p]:
            self._n += 1
            self._arr[p] = True

    def discard(self, p: int) -> None:
        if p in self:
            self._arr[p] = False
            self._n -= 1

    def __contains__(self, p: int) -> bool:
        return 0 <= p < self._arr.shape[0] and bool(self._arr[p])

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(np.nonzero(self._arr)[0].tolist())


def _replacement_core(items: Iterable[_AnnotatedInstr], num_frames: int,
                      pol: EvictionPolicy, shift: int, psize: int,
                      emit: Callable[[Instr], None],
                      stats: ReplacementStats) -> None:
    """Streaming Belady transducer: O(frames + pages-on-storage) state
    (dense page-indexed arrays; see :class:`_DensePageMap`)."""
    page_table = _DensePageMap()             # vpage -> frame
    free_frames = list(range(num_frames - 1, -1, -1))
    dirty = _DensePageSet()
    stored = _DensePageSet()                 # storage holds current content
    cur_next_read = _DensePageMap()          # resident pages only

    def acquire_frame(pinned: set[int]) -> int:
        if free_frames:
            return free_frames.pop()
        victim = pol.evict(pinned, page_table, dirty)
        frame = page_table.pop(victim)
        if victim in dirty:
            dirty.discard(victim)
            if cur_next_read.pop(victim, INF) < INF:
                emit(Instr(Op.SWAP_OUT,
                           ins=((frame << shift, psize),),
                           imm=(victim,)))
                stats.swap_outs += 1
                stored.add(victim)
            else:
                stats.dropped_dirty += 1
                stored.discard(victim)
        else:
            cur_next_read.pop(victim, None)
        # clean victim: storage copy (if any) is already current
        return frame

    def translate(span):
        addr, n = span
        vp = addr >> shift
        return ((page_table[vp] << shift) + (addr - (vp << shift)), n)

    for i, (ins, row) in enumerate(items):
        pinned = {p for p, _, _, _ in row}
        for p, f, nxt, nxr in row:
            if p not in page_table:
                frame = acquire_frame(pinned)
                if p in stored:
                    if f & W_FULL_WRITE:
                        stored.discard(p)
                        stats.elided_swap_ins += 1
                    else:
                        emit(Instr(Op.SWAP_IN,
                                   outs=((frame << shift, psize),),
                                   imm=(p,)))
                        stats.swap_ins += 1
                page_table[p] = frame
            if f & W_WRITE:
                dirty.add(p)
            cur_next_read[p] = nxr
            pol.touch(p, nxt, i)
        emit(Instr(ins.op,
                   tuple(translate(s) for s in ins.outs),
                   tuple(translate(s) for s in ins.ins),
                   ins.imm))
        stats.instructions += 1


def _items_from_touches(instrs: list[Instr], t: Touches
                        ) -> Iterator[_AnnotatedInstr]:
    offs, pg, fl = t.offsets, t.pages, t.flags
    nxt, nxr = t.next_any, t.next_read
    for i, ins in enumerate(instrs):
        yield ins, [(int(pg[k]), int(fl[k]), int(nxt[k]), int(nxr[k]))
                    for k in range(int(offs[i]), int(offs[i + 1]))]


def _check_budget(num_frames: int, need: int) -> None:
    if num_frames < need:
        raise ValueError(
            f"num_frames={num_frames} < {need} pages touched by one "
            f"instruction; budget too small for this chunking")


def plan_replacement(prog: Program, num_frames: int,
                     policy: str | EvictionPolicy = "min",
                     ) -> tuple[Program, ReplacementStats]:
    """Stage 2: rewrite a 'virtual' program into a 'physical' one."""
    assert prog.phase == "virtual", prog.phase
    out: list[Instr] = []
    instrs, touches = stripped_touches(prog)
    _check_budget(num_frames, max_pages_per_instr(touches))
    pol = POLICIES[policy]() if isinstance(policy, str) else policy
    stats = ReplacementStats(num_frames=num_frames,
                             num_vpages=touches.num_pages,
                             policy=getattr(pol, "name", str(policy)))
    _replacement_core(_items_from_touches(instrs, touches), num_frames,
                      pol, prog.page_shift, prog.page_slots, out.append,
                      stats)
    res = Program(
        instrs=out, page_shift=prog.page_shift, protocol=prog.protocol,
        phase="physical", worker=prog.worker, num_workers=prog.num_workers,
        vspace_slots=prog.vspace_slots, num_frames=num_frames,
        meta=dict(prog.meta),
    )
    return res, stats
