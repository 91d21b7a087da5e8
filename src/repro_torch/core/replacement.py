"""MAGE planner stage 2: replacement (§6.3).

The port's copy of ``repro.core.replacement``: the scalar reference core,
the vectorized record-array core (the default; instruction-identical to
the scalar one) and the out-of-core file stage, with the reference's four
eviction policies.

Applies Belady's MIN directly — the clairvoyance that is unrealizable for an
OS is free here, because the bytecode *is* the access pattern.  Emits
synchronous SWAP_IN / SWAP_OUT directives and rewrites every operand from
MAGE-virtual to MAGE-physical addresses via a page table maintained in
software during planning (§4.1).

Write-back rule (see liveness.py): a dirty victim is written back only if its
next READ is finite; otherwise it is dropped — no later instruction can
observe it.  A swap-in is elided when the missing page is about to be fully
overwritten by the touching instruction (write-allocate elision).

Policies beyond MIN are the baselines the paper measures against: LRU and
FIFO (what an OS would do) and MinClean, a dirty-aware MIN.  A custom
``EvictionPolicy`` object runs on the scalar core.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
from typing import Callable, Iterable, Iterator

import numpy as np

from .bytecode import (DEFAULT_CHUNK_INSTRS, INF, MAX_INS, MAX_OUTS,
                       RECORD_WORDS, _IN_OFF, _OUT_OFF, Instr, Op, Program,
                       ProgramFile, decode_chunk, encode_chunk, pack_row,
                       strip_frees, unpack_heads, writer_like)
from .liveness import (ANN_TOUCH_SLOTS, ANN_WORDS, W_FULL_WRITE, W_WRITE,
                       AnnotationReader, Touches, annotate_next_use,
                       max_pages_per_instr, records_digest, stripped_touches,
                       touches_from_records)


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


class MinCleanPolicy(_HeapPolicy):
    """Beyond-paper: farthest-first, but among pages whose next use lies
    within a window of the farthest (or is also INF), prefer a CLEAN page —
    skipping a write-back.  Attacks the 2x write slack plain MIN concedes
    (§6.3 footnote 4; exact minimization is NP-hard, Farach & Liberatore)."""

    name = "min_clean"

    def __init__(self, rel_delta: float = 0.05, abs_delta: int = 256):
        super().__init__(maximize=True)
        self.rel_delta = rel_delta
        self.abs_delta = abs_delta

    def evict(self, pinned, resident, dirty) -> int:
        stash: list[tuple[int, int]] = []
        first = self._pop_valid(pinned, resident, stash)
        if first is None:
            for e in stash:
                heapq.heappush(self._heap, e)
            raise RuntimeError(
                "no evictable page: num_frames smaller than one instruction's "
                "working set — raise the memory budget or shrink DSL chunks")
        fk, fp = first
        far = self._sign * fk  # == -fk: the farthest next-use
        if fp not in dirty:
            return self._finish(fp, stash)
        if far >= INF:
            window_lo = INF
        else:
            window_lo = far - max(self.abs_delta, int(self.rel_delta * far))
        rejected: list[tuple[int, int]] = [first]
        chosen = None
        while True:
            nxt = self._pop_valid(pinned, resident, stash)
            if nxt is None:
                break
            key = self._sign * nxt[0]
            if key < window_lo:
                rejected.append(nxt)
                break
            if nxt[1] not in dirty:
                chosen = nxt[1]
                break
            rejected.append(nxt)
        if chosen is None:
            chosen = fp  # no clean page in window: plain MIN choice
        for e in rejected:
            if e[1] != chosen:
                stash.append(e)
        return self._finish(chosen, stash)


class LruPolicy(_HeapPolicy):
    name = "lru"

    def __init__(self):
        super().__init__(maximize=False)

    def touch(self, page: int, next_use: int, now: int) -> None:
        self._push(page, now)


class FifoPolicy(_HeapPolicy):
    name = "fifo"

    def __init__(self):
        super().__init__(maximize=False)

    def touch(self, page: int, next_use: int, now: int) -> None:
        if page not in self._cur:
            self._push(page, now)


POLICIES: dict[str, type[EvictionPolicy]] = {
    "min": MinPolicy,
    "min_clean": MinCleanPolicy,
    "lru": LruPolicy,
    "fifo": FifoPolicy,
}


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


def _items_from_files(pf: ProgramFile, ann: AnnotationReader,
                      chunk_instrs: int) -> Iterator[_AnnotatedInstr]:
    crc = 0
    for (s, rec), (s2, arr) in zip(pf.iter_chunks(chunk_instrs),
                                   ann.iter_chunks(chunk_instrs)):
        assert s == s2, "program/annotation chunking out of sync"
        crc = records_digest(crc, rec, s)
        for r, ins in enumerate(decode_chunk(rec)):
            yield ins, [(int(arr[r, 1 + 4 * j]), int(arr[r, 2 + 4 * j]),
                         int(arr[r, 3 + 4 * j]), int(arr[r, 4 + 4 * j]))
                        for j in range(int(arr[r, 0]))]
    if crc != ann.prog_crc:
        raise ValueError(
            "annotation sidecar does not match this program file "
            "(content checksum mismatch); regenerate it with "
            "annotate_next_use")


def _check_budget(num_frames: int, need: int) -> None:
    if num_frames < need:
        raise ValueError(
            f"num_frames={num_frames} < {need} pages touched by one "
            f"instruction; budget too small for this chunking")


# ---------------------------------------------------------------------------
# The record-array core (core="array", the default).
#
# Same transducer semantics as ``_replacement_core``, restructured around a
# batched no-miss fast path: a vectorized residency probe over the chunk's
# touch list finds the first miss, everything before it is bookkept with
# array scatters (hits never evict, so the probe's verdict cannot go stale
# within the clean prefix), and only the instruction containing the miss is
# handled by scalar code — including the eviction decision, which replays
# each heap policy's exact (key, page) tie-breaking over per-frame key
# arrays.  Operand rewriting is one gather per chunk, and output records are
# assembled as arrays, so the streaming pipeline never decodes an ``Instr``
# off the fast path.  Outputs are instruction-identical to the scalar core
# (tested bitwise via records_digest).
# ---------------------------------------------------------------------------

ARRAY_POLICIES = ("min", "min_clean", "lru", "fifo")
#: the array core keeps O(num_vpages) int64 per-page vectors (frame_of,
#: stored) and composite (key * num_vpages + page) eviction keys need
#: key * P < 2^62; past this page count (64 Mi pages = 64 GiB of data at
#: GC's 64 KiB pages — ~0.5 GiB of planner state) the planner falls back
#: to the scalar core's dict-based O(resident + stored) state instead
ARRAY_MAX_VPAGES = 1 << 26
_PROBE_MAX = 8192
_PROBE_MIN = 32
_SMALL_SEG = 12          # below this, scalar-loop the clean prefix too
_MIN_SENTINEL = -(1 << 62)   # pinned-frame key for maximizing policies
_LRU_SENTINEL = (1 << 62) + 1  # pinned-frame key for minimizing policies

CORES = ("array", "scalar")


def _check_core(core: str) -> None:
    if core not in CORES:
        raise ValueError(f"core must be one of {CORES}, got {core!r}")


class _ArrayCore:
    """Streaming Belady transducer over record chunks (state: O(frames)
    vectors plus O(num_vpages) int64/bool per-page vectors — the array
    analogue of the scalar core's page-table/stored dicts, bounded by
    ARRAY_MAX_VPAGES — plus one chunk).

    Per-frame eviction keys are stored as an injective COMPOSITE,
    ``key * P ± page`` (P = num_vpages), so the heap policies' exact pop
    order — best key first, then smallest page — collapses into a single
    argmax/argmin.  Next-use keys are clamped to ``INF // P`` first; that
    only collapses INF (real keys are instruction indices, and any
    program with T instructions touches at most 6T pages, so
    T * P < 6T^2 << 2^62 for every feasible program — guarded by
    ARRAY_MAX_VPAGES)."""

    def __init__(self, num_frames: int, policy: str, shift: int, psize: int,
                 num_vpages: int, stats: ReplacementStats):
        if policy not in ARRAY_POLICIES:
            raise ValueError(f"array core supports {ARRAY_POLICIES}, "
                             f"got {policy!r}")
        self.nf = num_frames
        self.policy = policy
        self.maximize = policy in ("min", "min_clean")
        if policy == "min_clean":
            ref = MinCleanPolicy()
            self.rel_delta, self.abs_delta = ref.rel_delta, ref.abs_delta
        self.shift = shift
        self.psize = psize
        self.stats = stats
        n = max(num_vpages, 1)
        self.P = n
        self.clamp = INF // n
        self.frame_of = np.full(n, -1, dtype=np.int64)
        self.stored = np.zeros(n, dtype=bool)
        self.page_of = np.full(num_frames, -1, dtype=np.int64)
        self.key_of = np.zeros(num_frames, dtype=np.int64)
        self.dirty_of = np.zeros(num_frames, dtype=bool)
        self.nxr_of = np.full(num_frames, INF, dtype=np.int64)
        self.free_ptr = 0
        self.probe_win = _PROBE_MAX
        self._dir_rows: list[list[int]] = []
        self._dir_rel: list[int] = []

    # -- event-time slow path -------------------------------------------------

    def _evict(self, pinned_frames: list[int]) -> int:
        """One argmax/argmin over the composite per-frame keys replays the
        lazy-deletion heap's exact pop order."""
        key_of = self.key_of
        sentinel = _MIN_SENTINEL if self.maximize else _LRU_SENTINEL
        saved = [(f, int(key_of[f])) for f in pinned_frames]
        for f, _ in saved:
            key_of[f] = sentinel
        try:
            if self.maximize:
                vf = int(np.argmax(key_of))
                if key_of[vf] == _MIN_SENTINEL:
                    raise RuntimeError(
                        "no evictable page: num_frames smaller than one "
                        "instruction's working set — raise the memory "
                        "budget or shrink DSL chunks")
                if self.policy == "min_clean":
                    return self._evict_min_clean(vf)
            else:
                vf = int(np.argmin(key_of))
                if key_of[vf] == _LRU_SENTINEL:
                    raise RuntimeError(
                        "no evictable page: num_frames smaller than one "
                        "instruction's working set — raise the memory "
                        "budget or shrink DSL chunks")
            return vf
        finally:
            for f, k in saved:
                key_of[f] = k

    def _evict_min_clean(self, vf: int) -> int:
        """MinClean's scan order: the farthest (min-page) entry if clean,
        else the best CLEAN composite within the window, else the plain
        MIN choice.  Runs with pinned sentinels in place."""
        key_of, dirty_of = self.key_of, self.dirty_of
        if not dirty_of[vf]:
            return vf
        far = int(key_of[vf]) // self.P          # the clamped key
        if far >= self.clamp:                    # i.e. next use == INF
            window_lo = self.clamp
        else:
            window_lo = far - max(self.abs_delta, int(self.rel_delta * far))
        # pinned sentinels sit far below any window threshold
        masked = np.where(dirty_of, _MIN_SENTINEL, key_of)
        cf = int(np.argmax(masked))
        if masked[cf] >= window_lo * self.P:
            return cf
        return vf

    def _touch(self, k: int, pinned, gi: int, pages_l, flags_l, nxt_l,
               nxr_l, tframe) -> None:
        """One scalar touch: exactly ``_replacement_core``'s per-touch body.
        ``pinned`` is the owning instruction's page list (only consulted if
        this touch faults)."""
        p = pages_l[k]
        fl = flags_l[k]
        frame_of = self.frame_of
        f = int(frame_of[p])
        if f < 0:
            if self.free_ptr < self.nf:
                f = self.free_ptr
                self.free_ptr += 1
            else:
                pf = []
                for q in pinned:
                    fq = int(frame_of[q])
                    if fq >= 0:
                        pf.append(fq)
                f = self._evict(pf)
                self._reclaim(f)
            st = self.stats
            if self.stored[p]:
                if fl & W_FULL_WRITE:
                    self.stored[p] = False
                    st.elided_swap_ins += 1
                else:
                    self._dir_rows.append(pack_row(
                        Op.SWAP_IN, outs=((f << self.shift, self.psize),),
                        imm=(p,)))
                    self._dir_rel.append(self._cur_rel)
                    st.swap_ins += 1
            frame_of[p] = f
            self.page_of[f] = p
            if self.policy == "fifo":
                self.key_of[f] = gi * self.P + p
        if fl & W_WRITE:
            self.dirty_of[f] = True
        self.nxr_of[f] = nxr_l[k]
        if self.maximize:
            self.key_of[f] = min(nxt_l[k], self.clamp) * self.P \
                + (self.P - 1 - p)
        elif self.policy == "lru":
            self.key_of[f] = gi * self.P + p
        tframe[k] = f

    def _reclaim(self, victim_f: int) -> None:
        """Unmap the eviction victim, emitting its write-back if needed."""
        vq = int(self.page_of[victim_f])
        st = self.stats
        if self.dirty_of[victim_f]:
            self.dirty_of[victim_f] = False
            if self.nxr_of[victim_f] < INF:
                self._dir_rows.append(pack_row(
                    Op.SWAP_OUT,
                    ins=((victim_f << self.shift, self.psize),),
                    imm=(vq,)))
                self._dir_rel.append(self._cur_rel)
                st.swap_outs += 1
                self.stored[vq] = True
            else:
                st.dropped_dirty += 1
                self.stored[vq] = False
        self.frame_of[vq] = -1
        self.page_of[victim_f] = -1

    # -- per-chunk drive ------------------------------------------------------

    def process_chunk(self, start: int, rec: np.ndarray, offs: np.ndarray,
                      pages: np.ndarray, flags: np.ndarray,
                      nxt: np.ndarray, nxr: np.ndarray) -> np.ndarray:
        """Transduce one chunk; returns the output records (directives
        interleaved before their instruction, operands rewritten)."""
        m = rec.shape[0]
        T = pages.shape[0]
        self._dir_rows = []
        self._dir_rel = []
        tframe = np.empty(T, dtype=np.int64)
        counts = np.diff(offs)
        rows = np.repeat(np.arange(m, dtype=np.int64), counts)
        write_mask = (flags & W_WRITE) != 0
        pages_l = pages.tolist()
        flags_l = flags.tolist()
        nxt_l = nxt.tolist()
        nxr_l = nxr.tolist()
        rows_l = rows.tolist()
        offs_l = offs.tolist()
        frame_of, key_of = self.frame_of, self.key_of
        maximize, lru = self.maximize, self.policy == "lru"

        t = 0
        win = self.probe_win
        while t < T:
            end = min(t + win, T)
            fr = frame_of[pages[t:end]]
            missrel = np.nonzero(fr < 0)[0]
            m0 = t + int(missrel[0]) if missrel.size else end
            if m0 > t:
                if m0 - t < _SMALL_SEG:
                    for k in range(t, m0):
                        self._touch(k, (), start + rows_l[k], pages_l,
                                    flags_l, nxt_l, nxr_l, tframe)
                else:
                    seg = slice(t, m0)
                    sfr = fr[:m0 - t]
                    tframe[seg] = sfr
                    self.dirty_of[sfr[write_mask[seg]]] = True
                    self.nxr_of[sfr] = nxr[seg]
                    if maximize:
                        key_of[sfr] = np.minimum(nxt[seg], self.clamp) \
                            * self.P + (self.P - 1 - pages[seg])
                    elif lru:
                        key_of[sfr] = (start + rows[seg]) * self.P \
                            + pages[seg]
            if m0 < end:
                # event: scalar-handle the rest of the faulting instruction
                dist = m0 - t
                i = rows_l[m0]
                self._cur_rel = i
                row_end = offs_l[i + 1]
                pinned = pages_l[offs_l[i]:row_end]
                gi = start + i
                for k in range(m0, row_end):
                    self._touch(k, pinned, gi, pages_l, flags_l, nxt_l,
                                nxr_l, tframe)
                t = row_end
                win = max(_PROBE_MIN, min(win, 2 * (dist + 8)))
            else:
                t = end
                win = min(win * 2, _PROBE_MAX)
        self.probe_win = win
        self.stats.instructions += m
        return self._emit_chunk(rec, offs, rows, counts, pages, tframe)

    def _emit_chunk(self, rec, offs, rows, counts, pages, tframe):
        m = rec.shape[0]
        out = rec.copy()
        if len(pages):
            # per-instruction page -> frame maps, padded to the touch arity
            S = ANN_TOUCH_SLOTS
            pages_pad = np.full((m, S), -1, dtype=np.int64)
            frames_pad = np.zeros((m, S), dtype=np.int64)
            ordinal = np.arange(len(pages), dtype=np.int64) - \
                np.repeat(offs[:-1], counts)
            pages_pad[rows, ordinal] = pages
            frames_pad[rows, ordinal] = tframe
            _ops, n_outs, n_ins, _ = unpack_heads(rec[:, 0])
            shift = self.shift
            ar = np.arange(m)
            slots = [(_OUT_OFF + 2 * j, n_outs > j) for j in range(MAX_OUTS)]
            slots += [(_IN_OFF + 2 * j, n_ins > j) for j in range(MAX_INS)]
            for off, present in slots:
                sel = present & (rec[:, off + 1] > 0)
                if not sel.any():
                    continue
                addr = rec[:, off]
                vp = addr >> shift
                match = pages_pad == vp[:, None]
                if not match.any(axis=1)[sel].all():
                    raise KeyError(
                        "operand page missing from its instruction's touch "
                        "set — span straddles a page or arity is corrupt")
                frame = frames_pad[ar, np.argmax(match, axis=1)]
                out[sel, off] = addr[sel] + ((frame[sel] - vp[sel]) << shift)
        D = len(self._dir_rows)
        if D == 0:
            return out
        drel = np.asarray(self._dir_rel, dtype=np.int64)
        dcount = np.bincount(drel, minlength=m)
        ipos = np.arange(m, dtype=np.int64) + np.cumsum(dcount)
        full = np.empty((m + D, RECORD_WORDS), dtype=np.int64)
        full[ipos] = out
        hole = np.ones(m + D, dtype=bool)
        hole[ipos] = False
        full[hole] = np.asarray(self._dir_rows, dtype=np.int64)
        return full


def _array_chunks_from_files(pf: ProgramFile, ann: AnnotationReader,
                             chunk_instrs: int):
    """Yield (start, rec, offsets, pages, flags, next_any, next_read) per
    chunk from a program file + its sidecar, validating the content digest
    exactly like the scalar ``_items_from_files``."""
    crc = 0
    for (s, rec), (s2, arr) in zip(pf.iter_chunks(chunk_instrs),
                                   ann.iter_chunks(chunk_instrs)):
        assert s == s2, "program/annotation chunking out of sync"
        crc = records_digest(crc, rec, s)
        counts = arr[:, 0]
        m = len(counts)
        offs = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        T = int(offs[-1])
        rows = np.repeat(np.arange(m, dtype=np.int64), counts)
        ordinal = np.arange(T, dtype=np.int64) - np.repeat(offs[:-1], counts)
        base = rows * ANN_WORDS + 1 + ordinal * 4
        flat = arr.reshape(-1)
        yield s, rec, offs, flat[base], flat[base + 1], flat[base + 2], \
            flat[base + 3]
    if crc != ann.prog_crc:
        raise ValueError(
            "annotation sidecar does not match this program file "
            "(content checksum mismatch); regenerate it with "
            "annotate_next_use")


def _policy(policy: str | EvictionPolicy) -> EvictionPolicy:
    """A fresh policy object for a registered name, or ``policy`` itself."""
    if not isinstance(policy, str):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {tuple(POLICIES)}, "
                         f"got {policy!r}")
    return POLICIES[policy]()


def _use_array_core(core: str, policy: str | EvictionPolicy) -> bool:
    """The array core handles the registered policy names; custom
    EvictionPolicy instances keep the scalar reference core."""
    _check_core(core)
    return core == "array" and isinstance(policy, str) \
        and policy in ARRAY_POLICIES


def replacement_records(prog: Program, num_frames: int,
                        policy: str | EvictionPolicy = "min",
                        chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                        ) -> tuple[list[np.ndarray], ReplacementStats] | None:
    """Stage 2 over an in-memory program, producing OUTPUT RECORD CHUNKS.

    The fused ``plan()`` pipeline keeps chunks as arrays between stages
    (one encode at the front, one decode at the very end).  Returns None
    when the array core cannot run this program/policy (straddling spans,
    wide arity, custom EvictionPolicy instance) — callers fall back to
    the scalar reference."""
    assert prog.phase == "virtual", prog.phase
    if not _use_array_core("array", policy):
        return None
    instrs = strip_frees(prog.instrs)
    try:
        rec = encode_chunk(instrs)
        touches = touches_from_records(rec, prog.page_shift,
                                       prog.page_slots, chunk_instrs)
    except (TypeError, ValueError):
        return None
    if touches.num_pages >= ARRAY_MAX_VPAGES:
        return None
    _check_budget(num_frames, max_pages_per_instr(touches))
    stats = ReplacementStats(num_frames=num_frames,
                             num_vpages=touches.num_pages,
                             policy=policy)
    ac = _ArrayCore(num_frames, policy, prog.page_shift, prog.page_slots,
                    touches.num_pages, stats)
    offs = touches.offsets
    flags64 = touches.flags.astype(np.int64)
    chunks: list[np.ndarray] = []
    for s in range(0, len(instrs), chunk_instrs):
        e = min(s + chunk_instrs, len(instrs))
        lo, hi = int(offs[s]), int(offs[e])
        chunks.append(ac.process_chunk(
            s, rec[s:e], offs[s:e + 1] - lo,
            touches.pages[lo:hi], flags64[lo:hi],
            touches.next_any[lo:hi], touches.next_read[lo:hi]))
    return chunks, stats


def plan_replacement(prog: Program, num_frames: int,
                     policy: str | EvictionPolicy = "min",
                     core: str = "array",
                     chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                     ) -> tuple[Program, ReplacementStats]:
    """Stage 2: rewrite a 'virtual' program into a 'physical' one.

    ``core="array"`` (default) runs the vectorized record-array core;
    ``core="scalar"`` the reference transducer.  Outputs are
    instruction-identical."""
    assert prog.phase == "virtual", prog.phase
    _check_core(core)
    got = replacement_records(prog, num_frames, policy, chunk_instrs) \
        if core == "array" else None
    out: list[Instr] = []
    if got is not None:
        chunks, stats = got
        for c in chunks:
            out.extend(decode_chunk(c))
    else:
        instrs, touches = stripped_touches(prog)
        _check_budget(num_frames, max_pages_per_instr(touches))
        pol = _policy(policy)
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


def plan_replacement_file(pf: ProgramFile, out_path: str | os.PathLike,
                          num_frames: int,
                          policy: str | EvictionPolicy = "min",
                          annotations: AnnotationReader | str | None = None,
                          chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                          core: str = "array",
                          ) -> tuple[ProgramFile, ReplacementStats]:
    """Stage 2, out-of-core: stream a 'virtual' bytecode file (plus its
    next-use sidecar) into a 'physical' bytecode file.  With the default
    ``core="array"`` chunks stay record arrays end-to-end (no per-
    instruction decode/encode on the fast path)."""
    assert pf.phase == "virtual", pf.phase
    out_path = os.fspath(out_path)
    own_ann = annotations is None
    if own_ann:
        annotations = annotate_next_use(pf, out_path + ".ann",
                                        chunk_instrs).path
    if not isinstance(annotations, AnnotationReader):
        annotations = AnnotationReader(annotations)
    try:
        if annotations.n_records != pf.num_records:
            raise ValueError(
                f"annotation sidecar has {annotations.n_records} records "
                f"but program has {pf.num_records}; stale sidecar?")
        _check_budget(num_frames, annotations.max_touches)
        use_array = _use_array_core(core, policy) \
            and annotations.num_pages < ARRAY_MAX_VPAGES
        if use_array:
            stats = ReplacementStats(num_frames=num_frames,
                                     num_vpages=annotations.num_pages,
                                     policy=policy)
        else:
            pol = _policy(policy)
            stats = ReplacementStats(num_frames=num_frames,
                                     num_vpages=annotations.num_pages,
                                     policy=getattr(pol, "name", str(policy)))
        with writer_like(pf, out_path, phase="physical",
                         num_frames=num_frames,
                         chunk_instrs=chunk_instrs) as w:
            if use_array:
                ac = _ArrayCore(num_frames, policy, pf.page_shift,
                                pf.page_slots, annotations.num_pages, stats)
                for (s, rec, offs, pg, fl, na, nr) in \
                        _array_chunks_from_files(pf, annotations,
                                                 chunk_instrs):
                    w.append_records(ac.process_chunk(s, rec, offs, pg, fl,
                                                      na, nr))
            else:
                _replacement_core(
                    _items_from_files(pf, annotations, chunk_instrs),
                    num_frames, pol, pf.page_shift, pf.page_slots,
                    w.append, stats)
    finally:
        if own_ann and os.path.exists(annotations.path):
            os.unlink(annotations.path)
    return ProgramFile(out_path), stats
