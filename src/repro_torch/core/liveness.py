"""MAGE planner: page-touch extraction and next-use annotation (§6.3).

The port's copy of ``repro.core.liveness``: the in-memory scalar pass,
its vectorized record-array counterpart and the streaming next-use
sidecar, whose format (``MAGEAN01``, fixed-width records) is the JAX
package's, so a sidecar written by either side reads on the other.  All
of it is host code on NumPy arrays.

The backward pass over the bytecode annotates, for every (instruction, page)
touch, when the page is touched next (``next_any``) and when it is next READ
(``next_read``).  Belady's MIN consumes ``next_any``; the write-back decision
consumes ``next_read``:

  * drop-on-evict is safe iff next_read == INF — no later instruction can
    observe the page, because any later read would have made next_read finite;
  * a swap-in on a residency miss is elided iff the touching instruction
    overwrites the whole page without reading it (write-allocate elision),
    or the page was previously dropped (in which case, by the argument above,
    its first later touch must be write-only).

Storage layout is CSR-style flat numpy arrays so the planner's own memory
stays linear in the bytecode with a small constant (§6.1: the planner cannot
benefit from MAGE's own techniques, so it must be lean).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from .bytecode import (DEFAULT_CHUNK_INSTRS, INF, MAX_INS, MAX_OUTS,
                       _IN_OFF, _OUT_OFF, Instr, Op, Program, ProgramFile,
                       decode_chunk, encode_chunk, strip_frees, unpack_heads)

W_WRITE = 1       # touch includes a write
W_READ = 2        # touch includes a read
W_FULL_WRITE = 4  # writes cover the whole page


@dataclasses.dataclass
class Touches:
    """Per-instruction page touches for a stripped (FREE-less) program."""
    offsets: np.ndarray    # [N+1] int64, CSR offsets into the arrays below
    pages: np.ndarray      # [T] int64
    flags: np.ndarray      # [T] int8 (W_* bits)
    next_any: np.ndarray   # [T] int64 (instruction index or INF)
    next_read: np.ndarray  # [T] int64
    num_pages: int

    def row(self, i: int) -> slice:
        return slice(int(self.offsets[i]), int(self.offsets[i + 1]))


def compute_touches(prog: Program, instrs: list[Instr]) -> Touches:
    shift = prog.page_shift
    psize = prog.page_slots

    offsets = [0]
    pages: list[int] = []
    flags: list[int] = []

    for ins in instrs:
        row: dict[int, int] = {}
        covered: dict[int, int] = {}
        for (addr, n), is_write in ins.spans():
            lo = addr >> shift
            hi = (addr + n - 1) >> shift
            for p in range(lo, hi + 1):
                f = row.get(p, 0)
                if is_write:
                    f |= W_WRITE
                    # slots of this page covered by the write
                    s = max(addr, p << shift)
                    e = min(addr + n, (p + 1) << shift)
                    covered[p] = covered.get(p, 0) + (e - s)
                else:
                    f |= W_READ
                row[p] = f
        for p, f in row.items():
            if (f & W_WRITE) and not (f & W_READ) and covered.get(p, 0) >= psize:
                f |= W_FULL_WRITE
            pages.append(p)
            flags.append(f)
        offsets.append(len(pages))

    offs = np.asarray(offsets, dtype=np.int64)
    pg = np.asarray(pages, dtype=np.int64)
    fl = np.asarray(flags, dtype=np.int8)

    # Backward pass: next touch / next read per (instruction, page).
    n_t = len(pg)
    next_any = np.full(n_t, INF, dtype=np.int64)
    next_read = np.full(n_t, INF, dtype=np.int64)
    last_any: dict[int, int] = {}
    last_read: dict[int, int] = {}
    for i in range(len(instrs) - 1, -1, -1):
        for k in range(int(offs[i]), int(offs[i + 1])):
            p = int(pg[k])
            next_any[k] = last_any.get(p, INF)
            next_read[k] = last_read.get(p, INF)
            last_any[p] = i
            if fl[k] & W_READ:
                last_read[p] = i

    num_pages = int(pg.max()) + 1 if n_t else 0
    return Touches(offs, pg, fl, next_any, next_read, num_pages)


def stripped_touches(prog: Program, instrs: list[Instr] | None = None
                     ) -> tuple[list[Instr], Touches]:
    """THE strip-FREEs-then-extract-touches entry point.

    Every consumer that needs a program's page-touch structure
    (replacement, the OS-paging baseline, working-set sizing) goes through
    here instead of hand-rolling the ``strip_frees`` + ``compute_touches``
    pair."""
    if instrs is None:
        instrs = strip_frees(prog.instrs)
    return instrs, compute_touches(prog, instrs)


# ---------------------------------------------------------------------------
# Streaming annotation (§6.3's single backward pass, out-of-core).
#
# ``annotate_next_use`` scans a bytecode file's chunks in *reverse* file
# order and writes a fixed-width sidecar: for every instruction, its page
# touches with (page, flags, next_any, next_read).  Because the records are
# fixed width, the sidecar chunk for instructions [s, s+m) is written at
# offset s while the program is scanned backward — the planner never holds
# more than one chunk plus an O(live pages) carry dict.  The per-chunk math
# is vectorized NumPy (lexsort + segmented scans), replacing the
# per-instruction Python loop of ``compute_touches`` on the hot path.
# ---------------------------------------------------------------------------

ANN_MAGIC = b"MAGEAN01"
ANN_TOUCH_SLOTS = MAX_INS + MAX_OUTS
ANN_WORDS = 1 + 4 * ANN_TOUCH_SLOTS
ANN_BYTES = ANN_WORDS * 8
_ANN_HEADER = struct.Struct("<8s4qQ")


_DIGEST_MIX = np.uint64(0x9E3779B97F4A7C15)   # golden-ratio odd constant


def records_digest(acc: int, arr: np.ndarray, start: int) -> int:
    """XOR-combine per-record hashes of a record chunk into ``acc``.

    Each record hashes from its content and its *global* index only, and
    records combine by XOR — so the digest is independent of chunk size
    and of visit order.  That lets the reverse annotation scan and the
    forward replacement scan (possibly using different chunk_instrs)
    agree on it, which is how a stale sidecar is detected even when
    record counts happen to match (see plan_replacement_file)."""
    if arr.shape[0] == 0:
        return acc
    u = arr.view(np.uint64)
    w = (np.arange(1, arr.shape[1] + 1, dtype=np.uint64) * _DIGEST_MIX) | 1
    rows = (u * w).sum(axis=1, dtype=np.uint64)
    rows ^= np.arange(start, start + arr.shape[0],
                      dtype=np.uint64) * _DIGEST_MIX
    rows *= _DIGEST_MIX                      # finalize: mix high bits down
    rows ^= rows >> np.uint64(33)
    return acc ^ int(np.bitwise_xor.reduce(rows))


def file_digest(pf: ProgramFile,
                chunk_instrs: int = DEFAULT_CHUNK_INSTRS) -> int:
    """Fold :func:`records_digest` over a whole program file.  Chunk-size
    independent, so two files digest equal iff their records are
    bitwise-identical — the array-vs-scalar core gate in tests and
    ``table1_planning.py --cores``."""
    d = 0
    for s, arr in pf.iter_chunks(chunk_instrs):
        d = records_digest(d, arr, s)
    return d


@dataclasses.dataclass
class AnnotationInfo:
    path: str
    n_records: int
    num_pages: int
    max_touches: int
    prog_crc: int = 0


def _chunk_touches(rec: np.ndarray, shift: int, psize: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized page-touch extraction for one record chunk.

    Returns (pages, flags, present) of shape [m, ANN_TOUCH_SLOTS], slots
    ordered ins-then-outs with per-instruction duplicates merged into the
    first occurrence — byte-compatible with ``compute_touches``'s dict walk.
    """
    m = rec.shape[0]
    ops, n_outs, n_ins, _ = unpack_heads(rec[:, 0])
    if np.any(ops == int(Op.FREE)):
        raise ValueError(
            "bytecode file contains FREE pseudo-instructions; write it with "
            "write_program(..., strip_free=True) before planning")
    S = ANN_TOUCH_SLOTS
    pages = np.full((m, S), -1, dtype=np.int64)
    flags = np.zeros((m, S), dtype=np.int64)
    covered = np.zeros((m, S), dtype=np.int64)
    present = np.zeros((m, S), dtype=bool)

    def fill(slot: int, sel: np.ndarray, addr: np.ndarray, n: np.ndarray,
             is_write: bool) -> None:
        sel = sel & (n > 0)
        if not sel.any():
            return
        pg = addr >> shift
        hi = (addr + n - 1) >> shift
        if np.any(sel & (hi != pg)):
            raise ValueError(
                "operand span straddles a page boundary; the streaming "
                "planner requires the §6.2.2 invariant (use the in-memory "
                "planner for straddling spans)")
        pages[sel, slot] = pg[sel]
        flags[sel, slot] = W_WRITE if is_write else W_READ
        if is_write:
            covered[sel, slot] = n[sel]
        present[:, slot] |= sel

    for j in range(MAX_INS):
        fill(j, n_ins > j, rec[:, _IN_OFF + 2 * j],
             rec[:, _IN_OFF + 2 * j + 1], False)
    for j in range(MAX_OUTS):
        fill(MAX_INS + j, n_outs > j, rec[:, _OUT_OFF + 2 * j],
             rec[:, _OUT_OFF + 2 * j + 1], True)

    # merge duplicate pages within an instruction into the first slot
    for j in range(1, S):
        un = present[:, j].copy()
        if not un.any():
            continue
        for k in range(j):
            mm = un & present[:, k] & (pages[:, j] == pages[:, k])
            if mm.any():
                flags[mm, k] |= flags[mm, j]
                covered[mm, k] += covered[mm, j]
                un &= ~mm
        present[:, j] = un

    fw = (present & ((flags & W_WRITE) != 0) & ((flags & W_READ) == 0)
          & (covered >= psize))
    flags[fw] |= W_FULL_WRITE
    return pages, flags, present


def flat_touches(rec: np.ndarray, shift: int, psize: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CSR-style touch extraction for one record chunk.

    Returns ``(counts, rows, pages, flags)``: per-instruction touch counts
    plus flat per-touch arrays in touch order (the order ``compute_touches``
    produces).  Shared by the annotation pass, the record-array replacement
    core and working-set sizing."""
    pages, flags, present = _chunk_touches(rec, shift, psize)
    counts = present.sum(axis=1).astype(np.int64)
    rows, slots = np.nonzero(present)           # row-major: touch order
    return counts, rows.astype(np.int64), pages[rows, slots], \
        flags[rows, slots]


class _NextUseCarry:
    """Earliest known next-touch / next-read per page across the already-
    visited (later) chunks of the reverse scan.

    Dense grow-on-demand int64 arrays instead of int→int dicts: page ids
    are small consecutive integers here, so a direct gather/scatter
    replaces millions of boxed-int dict probes on paper-scale traces
    (same doubling pattern as ``working_set_pages_stream``)."""

    __slots__ = ("any", "read")

    def __init__(self, cap: int = 1024):
        self.any = np.full(cap, INF, dtype=np.int64)
        self.read = np.full(cap, INF, dtype=np.int64)

    def ensure(self, max_page: int) -> None:
        cap = self.any.shape[0]
        if max_page < cap:
            return
        grow = max(max_page + 1, 2 * cap)
        for name in self.__slots__:
            arr = np.full(grow, INF, dtype=np.int64)
            arr[:cap] = getattr(self, name)
            setattr(self, name, arr)


def _chunk_next_use(tl_page: np.ndarray, tl_flags: np.ndarray,
                    gi: np.ndarray, carry: _NextUseCarry
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized next_any/next_read for one chunk's flat touch list.

    ``gi`` is the global instruction index per touch; chunks must be
    visited in *reverse* program order — ``carry`` holds the earliest
    known next-touch / next-read per page across already-visited (later)
    chunks and is updated in place."""
    nt = len(gi)
    t_any = np.empty(nt, dtype=np.int64)
    t_read = np.empty(nt, dtype=np.int64)
    if nt == 0:
        return t_any, t_read
    order = np.lexsort((gi, tl_page))
    spage, sgi = tl_page[order], gi[order]
    sread = (tl_flags[order] & W_READ) != 0
    seg_start = np.empty(nt, dtype=bool)
    seg_start[0] = True
    seg_start[1:] = spage[1:] != spage[:-1]
    seg_id = np.cumsum(seg_start) - 1
    seg_first = np.where(seg_start)[0]
    upages = spage[seg_first]
    carry.ensure(int(upages[-1]))          # upages is sorted ascending

    has_next = np.zeros(nt, dtype=bool)
    has_next[:-1] = spage[:-1] == spage[1:]
    nxt_in_chunk = np.empty(nt, dtype=np.int64)
    nxt_in_chunk[:-1] = sgi[1:]
    nxt_in_chunk[-1] = INF
    s_any = np.where(has_next, nxt_in_chunk, carry.any[upages][seg_id])

    # suffix-min of read positions within each page segment
    sent = nt
    idx = np.arange(nt, dtype=np.int64)
    rd_pos = np.where(sread, idx, sent)
    big = nt + 2
    key = seg_id * big + rd_pos
    incl = np.minimum.accumulate(key[::-1])[::-1] - seg_id * big
    excl = np.full(nt, sent, dtype=np.int64)
    excl[:-1] = np.where(has_next[:-1], incl[1:], sent)
    s_read = np.where(excl < sent,
                      sgi[np.minimum(excl, nt - 1)],
                      carry.read[upages][seg_id])

    t_any[order] = s_any
    t_read[order] = s_read

    # carries: this chunk is *earlier* in the program than everything
    # processed so far
    first_rd = incl[seg_first]
    carry.any[upages] = sgi[seg_first]
    has_rd = first_rd < sent
    carry.read[upages[has_rd]] = sgi[first_rd[has_rd]]
    return t_any, t_read


def annotate_next_use(pf: ProgramFile, ann_path: str | os.PathLike,
                      chunk_instrs: int = DEFAULT_CHUNK_INSTRS
                      ) -> AnnotationInfo:
    """The streaming backward pass: write the next-use sidecar for ``pf``."""
    ann_path = os.fspath(ann_path)
    shift = pf.page_shift
    psize = pf.page_slots
    carry = _NextUseCarry()
    num_pages = 0
    max_touches = 0
    crc = 0
    with open(ann_path, "wb") as f:
        f.write(_ANN_HEADER.pack(ANN_MAGIC, 0, ANN_WORDS, 0, 0, 0))
        f.truncate(_ANN_HEADER.size + pf.num_records * ANN_BYTES)
        for start, rec in pf.iter_chunks(chunk_instrs, reverse=True):
            m = rec.shape[0]
            crc = records_digest(crc, rec, start)
            counts, rows, tl_page, tl_flags = flat_touches(rec, shift, psize)
            nt = len(rows)
            ann = np.zeros((m, ANN_WORDS), dtype=np.int64)
            ann[:, 0] = counts
            if nt:
                t_any, t_read = _chunk_next_use(tl_page, tl_flags,
                                                start + rows, carry)
                row_start = np.zeros(m, dtype=np.int64)
                np.cumsum(counts[:-1], out=row_start[1:])
                ordinal = np.arange(nt, dtype=np.int64) - \
                    np.repeat(row_start, counts)
                flat = ann.reshape(-1)
                base = rows * ANN_WORDS + 1 + ordinal * 4
                flat[base] = tl_page
                flat[base + 1] = tl_flags
                flat[base + 2] = t_any
                flat[base + 3] = t_read
                num_pages = max(num_pages, int(tl_page.max()) + 1)
                max_touches = max(max_touches, int(counts.max()))
            f.seek(_ANN_HEADER.size + start * ANN_BYTES)
            f.write(ann.tobytes())
        f.seek(0)
        f.write(_ANN_HEADER.pack(ANN_MAGIC, pf.num_records, ANN_WORDS,
                                 num_pages, max_touches, crc))
    return AnnotationInfo(ann_path, pf.num_records, num_pages, max_touches,
                          crc)


def touches_from_records(rec: np.ndarray, shift: int, psize: int,
                         chunk_instrs: int = DEFAULT_CHUNK_INSTRS) -> Touches:
    """Vectorized in-memory ``compute_touches`` over encoded records.

    Runs the exact per-chunk math of :func:`annotate_next_use` as a reverse
    scan over slices of an in-memory record array — same touch order, same
    next-use values, no sidecar file.  Raises ``ValueError`` on programs the
    record format cannot express (page-straddling spans, FREEs); callers
    fall back to the scalar :func:`compute_touches`."""
    n = rec.shape[0]
    carry = _NextUseCarry()
    parts = []
    for s in reversed(range(0, n, chunk_instrs)):
        sub = rec[s:s + chunk_instrs]
        counts, rows, pg, fl = flat_touches(sub, shift, psize)
        t_any, t_read = _chunk_next_use(pg, fl, s + rows, carry)
        parts.append((counts, pg, fl, t_any, t_read))
    parts.reverse()
    if parts:
        counts = np.concatenate([p[0] for p in parts])
        pg = np.concatenate([p[1] for p in parts])
        fl = np.concatenate([p[2] for p in parts])
        nxt = np.concatenate([p[3] for p in parts])
        nxr = np.concatenate([p[4] for p in parts])
    else:
        counts = np.zeros(0, dtype=np.int64)
        pg = np.zeros(0, dtype=np.int64)
        fl = np.zeros(0, dtype=np.int64)
        nxt = np.zeros(0, dtype=np.int64)
        nxr = np.zeros(0, dtype=np.int64)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    num_pages = int(pg.max()) + 1 if len(pg) else 0
    return Touches(offs, pg, fl.astype(np.int8), nxt, nxr, num_pages)


def iter_touch_chunks(prog: Program | ProgramFile,
                      chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                      decode: bool = True):
    """Yield ``(instrs, offsets, pages, flags)`` per chunk, FREE-stripped.

    THE shared touch-iteration helper for chunk-streaming consumers
    (working-set sizing): O(chunk) memory for a ProgramFile; in-memory
    Programs are encoded chunk-by-chunk (falling back to a
    ``compute_touches`` slice for chunks the record format cannot
    express, e.g. page-straddling spans).  ``decode=False`` yields the
    chunk's instruction COUNT in place of the instruction list, so
    touch-only consumers skip the per-instruction Instr construction."""
    shift, psize = prog.page_shift, prog.page_slots
    if not hasattr(prog, "instrs"):
        for _s, rec in prog.iter_chunks(chunk_instrs):
            counts, _rows, pg, fl = flat_touches(rec, shift, psize)
            offs = np.zeros(rec.shape[0] + 1, dtype=np.int64)
            np.cumsum(counts, out=offs[1:])
            yield (decode_chunk(rec) if decode else rec.shape[0]), offs, \
                pg, fl
        return
    instrs = strip_frees(prog.instrs)
    for s in range(0, len(instrs), chunk_instrs):
        sub = instrs[s:s + chunk_instrs]
        try:
            counts, _rows, pg, fl = flat_touches(encode_chunk(sub), shift,
                                                 psize)
            offs = np.zeros(len(sub) + 1, dtype=np.int64)
            np.cumsum(counts, out=offs[1:])
        except (TypeError, ValueError):
            t = compute_touches(prog, sub)
            offs, pg, fl = t.offsets, t.pages, t.flags
        yield (sub if decode else len(sub)), offs, pg, fl


class AnnotationReader:
    """Forward chunk reader for the next-use sidecar."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            magic, n, words, num_pages, max_touches, crc = \
                _ANN_HEADER.unpack(f.read(_ANN_HEADER.size))
        if magic != ANN_MAGIC or words != ANN_WORDS:
            raise ValueError(f"not a MAGE annotation file: {self.path}")
        self.n_records = n
        self.num_pages = num_pages
        self.max_touches = max_touches
        self.prog_crc = crc

    def iter_chunks(self, chunk_instrs: int = DEFAULT_CHUNK_INSTRS):
        with open(self.path, "rb") as f:
            for s in range(0, self.n_records, chunk_instrs):
                m = min(chunk_instrs, self.n_records - s)
                f.seek(_ANN_HEADER.size + s * ANN_BYTES)
                raw = f.read(m * ANN_BYTES)
                yield s, np.frombuffer(raw, dtype=np.int64).reshape(
                    m, ANN_WORDS)


def max_pages_per_instr(t: Touches) -> int:
    if len(t.offsets) <= 1:
        return 0
    return int(np.max(np.diff(t.offsets)))


def working_set_pages_stream(prog: Program | ProgramFile,
                             chunk_instrs: int = DEFAULT_CHUNK_INSTRS) -> int:
    """Peak simultaneously-live pages (w of §2.4.3), from chunked touches.

    The streaming counterpart of :func:`working_set_pages`: O(pages +
    chunk) memory and array-speed, so budget resolution stays cheap on
    paper-scale traces."""
    first = np.full(1024, INF, dtype=np.int64)
    last = np.full(1024, -1, dtype=np.int64)
    base = 0
    for m, offs, pages, _flags in iter_touch_chunks(prog, chunk_instrs,
                                                    decode=False):
        if len(pages):
            mp = int(pages.max())
            if mp >= first.shape[0]:
                grow = max(mp + 1, 2 * first.shape[0])
                f2 = np.full(grow, INF, dtype=np.int64)
                f2[:first.shape[0]] = first
                first = f2
                l2 = np.full(grow, -1, dtype=np.int64)
                l2[:last.shape[0]] = last
                last = l2
            gi = base + np.repeat(np.arange(m, dtype=np.int64),
                                  np.diff(offs))
            np.minimum.at(first, pages, gi)
            np.maximum.at(last, pages, gi)
        base += m
    valid = last >= 0
    if base == 0 or not valid.any():
        return 0
    delta = np.zeros(base + 1, dtype=np.int64)
    np.add.at(delta, first[valid], 1)
    np.add.at(delta, last[valid] + 1, -1)
    return int(np.cumsum(delta).max())


def working_set_pages(t: Touches) -> int:
    """Peak number of simultaneously-live pages (w in §2.4.3, page units).

    A page is live between its first touch and its last touch.
    """
    if t.num_pages == 0:
        return 0
    first = np.full(t.num_pages, -1, dtype=np.int64)
    last = np.zeros(t.num_pages, dtype=np.int64)
    n_instr = len(t.offsets) - 1
    for i in range(n_instr):
        for k in range(int(t.offsets[i]), int(t.offsets[i + 1])):
            p = int(t.pages[k])
            if first[p] < 0:
                first[p] = i
            last[p] = i
    delta = np.zeros(n_instr + 1, dtype=np.int64)
    for p in range(t.num_pages):
        if first[p] >= 0:
            delta[first[p]] += 1
            delta[last[p] + 1] -= 1
    return int(np.max(np.cumsum(delta))) if n_instr else 0
