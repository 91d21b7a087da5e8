"""MAGE planner: page-touch extraction and next-use annotation (§6.3).

The port's copy of the in-memory scalar cores of ``repro.core.liveness``
(the vectorized record-array cores and the streaming sidecar wait for the
streaming planner; they give identical output, tests/test_array_core.py).

The backward pass over the bytecode annotates, for every (instruction, page)
touch, when the page is touched next (``next_any``) and when it is next READ
(``next_read``).  Belady's MIN consumes ``next_any``; the write-back decision
consumes ``next_read``:

  * drop-on-evict is safe iff next_read == INF — no later instruction can
    observe the page, because any later read would have made next_read finite;
  * a swap-in on a residency miss is elided iff the touching instruction
    overwrites the whole page without reading it (write-allocate elision).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bytecode import INF, Instr, Program, strip_frees

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


def max_pages_per_instr(t: Touches) -> int:
    if len(t.offsets) <= 1:
        return 0
    return int(np.max(np.diff(t.offsets)))


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
