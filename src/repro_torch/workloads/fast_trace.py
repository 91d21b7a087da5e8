"""Vectorized trace builders for the §8.1.1 GC workloads (single worker):
the port's copy of ``repro.workloads.fast_trace``.

Because the programs are *oblivious*, the record stream of
``merge``/``sort``/``mvmul`` is a function of ``n`` alone, so it can be
assembled with NumPy column writes — one Python iteration per *network
stage* (O(log^2 n) of them) instead of one ``Builder.emit`` per
instruction.  The builders are digest-identical to the FREE-stripped DSL
trace, which makes them a fast way to write paper-scale programs for the
streaming planner, and an executable spec of the DSL's allocation
behaviour:

* merge/sort touch only page-sized values (one ``GC_CHUNK`` record chunk
  = 4096 slots = one page), and :class:`~..core.placement.PageAllocator`
  gives page-sized values dedicated, strictly sequential pages — mid-
  build FREEs never perturb addresses, so pages are a running counter.
* mvmul's 256-slot accumulators live in a slab class whose addresses DO
  depend on the free/alloc interleaving; those allocations replay
  through a real ``PageAllocator`` in exactly the DSL's order (a few
  thousand trivial calls), while the record columns stay vectorized.

``write_*_program`` stream the records straight into a bytecode file via
``ProgramWriter.append_records`` — no ``Instr`` objects, no DSL.  Host
code only.
"""

from __future__ import annotations

import numpy as np

from ..core.bytecode import (_IMM_OFF, _IN_OFF, _OUT_OFF, RECORD_WORDS, Op,
                             ProgramFile, ProgramWriter)
from ..core.placement import PageAllocator
from ..protocols.garbled.dsl import Party
from .base import GC_PAGE_SHIFT
from .gc_library import GC_CHUNK, KEY_W, RECORD_W
from .gc_workloads import A_TAGS, B_TAGS, OUT_TAGS, MV_NJ, MV_NR

_PAGE = 1 << GC_PAGE_SHIFT


def _word0(op: Op, n_outs: int, n_ins: int, n_imm: int) -> int:
    return int(op) | n_outs << 16 | n_ins << 20 | n_imm << 24


def _rows(n: int) -> np.ndarray:
    return np.zeros((n, RECORD_WORDS), dtype=np.int64)


def _inputs(pages: np.ndarray, party: Party, tags: np.ndarray,
            count: int = GC_CHUNK, width: int = RECORD_W) -> np.ndarray:
    """INPUT records for page-sized chunks at the given pages."""
    r = _rows(len(pages))
    r[:, 0] = _word0(Op.INPUT, 1, 0, 4)
    r[:, _OUT_OFF] = pages * _PAGE
    r[:, _OUT_OFF + 1] = _PAGE
    r[:, _IMM_OFF] = count
    r[:, _IMM_OFF + 1] = width
    r[:, _IMM_OFF + 2] = int(party)
    r[:, _IMM_OFF + 3] = tags
    return r


def _outputs(addrs: np.ndarray, tags: np.ndarray,
             count: int = GC_CHUNK, width: int = RECORD_W,
             nbytes: int = _PAGE) -> np.ndarray:
    r = _rows(len(addrs))
    r[:, 0] = _word0(Op.OUTPUT, 0, 1, 3)
    r[:, _IN_OFF] = addrs
    r[:, _IN_OFF + 1] = nbytes
    r[:, _IMM_OFF] = count
    r[:, _IMM_OFF + 1] = width
    r[:, _IMM_OFF + 2] = tags
    return r


def _sort_locals(in_addrs: np.ndarray, next_page: int, descending,
                 merge_only: bool) -> tuple[np.ndarray, np.ndarray, int]:
    """SORT_LOCAL per chunk; returns (records, new addrs, next_page)."""
    m = len(in_addrs)
    out = (next_page + np.arange(m, dtype=np.int64)) * _PAGE
    r = _rows(m)
    r[:, 0] = _word0(Op.SORT_LOCAL, 1, 1, 5)
    r[:, _OUT_OFF] = out
    r[:, _OUT_OFF + 1] = _PAGE
    r[:, _IN_OFF] = in_addrs
    r[:, _IN_OFF + 1] = _PAGE
    r[:, _IMM_OFF] = GC_CHUNK
    r[:, _IMM_OFF + 1] = RECORD_W
    r[:, _IMM_OFF + 2] = KEY_W
    r[:, _IMM_OFF + 3] = descending
    r[:, _IMM_OFF + 4] = int(merge_only)
    return r, out, next_page + m


def _merge_pass(chunk_addr: np.ndarray, k: int, next_page: int,
                out: list[np.ndarray]) -> int:
    """One ``_merge_stage`` (block size ``k`` slots) over the chunk
    sequence: MINMAX stages at chunk distance jc = k/2C .. 1, then the
    merge-only local finishes.  Mutates ``chunk_addr`` in place."""
    m = len(chunk_addr)
    cs_all = np.arange(m, dtype=np.int64)
    up_all = ((cs_all * GC_CHUNK) & k) == 0
    jc = min(k // (2 * GC_CHUNK), m // 2)
    while jc >= 1:
        cs = cs_all[(cs_all & jc) == 0]          # emission order: c asc
        ps = cs ^ jc
        up = up_all[cs]
        r = _rows(len(cs))
        mn = (next_page + 2 * np.arange(len(cs), dtype=np.int64)) * _PAGE
        mx = mn + _PAGE                           # mn allocated before mx
        next_page += 2 * len(cs)
        r[:, 0] = _word0(Op.MINMAX, 2, 2, 3)
        r[:, _OUT_OFF] = mn
        r[:, _OUT_OFF + 1] = _PAGE
        r[:, _OUT_OFF + 2] = mx
        r[:, _OUT_OFF + 3] = _PAGE
        r[:, _IN_OFF] = chunk_addr[cs]
        r[:, _IN_OFF + 1] = _PAGE
        r[:, _IN_OFF + 2] = chunk_addr[ps]
        r[:, _IN_OFF + 3] = _PAGE
        r[:, _IMM_OFF] = GC_CHUNK
        r[:, _IMM_OFF + 1] = RECORD_W
        r[:, _IMM_OFF + 2] = KEY_W
        out.append(r)
        chunk_addr[cs] = np.where(up, mn, mx)
        chunk_addr[ps] = np.where(up, mx, mn)
        jc //= 2
    r, addrs, next_page = _sort_locals(chunk_addr, next_page,
                                       (~up_all).astype(np.int64), True)
    out.append(r)
    chunk_addr[:] = addrs
    return next_page


def build_merge_records(n: int) -> np.ndarray:
    """The FREE-stripped single-worker ``merge`` trace for ``n`` records
    per party, as one ``[*, RECORD_WORDS]`` array."""
    q, rem = divmod(n, GC_CHUNK)
    m = 2 * q
    if rem or q <= 0 or m & (m - 1):
        raise ValueError(f"merge needs n a chunk multiple with 2n/{GC_CHUNK} "
                         f"a power of two, got n={n}")
    i = np.arange(q, dtype=np.int64)
    out = [_inputs(i, Party.Garbler, A_TAGS + i),
           _inputs(q + i, Party.Evaluator, B_TAGS + i)]
    # [c.reverse() for c in reversed(b)]: in page 2q-1-j -> out page 2q+j
    rev = _rows(q)
    rev[:, 0] = _word0(Op.REVERSE, 1, 1, 2)
    rev[:, _OUT_OFF] = (2 * q + i) * _PAGE
    rev[:, _OUT_OFF + 1] = _PAGE
    rev[:, _IN_OFF] = (2 * q - 1 - i) * _PAGE
    rev[:, _IN_OFF + 1] = _PAGE
    rev[:, _IMM_OFF] = GC_CHUNK
    rev[:, _IMM_OFF + 1] = RECORD_W
    out.append(rev)
    chunk_addr = np.concatenate([i * _PAGE, (2 * q + i) * _PAGE])
    next_page = _merge_pass(chunk_addr, m * GC_CHUNK, 3 * q, out)
    c = np.arange(m, dtype=np.int64)
    out.append(_outputs(chunk_addr, OUT_TAGS + c))
    return np.vstack(out)


def build_sort_records(n: int) -> np.ndarray:
    """The FREE-stripped single-worker ``sort`` trace for ``n`` records."""
    q, rem = divmod(n, GC_CHUNK)
    if rem or q <= 0 or q & (q - 1):
        raise ValueError(f"sort needs n a power-of-two multiple of "
                         f"{GC_CHUNK}, got n={n}")
    c = np.arange(q, dtype=np.int64)
    out = [_inputs(c, Party.Garbler, A_TAGS + c)]
    # initial local sorts: ascending iff bit C of the chunk base is clear
    desc = (((c * GC_CHUNK) & GC_CHUNK) != 0).astype(np.int64)
    r, chunk_addr, next_page = _sort_locals(c * _PAGE, q, desc, False)
    out.append(r)
    k = 2 * GC_CHUNK
    while k <= n:
        next_page = _merge_pass(chunk_addr, k, next_page, out)
        k *= 2
    out.append(_outputs(chunk_addr, OUT_TAGS + c))
    return np.vstack(out)


def build_mvmul_records(n: int) -> np.ndarray:
    """The FREE-stripped single-worker ``mvmul`` trace for an n x n
    8-bit matrix.  Accumulators are 256-slot slab values whose addresses
    depend on the DSL's alloc/free interleaving, so those replay through
    a real :class:`PageAllocator`; everything else is closed-form."""
    if n <= 0 or n % MV_NJ or n % MV_NR:
        raise ValueError(f"mvmul needs n a multiple of {MV_NJ}, got n={n}")
    J, R = n // MV_NJ, n // MV_NR
    alloc = PageAllocator(GC_PAGE_SHIFT)
    vec = np.fromiter((alloc.alloc(8 * MV_NJ) for _ in range(J)),
                      dtype=np.int64, count=J)
    mat = np.fromiter((alloc.alloc(8 * MV_NR * MV_NJ) for _ in range(R * J)),
                      dtype=np.int64, count=R * J).reshape(R, J)
    zero = alloc.alloc(32 * MV_NR)

    j = np.arange(J, dtype=np.int64)
    out = [_rows(J)]
    out[0][:, 0] = _word0(Op.INPUT, 1, 0, 4)
    out[0][:, _OUT_OFF] = vec
    out[0][:, _OUT_OFF + 1] = 8 * MV_NJ
    out[0][:, _IMM_OFF] = MV_NJ
    out[0][:, _IMM_OFF + 1] = 8
    out[0][:, _IMM_OFF + 2] = int(Party.Evaluator)
    out[0][:, _IMM_OFF + 3] = B_TAGS + j
    mi = _rows(R * J)
    mi[:, 0] = _word0(Op.INPUT, 1, 0, 4)
    mi[:, _OUT_OFF] = mat.reshape(-1)
    mi[:, _OUT_OFF + 1] = 8 * MV_NR * MV_NJ
    mi[:, _IMM_OFF] = MV_NR * MV_NJ
    mi[:, _IMM_OFF + 1] = 8
    mi[:, _IMM_OFF + 2] = int(Party.Garbler)
    mi[:, _IMM_OFF + 3] = A_TAGS + np.arange(R * J, dtype=np.int64)
    out.append(mi)
    zi = _rows(1)
    zi[0, 0] = _word0(Op.INPUT, 1, 0, 4)
    zi[0, _OUT_OFF] = zero
    zi[0, _OUT_OFF + 1] = 32 * MV_NR
    zi[0, _IMM_OFF] = MV_NR
    zi[0, _IMM_OFF + 1] = 32
    zi[0, _IMM_OFF + 2] = int(Party.Garbler)
    zi[0, _IMM_OFF + 3] = 1 << 28
    out.append(zi)

    # acc chains: r's new acc allocs before the previous one frees (the
    # rebinding in `acc = mat[r][j].mac8(vec[j], acc)` drops the old ref
    # only after mac8 returns); finals stay live until the OUTPUT phase
    finals = np.empty(R, dtype=np.int64)
    accs = np.empty((R, J + 1), dtype=np.int64)
    for r in range(R):
        prev = zero
        for jj in range(J):
            cur = alloc.alloc(32 * MV_NR)
            accs[r, jj] = prev
            accs[r, jj + 1] = cur
            if prev != zero:
                alloc.free(prev)
            prev = cur
        finals[r] = prev
    mac = _rows(R * J)
    mac[:, 0] = _word0(Op.MAC8, 1, 3, 3)
    mac[:, _OUT_OFF] = accs[:, 1:].reshape(-1)
    mac[:, _OUT_OFF + 1] = 32 * MV_NR
    mac[:, _IN_OFF] = mat.reshape(-1)
    mac[:, _IN_OFF + 1] = 8 * MV_NR * MV_NJ
    mac[:, _IN_OFF + 2] = np.tile(vec, R)
    mac[:, _IN_OFF + 3] = 8 * MV_NJ
    mac[:, _IN_OFF + 4] = accs[:, :-1].reshape(-1)
    mac[:, _IN_OFF + 5] = 32 * MV_NR
    mac[:, _IMM_OFF] = MV_NR
    mac[:, _IMM_OFF + 1] = MV_NJ
    mac[:, _IMM_OFF + 2] = 32
    out.append(mac)
    out.append(_outputs(finals, OUT_TAGS + np.arange(R, dtype=np.int64),
                        count=MV_NR, width=32, nbytes=32 * MV_NR))
    return np.vstack(out)


def _write(path, name: str, n: int, rec: np.ndarray,
           pages: int) -> ProgramFile:
    w = ProgramWriter(path, page_shift=GC_PAGE_SHIFT, protocol="gc",
                      vspace_slots=pages << GC_PAGE_SHIFT,
                      meta={"workload": name, "n": n})
    w.append_records(rec)
    return w.close()


def write_merge_program(path, n: int) -> ProgramFile:
    rec = build_merge_records(n)
    pages = int(rec[:, _OUT_OFF].max()) // _PAGE + 1
    return _write(path, "merge", n, rec, pages)


def write_sort_program(path, n: int) -> ProgramFile:
    rec = build_sort_records(n)
    pages = int(rec[:, _OUT_OFF].max()) // _PAGE + 1
    return _write(path, "sort", n, rec, pages)


def write_mvmul_program(path, n: int) -> ProgramFile:
    rec = build_mvmul_records(n)
    top = int(max(rec[:, _OUT_OFF].max(), rec[:, _IN_OFF].max()))
    return _write(path, "mvmul", n, rec, top // _PAGE + 1)
