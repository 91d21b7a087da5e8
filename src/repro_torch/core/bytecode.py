"""MAGE bytecode: the instruction stream the planner operates on.

The port's own copy of ``repro.core.bytecode``: in-memory programs, the
fixed-width record codec and the on-disk program files of saved plans
(``ProgramWriter`` / ``ProgramFile``).  Opcode numbers, the record layout
and the file format are the JAX package's, so a record array or a program
file written by either side reads on the other.

Following §4.2 of the paper, each instruction is a *high-level* DSL
operation (integer add, compare-exchange, ...), not a gate and not a raw
memory access.  Operands are spans in a MAGE-virtual (during placement) or
MAGE-physical (after replacement) address space measured in *slots* — for
garbled circuits one slot is one 128-bit wire label.  A value never
straddles a page boundary (§6.2.2).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import struct
from typing import Iterable, Iterator, Sequence

import numpy as np

INF = 1 << 62  # "never used again" sentinel for next-use times


class Op(enum.IntEnum):
    # ---- generic data movement -------------------------------------------
    INPUT = 1          # obtain (secret) input into outs[0]
    OUTPUT = 2         # reveal / externalize ins[0]
    COPY = 3           # outs[0] = ins[0]

    # ---- garbled-circuit style integer ops (AND-XOR engine) ---------------
    ADD = 10
    SUB = 11
    MUL = 12
    CMP_GE = 13        # outs[0](1-bit lanes) = ins[0] >= ins[1]
    CMP_EQ = 14
    SELECT = 15        # outs[0] = ins[0] ? ins[1] : ins[2]   (bitwise mux)
    XOR = 16
    AND = 17
    OR = 18
    NOT = 19
    MINMAX = 20        # (outs[0], outs[1]) = key-wise (min, max) of ins[0], ins[1]
    SORT_LOCAL = 21    # outs[0] = bitonic-sorted ins[0] (within-value network)
    PAIR_JOIN = 22
    MAC8 = 23
    XNOR_POP_SIGN = 24
    REDUCE_ADD = 25
    REVERSE = 26       # outs[0] = ins[0] with element order reversed (free)

    # ---- Shamir and CKKS ops (the Shamir driver waits for a later slice) --
    F_ADD = 50
    F_SUB = 51
    F_MULC = 52
    F_ADDC = 53
    F_MUL_LOCAL = 54
    F_EVAL = 55
    F_MULC_ADD = 56
    CT_ADD = 40
    CT_MUL = 41
    CT_MUL_NR = 42
    CT_RELIN = 43
    CT_ADD_PLAIN = 44
    CT_MUL_PLAIN = 45

    # ---- placement-internal pseudo instructions ----------------------------
    FREE = 60          # operand span is dead (emitted by the DSL allocator)

    # ---- swap directives (inserted by replacement/scheduling stages) -------
    SWAP_IN = 70          # imm=(vpage,); outs[0]=frame span         [synchronous]
    SWAP_OUT = 71         # imm=(vpage,); ins[0]=frame span          [synchronous]
    ISSUE_SWAP_IN = 72    # imm=(vpage, pf_slot)                     [async read]
    FINISH_SWAP_IN = 73   # imm=(vpage, pf_slot); outs[0]=frame span [wait+copy]
    COPY_OUT = 74         # imm=(pf_slot,); ins[0]=frame span        [frame -> pf]
    ISSUE_SWAP_OUT = 75   # imm=(vpage, pf_slot)                     [async write]
    FINISH_SWAP_OUT = 76  # imm=(pf_slot,)                           [wait]

    # ---- network directives (distributed-memory model, §5.1) --------------
    NET_SEND = 80
    NET_RECV = 81
    NET_BARRIER = 82


DIRECTIVES = frozenset({
    Op.SWAP_IN, Op.SWAP_OUT, Op.ISSUE_SWAP_IN, Op.FINISH_SWAP_IN,
    Op.COPY_OUT, Op.ISSUE_SWAP_OUT, Op.FINISH_SWAP_OUT,
    Op.NET_SEND, Op.NET_RECV, Op.NET_BARRIER,
})


Span = tuple[int, int]  # (start_slot_addr, n_slots)


@dataclasses.dataclass(frozen=True, slots=True)
class Instr:
    """One bytecode instruction: ``outs``/``ins`` are (addr, n_slots)
    spans; ``imm`` carries op-specific immediates the planner does not
    interpret (widths, constants, ...)."""
    op: Op
    outs: tuple[Span, ...] = ()
    ins: tuple[Span, ...] = ()
    imm: tuple = ()

    def spans(self) -> Iterator[tuple[Span, bool]]:
        for s in self.ins:
            yield s, False
        for s in self.outs:
            yield s, True


@dataclasses.dataclass
class Program:
    """A bytecode program for ONE worker.

    ``phase`` distinguishes the three §6.1 pipeline artifacts:
      'virtual'  — operands are MAGE-virtual addresses (placement output)
      'physical' — operands are MAGE-physical addresses + sync swap directives
      'memory'   — final memory program (scheduled, async directives)
    """
    instrs: list[Instr]
    page_shift: int
    protocol: str
    phase: str = "virtual"
    worker: int = 0
    num_workers: int = 1
    vspace_slots: int = 0        # extent of the MAGE-virtual address space
    num_frames: int = 0          # physical frames (phase >= physical)
    prefetch_slots: int = 0      # prefetch buffer pages (phase == memory)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def page_slots(self) -> int:
        return 1 << self.page_shift

    def num_vpages(self) -> int:
        return (self.vspace_slots + self.page_slots - 1) >> self.page_shift

    def op_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for ins in self.instrs:
            out[ins.op.name] = out.get(ins.op.name, 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.instrs)


def strip_frees(instrs: Sequence[Instr]) -> list[Instr]:
    return [i for i in instrs if i.op != Op.FREE]


# ---------------------------------------------------------------------------
# Fixed-width instruction records and program files (the JAX package's
# on-disk format).
#
# A program file is a small self-describing header followed by fixed-width
# 152-byte instruction records:
#
#   header:  MAGIC(8) | u32 json_len | json (page_shift, protocol, phase, ...)
#   records: n x RECORD_WORDS little-endian int64
#
# Record layout (int64 words):
#   word 0          op | n_outs<<16 | n_ins<<20 | n_imm<<24 | float_mask<<28
#   1 .. 4          outs[0..MAX_OUTS): (addr, n_slots) pairs
#   5 .. 12         ins[0..MAX_INS):   (addr, n_slots) pairs
#   13 .. 18        imm values; float64 immediates are stored bit-exactly via
#                   their IEEE-754 pattern, flagged in float_mask
# ---------------------------------------------------------------------------

FILE_MAGIC = b"MAGEBC01"
MAX_OUTS = 2
MAX_INS = 4
MAX_IMM = 6
_OUT_OFF = 1
_IN_OFF = _OUT_OFF + 2 * MAX_OUTS
_IMM_OFF = _IN_OFF + 2 * MAX_INS
RECORD_WORDS = _IMM_OFF + MAX_IMM
RECORD_BYTES = RECORD_WORDS * 8
DEFAULT_CHUNK_INSTRS = 8192

_REC_DTYPE = np.dtype("<i8")

_HEADER_FIELDS = ("page_shift", "protocol", "phase", "worker", "num_workers",
                  "vspace_slots", "num_frames", "prefetch_slots")


def unpack_heads(w0: np.ndarray) -> tuple[np.ndarray, ...]:
    """Split a vector of record head words into (op, n_outs, n_ins, n_imm)."""
    return (w0 & 0xFFFF, (w0 >> 16) & 0xF, (w0 >> 20) & 0xF,
            (w0 >> 24) & 0xF)


def _float_to_bits(v: float) -> int:
    return struct.unpack("<q", struct.pack("<d", v))[0]


def _bits_to_float(x: int) -> float:
    return struct.unpack("<d", struct.pack("<q", x))[0]


def encode_chunk(instrs: Sequence[Instr]) -> np.ndarray:
    """Encode instructions into an [n, RECORD_WORDS] int64 record array."""
    rows: list[list[int]] = []
    for ins in instrs:
        outs, inss, imm = ins.outs, ins.ins, ins.imm
        if len(outs) > MAX_OUTS or len(inss) > MAX_INS or len(imm) > MAX_IMM:
            raise ValueError(
                f"instruction exceeds record arity "
                f"(outs<={MAX_OUTS}, ins<={MAX_INS}, imm<={MAX_IMM}): {ins}")
        row = [0] * RECORD_WORDS
        k = _OUT_OFF
        for a, n in outs:
            row[k] = a
            row[k + 1] = n
            k += 2
        k = _IN_OFF
        for a, n in inss:
            row[k] = a
            row[k + 1] = n
            k += 2
        fmask = 0
        for j, v in enumerate(imm):
            if isinstance(v, float):
                fmask |= 1 << j
                row[_IMM_OFF + j] = _float_to_bits(v)
            elif isinstance(v, (int, np.integer)):
                row[_IMM_OFF + j] = int(v)
            else:
                raise TypeError(
                    f"imm values must be int or float for the record "
                    f"format, got {type(v).__name__}: {ins}")
        row[0] = (int(ins.op) | len(outs) << 16 | len(inss) << 20
                  | len(imm) << 24 | fmask << 28)
        rows.append(row)
    if not rows:
        return np.zeros((0, RECORD_WORDS), dtype=_REC_DTYPE)
    return np.array(rows, dtype=_REC_DTYPE)


def decode_chunk(arr: np.ndarray) -> list[Instr]:
    """Decode an [n, RECORD_WORDS] record array back into instructions."""
    if arr.ndim != 2 or arr.shape[1] != RECORD_WORDS:
        raise ValueError(f"bad record array shape {arr.shape}")
    out: list[Instr] = []
    ops = Op._value2member_map_
    for row in arr.tolist():              # bulk convert: python ints are fast
        w0 = row[0]
        n_outs = (w0 >> 16) & 0xF
        n_ins = (w0 >> 20) & 0xF
        n_imm = (w0 >> 24) & 0xF
        fmask = (w0 >> 28) & 0x3F
        out.append(Instr(
            ops[w0 & 0xFFFF],
            tuple((row[_OUT_OFF + 2 * j], row[_OUT_OFF + 2 * j + 1])
                  for j in range(n_outs)),
            tuple((row[_IN_OFF + 2 * j], row[_IN_OFF + 2 * j + 1])
                  for j in range(n_ins)),
            tuple(_bits_to_float(row[_IMM_OFF + j]) if fmask >> j & 1
                  else row[_IMM_OFF + j] for j in range(n_imm))))
    return out


def iter_record_chunks(prog: Program, chunk_instrs: int | None = None, *,
                       cache: bool = False
                       ) -> Iterator[tuple[int, np.ndarray | None, list]]:
    """Yield ``(start, rec, instrs)`` chunks of a Program: ``rec`` is the
    chunk's record array (``None`` where the record format cannot express
    it), ``instrs`` its instruction list.  ``cache=True`` memoizes the
    encoded chunks on the Program so repeated replays skip the encode."""
    if chunk_instrs is None:
        chunk_instrs = DEFAULT_CHUNK_INSTRS
    instrs = prog.instrs
    memo = getattr(prog, "_rec_chunk_cache", None) if cache else None
    if memo is not None and memo[0] == chunk_instrs:
        for i, s in enumerate(range(0, len(instrs), chunk_instrs)):
            yield s, memo[1][i], instrs[s:s + chunk_instrs]
        return
    recs: list[np.ndarray | None] = []
    for s in range(0, len(instrs), chunk_instrs):
        sub = instrs[s:s + chunk_instrs]
        try:
            rec = encode_chunk(sub)
        except (TypeError, ValueError):
            rec = None
        recs.append(rec)
        yield s, rec, sub
    if cache:
        prog._rec_chunk_cache = (chunk_instrs, recs)


class ProgramWriter:
    """Append-only writer of a program file: records are buffered and
    written as encoded chunks; ``meta`` must be JSON-serializable."""

    def __init__(self, path: str | os.PathLike, *, page_shift: int,
                 protocol: str, phase: str = "virtual", worker: int = 0,
                 num_workers: int = 1, vspace_slots: int = 0,
                 num_frames: int = 0, prefetch_slots: int = 0,
                 meta: dict | None = None,
                 chunk_instrs: int = DEFAULT_CHUNK_INSTRS):
        self.path = os.fspath(path)
        self.chunk_instrs = chunk_instrs
        self.num_records = 0
        self._buf: list[Instr] = []
        header = {"page_shift": page_shift, "protocol": protocol,
                  "phase": phase, "worker": worker,
                  "num_workers": num_workers, "vspace_slots": vspace_slots,
                  "num_frames": num_frames, "prefetch_slots": prefetch_slots,
                  "record_words": RECORD_WORDS, "meta": meta or {}}
        payload = json.dumps(header).encode()
        self._f = open(self.path, "wb")
        self._f.write(FILE_MAGIC)
        self._f.write(struct.pack("<I", len(payload)))
        self._f.write(payload)

    def append(self, instr: Instr) -> None:
        self._buf.append(instr)
        if len(self._buf) >= self.chunk_instrs:
            self._flush()

    def extend(self, instrs: Iterable[Instr]) -> None:
        for i in instrs:
            self.append(i)

    def _flush(self) -> None:
        if self._buf:
            self._f.write(encode_chunk(self._buf).tobytes())
            self.num_records += len(self._buf)
            self._buf.clear()

    def close(self) -> "ProgramFile":
        self._flush()
        self._f.close()
        return ProgramFile(self.path)

    def __enter__(self) -> "ProgramWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self._f.close()


class ProgramFile:
    """A program on disk: the header fields of a ``Program``, its ``meta``
    and chunked record access.  The engine and the schedule builders take
    an in-memory ``Program``: :meth:`read_program` materializes one."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            if f.read(8) != FILE_MAGIC:
                raise ValueError(f"not a MAGE bytecode file: {self.path}")
            (jlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(jlen))
        self._data_off = 12 + jlen
        data_bytes = os.path.getsize(self.path) - self._data_off
        if header.get("record_words") != RECORD_WORDS:
            raise ValueError(
                f"record width mismatch: file has {header.get('record_words')}"
                f" words, reader expects {RECORD_WORDS}")
        if data_bytes % RECORD_BYTES:
            raise ValueError(f"truncated bytecode file: {self.path}")
        self.num_records = data_bytes // RECORD_BYTES
        for k in _HEADER_FIELDS:
            setattr(self, k, header[k])
        self.meta: dict = header.get("meta", {})

    @property
    def page_slots(self) -> int:
        return 1 << self.page_shift

    def num_vpages(self) -> int:
        return (self.vspace_slots + self.page_slots - 1) >> self.page_shift

    def __len__(self) -> int:
        return self.num_records

    def iter_chunks(self, chunk_instrs: int = DEFAULT_CHUNK_INSTRS,
                    reverse: bool = False
                    ) -> Iterator[tuple[int, np.ndarray]]:
        """Yield (start_record_index, [m, RECORD_WORDS] array) windows."""
        n = self.num_records
        starts = range(0, n, chunk_instrs)
        if reverse:
            starts = reversed(starts)
        with open(self.path, "rb") as f:
            for s in starts:
                m = min(chunk_instrs, n - s)
                f.seek(self._data_off + s * RECORD_BYTES)
                raw = f.read(m * RECORD_BYTES)
                yield s, np.frombuffer(raw, dtype=_REC_DTYPE).reshape(
                    m, RECORD_WORDS)

    def iter_instrs(self, chunk_instrs: int = DEFAULT_CHUNK_INSTRS
                    ) -> Iterator[Instr]:
        for _, arr in self.iter_chunks(chunk_instrs):
            yield from decode_chunk(arr)

    def read_program(self) -> Program:
        """Materialize the whole file as an in-memory ``Program``."""
        return Program(instrs=list(self.iter_instrs()),
                       page_shift=self.page_shift, protocol=self.protocol,
                       phase=self.phase, worker=self.worker,
                       num_workers=self.num_workers,
                       vspace_slots=self.vspace_slots,
                       num_frames=self.num_frames,
                       prefetch_slots=self.prefetch_slots,
                       meta=dict(self.meta))


def writer_like(src: Program | ProgramFile, path: str | os.PathLike, *,
                phase: str | None = None, num_frames: int | None = None,
                prefetch_slots: int | None = None, meta: dict | None = None,
                chunk_instrs: int = DEFAULT_CHUNK_INSTRS) -> ProgramWriter:
    """A ProgramWriter with ``src``'s header fields, some overridden."""
    return ProgramWriter(
        path, page_shift=src.page_shift, protocol=src.protocol,
        phase=src.phase if phase is None else phase,
        worker=src.worker, num_workers=src.num_workers,
        vspace_slots=src.vspace_slots,
        num_frames=src.num_frames if num_frames is None else num_frames,
        prefetch_slots=(src.prefetch_slots if prefetch_slots is None
                        else prefetch_slots),
        meta=dict(src.meta) if meta is None else meta,
        chunk_instrs=chunk_instrs)


def write_program(prog: Program, path: str | os.PathLike,
                  strip_free: bool = False,
                  chunk_instrs: int = DEFAULT_CHUNK_INSTRS) -> ProgramFile:
    """Serialize an in-memory Program; ``strip_free=True`` drops the FREE
    pseudo-instructions."""
    w = writer_like(prog, path, chunk_instrs=chunk_instrs)
    w.extend(strip_frees(prog.instrs) if strip_free else prog.instrs)
    return w.close()
