"""The Integer DSL (paper Fig. 5), vectorized: the port's copy of
``repro.protocols.garbled.dsl``.

``Integer(width, count)`` is a *vector* of ``count`` secret integers of
``width`` bits — one DSL value = one bytecode operand (§4.2 coarsening).
Operators emit bytecode; nothing is computed at trace time.  A value's
wires occupy count*width contiguous slots and must fit one MAGE-virtual
page, so workloads chunk their data at the library level (lists of
Integers), exactly like the record lists in the paper's workloads.
"""

from __future__ import annotations

import enum

from ...core.bytecode import Op
from ...core.dsl import Value


class Party(enum.IntEnum):
    Garbler = 0
    Evaluator = 1


class Integer(Value):
    __slots__ = ("width", "count")

    def __init__(self, width: int, count: int = 1, builder=None):
        super().__init__(width * count, builder)
        self.width = width
        self.count = count

    # -- I/O --------------------------------------------------------------------

    def mark_input(self, party: Party, tag: int = 0) -> "Integer":
        self.builder.emit(Op.INPUT, outs=(self.span,),
                          imm=(self.count, self.width, int(party), tag))
        return self

    def mark_output(self, tag: int = 0) -> None:
        self.builder.emit(Op.OUTPUT, ins=(self.span,),
                          imm=(self.count, self.width, tag))

    # -- helpers ----------------------------------------------------------------

    def _like(self, width=None, count=None) -> "Integer":
        return Integer(width or self.width, count or self.count, self.builder)

    def _bin(self, op: Op, other: "Integer") -> "Integer":
        assert self.width == other.width and self.count == other.count, \
            f"shape mismatch {self.width}x{self.count} vs " \
            f"{other.width}x{other.count}"
        r = self._like()
        self.builder.emit(op, outs=(r.span,), ins=(self.span, other.span),
                          imm=(self.count, self.width))
        return r

    # -- operators --------------------------------------------------------------

    def __add__(self, o): return self._bin(Op.ADD, o)
    def __sub__(self, o): return self._bin(Op.SUB, o)
    def __mul__(self, o): return self._bin(Op.MUL, o)
    def __xor__(self, o): return self._bin(Op.XOR, o)
    def __and__(self, o): return self._bin(Op.AND, o)
    def __or__(self, o): return self._bin(Op.OR, o)

    def __invert__(self):
        r = self._like()
        self.builder.emit(Op.NOT, outs=(r.span,), ins=(self.span,),
                          imm=(self.count, self.width))
        return r

    def __ge__(self, o) -> "Integer":
        return self.cmp_ge(o)

    def __eq__(self, o) -> "Integer":  # type: ignore[override]
        return self.cmp_eq(o)

    __hash__ = None  # type: ignore[assignment]

    def cmp_ge(self, o: "Integer", key_w: int | None = None) -> "Integer":
        r = Integer(1, self.count, self.builder)
        self.builder.emit(Op.CMP_GE, outs=(r.span,), ins=(self.span, o.span),
                          imm=(self.count, self.width, key_w or self.width))
        return r

    def cmp_eq(self, o: "Integer", key_w: int | None = None) -> "Integer":
        r = Integer(1, self.count, self.builder)
        self.builder.emit(Op.CMP_EQ, outs=(r.span,), ins=(self.span, o.span),
                          imm=(self.count, self.width, key_w or self.width))
        return r

    def select(self, a: "Integer", b: "Integer") -> "Integer":
        """self (1-bit) ? a : b, element-wise."""
        assert self.width == 1 and a.count == b.count == self.count
        r = a._like()
        self.builder.emit(Op.SELECT, outs=(r.span,),
                          ins=(self.span, a.span, b.span),
                          imm=(a.count, a.width))
        return r

    def minmax(self, o: "Integer", key_w: int) -> tuple["Integer", "Integer"]:
        mn, mx = self._like(), self._like()
        self.builder.emit(Op.MINMAX, outs=(mn.span, mx.span),
                          ins=(self.span, o.span),
                          imm=(self.count, self.width, key_w))
        return mn, mx

    def sort_local(self, key_w: int, descending: bool = False,
                   merge_only: bool = False) -> "Integer":
        r = self._like()
        self.builder.emit(Op.SORT_LOCAL, outs=(r.span,), ins=(self.span,),
                          imm=(self.count, self.width, key_w,
                               int(descending), int(merge_only)))
        return r

    def reverse(self) -> "Integer":
        r = self._like()
        self.builder.emit(Op.REVERSE, outs=(r.span,), ins=(self.span,),
                          imm=(self.count, self.width))
        return r

    def pair_join(self, o: "Integer", key_w: int) -> "Integer":
        r = Integer(self.width, self.count * o.count, self.builder)
        self.builder.emit(Op.PAIR_JOIN, outs=(r.span,),
                          ins=(self.span, o.span),
                          imm=(self.count, o.count, self.width, key_w))
        return r

    def mac8(self, vec: "Integer", acc: "Integer") -> "Integer":
        """self: (nr*nj) 8-bit matrix chunk; vec: nj 8-bit; acc: nr wide."""
        nr, nj = acc.count, vec.count
        assert self.count == nr * nj and self.width == 8 and vec.width == 8
        r = acc._like()
        self.builder.emit(Op.MAC8, outs=(r.span,),
                          ins=(self.span, vec.span, acc.span),
                          imm=(nr, nj, acc.width))
        return r

    def xnor_pop_sign(self, vec: "Integer", rows: int) -> "Integer":
        nj = vec.count
        assert self.width == 1 and vec.width == 1 and self.count == rows * nj
        r = Integer(1, rows, self.builder)
        self.builder.emit(Op.XNOR_POP_SIGN, outs=(r.span,),
                          ins=(self.span, vec.span), imm=(rows, nj))
        return r

    def reduce_add(self) -> "Integer":
        r = Integer(self.width, 1, self.builder)
        self.builder.emit(Op.REDUCE_ADD, outs=(r.span,), ins=(self.span,),
                          imm=(self.count, self.width))
        return r


def Bit(count: int = 1, builder=None) -> Integer:
    """Bit is an alias for Integer<1> (paper §6.2.1)."""
    return Integer(1, count, builder)
