"""The Integer DSL (paper Fig. 5), vectorized: the port's copy of
``repro.protocols.garbled.dsl``, pruned to the operations the ported
workloads use (the other integer ops wait for their workloads).

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


def Bit(count: int = 1, builder=None) -> Integer:
    """Bit is an alias for Integer<1> (paper §6.2.1)."""
    return Integer(1, count, builder)
