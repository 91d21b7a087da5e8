"""Batched drivers for the GC protocol family, the garbler/evaluator and
the plaintext oracle (the port's counterpart of ``repro.exec.batched_gc``).

The GC drivers are elementwise over the value axis: an ADD of n values is n
independent ripple-carry subcircuits, so a batch of ``count`` independent
ADDs is one ADD of ``count * n`` values — gather the label columns, stack
them on the value axis, and run the *same* ``AndXorOps`` subcircuit code
once.  Bit-level gates (XOR/AND/OR/NOT) flatten all the way to one
``Gates`` call per batch, which also makes one garbled-table message of the
batch's per-column ones.  Both parties derive the identical batch schedule
from the identical plan, so their gate-id streams and table messages stay
in lockstep.  The batched ops are the JAX package's, no more: PAIR_JOIN,
MAC8, XNOR_POP_SIGN and REDUCE_ADD run one at a time, as there.

Every AND gate goes through ``Gates.and_``, which is the half-gates kernel
on a card (``kernels.garble.ops``); there is no other AND path.
"""

from __future__ import annotations

import torch

from ..core.bytecode import Op
from ..kernels import to_device
from ..protocols.garbled.driver import (PlaintextDriver, _GCDriverBase,
                                        clear_elementwise, clear_strides,
                                        gc_bitwise)
from .base import (BatchedProtocolDriver, SpanCol, gather_spans,
                   scatter_spans, strided_positions)

_GC_BATCH_OPS = frozenset({
    Op.COPY, Op.XOR, Op.AND, Op.OR, Op.NOT, Op.ADD, Op.SUB, Op.MUL,
    Op.CMP_GE, Op.CMP_EQ, Op.SELECT, Op.MINMAX, Op.REVERSE,
    Op.SORT_LOCAL,
})


class BatchedGCDriver(BatchedProtocolDriver):
    """Batched garbler/evaluator driver (wraps a ``_GCDriverBase``)."""

    batch_ops = _GC_BATCH_OPS

    def __init__(self, inner: _GCDriverBase):
        super().__init__(inner)
        self.gates = inner.gates
        self.ops = inner.ops

    def execute_batch(self, op: Op, imm: tuple, out_idx: list[SpanCol],
                      in_idx: list[SpanCol], memory: torch.Tensor) -> None:
        if op == Op.COPY:
            scatter_spans(memory, out_idx[0],
                          gather_spans(memory, in_idx[0]))
            return
        n, w = imm[0], imm[1]
        count = len(out_idx[0][0])
        o = self.ops

        def stacked(k: int, ww: int = w) -> torch.Tensor:
            # (count, n*ww, 2) labels -> (count*n, ww, 2): batch on the
            # value axis, where every GC subcircuit is elementwise
            return gather_spans(memory, in_idx[k]).reshape(count * n, ww, 2)

        if op in (Op.XOR, Op.AND, Op.OR, Op.NOT):
            a = gather_spans(memory, in_idx[0]).reshape(-1, 2)
            b = None if op == Op.NOT else \
                gather_spans(memory, in_idx[1]).reshape(-1, 2)
            # one AND call for the whole batch
            r = gc_bitwise(self.gates, op, a, b, self.gates.and_)
        elif op == Op.ADD:
            r = o.add(stacked(0), stacked(1))
        elif op == Op.SUB:
            r = o.sub(stacked(0), stacked(1))
        elif op == Op.MUL:
            r = o.mul(stacked(0), stacked(1))
        elif op == Op.CMP_GE:
            r = o.cmp_ge(stacked(0), stacked(1), imm[2])
        elif op == Op.CMP_EQ:
            r = o.cmp_eq(stacked(0), stacked(1), imm[2])
        elif op == Op.SELECT:
            r = o.select(stacked(0, 1), stacked(1), stacked(2))
        elif op == Op.MINMAX:
            mn, mx = o.minmax(stacked(0), stacked(1), imm[2])
            scatter_spans(memory, out_idx[0], mn)
            scatter_spans(memory, out_idx[1], mx)
            return
        elif op == Op.REVERSE:
            r = gather_spans(memory, in_idx[0]).reshape(count, n, w, 2) \
                .flip(1)
        elif op == Op.SORT_LOCAL:
            desc = bool(imm[3]) if len(imm) > 3 else False
            merge_only = bool(imm[4]) if len(imm) > 4 else False
            # count independent networks over the same public layout: each
            # compare-exchange step is ONE minmax over all their pairs
            v = gather_spans(memory, in_idx[0]).reshape(count, n, w, 2)
            r = o.sort_local(v, imm[2], direction_up=not desc,
                             merge_only=merge_only)
        else:  # pragma: no cover - engine checks batch_ops first
            raise NotImplementedError(f"batched GC: {op}")
        scatter_spans(memory, out_idx[0], r)


class BatchedPlaintextDriver(BatchedProtocolDriver):
    """Batched plaintext oracle: the vectorized mirror of
    ``PlaintextDriver``'s stride-w value layout.  It writes exactly the
    slots the scalar driver writes (the stride positions only), so the
    engine memory stays bitwise identical to a scalar replay."""

    batch_ops = _GC_BATCH_OPS

    def __init__(self, inner: PlaintextDriver):
        super().__init__(inner)

    def execute_batch(self, op: Op, imm: tuple, out_idx: list[SpanCol],
                      in_idx: list[SpanCol], memory: torch.Tensor) -> None:
        if op == Op.COPY:
            scatter_spans(memory, out_idx[0],
                          gather_spans(memory, in_idx[0]))
            return
        n = imm[0]
        s_in, s_out = clear_strides(op, imm[1], len(in_idx))

        def pos(col: SpanCol, stride: int) -> torch.Tensor:
            return to_device(strided_positions(col, n, stride), memory.device)

        # (count, n) values, the batch on the leading axis
        res = clear_elementwise(op, imm, [memory[pos(c, s), 0]
                                          for c, s in zip(in_idx, s_in)])
        for col, r in zip(out_idx, res):
            memory[pos(col, s_out), 0] = r.to(memory.dtype)
