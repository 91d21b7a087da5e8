"""Batched CKKS driver (the port's counterpart of
``repro.exec.batched_ckks``): COPY, CT_ADD, CT_ADD_PLAIN and CT_MUL_NR over
a group of ``count`` independent instructions as one call each.

The group's operand spans are gathered into ``(count, ncomp, level+1, N)``
device tensors and handed to the context's ops, which take a leading batch:
a CT_MUL_NR group is one fused negacyclic-product launch over every
component and prime of every instruction: the forward transforms, the
products and the inverse transforms (``kernels.ntt``, ``ntt_mul``).  All
primes are below 2^31, so the batched
formulas replay the scalar arithmetic bit for bit.

CT_MUL / CT_RELIN / CT_MUL_PLAIN / INPUT / OUTPUT stay scalar: INPUT
consumes the driver's random draws in program order, which the schedule
builder keeps by making it a barrier.
"""

from __future__ import annotations

import torch

from ..core.bytecode import Op
from ..protocols.ckks.driver import CkksDriver
from .base import (BatchedProtocolDriver, SpanCol, gather_spans,
                   scatter_spans)


class BatchedCkksDriver(BatchedProtocolDriver):
    batch_ops = frozenset({Op.COPY, Op.CT_ADD, Op.CT_ADD_PLAIN,
                           Op.CT_MUL_NR})

    def __init__(self, inner: CkksDriver):
        super().__init__(inner)
        self.p = inner.p
        self.ctx = inner.ctx

    def _cts(self, memory: torch.Tensor, col: SpanCol, level: int,
             ncomp: int = 2) -> torch.Tensor:
        """(count, ncomp, level+1, n_ring) gathered ciphertext columns."""
        return gather_spans(memory, col).reshape(
            len(col[0]), ncomp, level + 1, self.p.n_ring)

    def execute_batch(self, op: Op, imm: tuple, out_idx: list[SpanCol],
                      in_idx: list[SpanCol], memory: torch.Tensor) -> None:
        p, ctx = self.p, self.ctx
        self.inner.op_counts[op] += len(out_idx[0][0])
        if op == Op.COPY:
            scatter_spans(memory, out_idx[0],
                          gather_spans(memory, in_idx[0]))
            return
        level = imm[0]
        if op == Op.CT_ADD:
            nc1, nc2 = imm[1], imm[2]
            sub = bool(imm[3]) if len(imm) > 3 else False
            fn = ctx.sub if sub else ctx.add
            out = fn(self._cts(memory, in_idx[0], level, nc1),
                     self._cts(memory, in_idx[1], level, nc2), level)
        elif op == Op.CT_ADD_PLAIN:
            # encoded plaintexts span the FULL prime chain; add uses the
            # first level+1 planes
            count = len(in_idx[1][0])
            pt = gather_spans(memory, in_idx[1]).reshape(
                count, p.levels + 1, p.n_ring)
            out = ctx.add_plain(self._cts(memory, in_idx[0], level), pt,
                                level)
        elif op == Op.CT_MUL_NR:
            out = ctx.mul_tensor(self._cts(memory, in_idx[0], level),
                                 self._cts(memory, in_idx[1], level), level)
        else:  # pragma: no cover - engine checks batch_ops first
            raise NotImplementedError(f"batched ckks: {op}")
        scatter_spans(memory, out_idx[0], out)
