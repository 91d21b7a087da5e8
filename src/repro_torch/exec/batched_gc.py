"""Batched driver for the garbler and evaluator (the port's counterpart of
``repro.exec.batched_gc``).

The GC drivers are elementwise over the value axis: a batch of ``count``
independent MINMAXes of n values each is one MINMAX of ``count * n``
values — gather the label columns, stack them on the value axis, and run
the *same* ``AndXorOps`` subcircuit code once.  Both parties derive the
identical batch schedule from the identical plan, so their gate-id streams
and table messages stay in lockstep.

Every AND gate goes through ``Gates.and_``, which is the half-gates kernel
on a card (``kernels.garble.ops``); there is no other AND path.
"""

from __future__ import annotations

import torch

from ..core.bytecode import Op
from ..protocols.garbled.driver import _GCDriverBase
from .base import (BatchedProtocolDriver, SpanCol, gather_spans,
                   scatter_spans)

_GC_BATCH_OPS = frozenset({Op.MINMAX, Op.REVERSE, Op.SORT_LOCAL})


class BatchedGCDriver(BatchedProtocolDriver):
    """Batched garbler/evaluator driver (wraps a ``_GCDriverBase``)."""

    batch_ops = _GC_BATCH_OPS

    def __init__(self, inner: _GCDriverBase):
        super().__init__(inner)
        self.gates = inner.gates
        self.ops = inner.ops

    def execute_batch(self, op: Op, imm: tuple, out_idx: list[SpanCol],
                      in_idx: list[SpanCol], memory: torch.Tensor) -> None:
        n, w = imm[0], imm[1]
        count = len(out_idx[0][0])
        o = self.ops

        def stacked(col: SpanCol, ww: int) -> torch.Tensor:
            # (count, n*ww, 2) labels -> (count*n, ww, 2): batch on the
            # value axis, where every GC subcircuit is elementwise
            return gather_spans(memory, col).reshape(count * n, ww, 2)

        if op == Op.MINMAX:
            mn, mx = o.minmax(stacked(in_idx[0], w), stacked(in_idx[1], w),
                              imm[2])
            scatter_spans(memory, out_idx[0], mn)
            scatter_spans(memory, out_idx[1], mx)
        elif op == Op.REVERSE:
            x = gather_spans(memory, in_idx[0]).reshape(count, n, w, 2)
            scatter_spans(memory, out_idx[0], x.flip(1))
        elif op == Op.SORT_LOCAL:
            desc = bool(imm[3]) if len(imm) > 3 else False
            merge_only = bool(imm[4]) if len(imm) > 4 else False
            # count independent networks over the same public layout: each
            # compare-exchange step is ONE minmax over all their pairs
            v = gather_spans(memory, in_idx[0]).reshape(count, n, w, 2)
            scatter_spans(memory, out_idx[0],
                          o.sort_local(v, imm[2], direction_up=not desc,
                                       merge_only=merge_only))
        else:  # pragma: no cover - engine checks batch_ops first
            raise NotImplementedError(f"batched GC: {op}")
