"""Batched Shamir driver (the port's counterpart of
``repro.exec.batched_shamir``): share-local field ops over span columns.

Linear ops and share-wise products vectorize trivially: gather the
group's operand spans into one (rows, length, lane) device tensor, run
the GF(2^61 - 1) ops once, scatter back.  ``F_EVAL`` is deliberately NOT
batchable: its immediates carry a per-instruction round id, so the batch
scheduler's uniform-immediate grouping always leaves it a singleton and
the scalar driver (whose PRF is keyed by that same rid, not by execution
order) remains the single implementation of resharing randomness.
"""

from __future__ import annotations

import torch

from ..core.bytecode import Op
from ..protocols.shamir.field import (P, addmod, mulmod, mulmod_scalar,
                                      submod)
from .base import BatchedProtocolDriver, SpanCol, gather_spans, scatter_spans


class BatchedShamirDriver(BatchedProtocolDriver):
    batch_ops = frozenset({Op.F_ADD, Op.F_SUB, Op.F_MUL_LOCAL, Op.F_MULC,
                           Op.F_ADDC, Op.F_MULC_ADD, Op.COPY})

    def execute_batch(self, op: Op, imm: tuple, out_idx: list[SpanCol],
                      in_idx: list[SpanCol], memory: torch.Tensor) -> None:
        a = gather_spans(memory, in_idx[0])
        if op == Op.COPY:
            scatter_spans(memory, out_idx[0], a)
            return
        if op == Op.F_ADD:
            r = addmod(a, gather_spans(memory, in_idx[1]))
        elif op == Op.F_SUB:
            r = submod(a, gather_spans(memory, in_idx[1]))
        elif op == Op.F_MUL_LOCAL:
            r = mulmod(a, gather_spans(memory, in_idx[1]))
        elif op == Op.F_MULC:
            r = mulmod_scalar(a, imm[1])
        elif op == Op.F_ADDC:
            r = addmod(a, imm[1] % P)
        elif op == Op.F_MULC_ADD:
            r = addmod(a, mulmod_scalar(gather_spans(memory, in_idx[1]),
                                        imm[1]))
        else:  # pragma: no cover - batch_ops gates what reaches us
            raise NotImplementedError(f"batched shamir: {op}")
        scatter_spans(memory, out_idx[0], r)
