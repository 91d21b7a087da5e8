"""BatchedProtocolDriver: the contract between the engine's batched fast
path and protocol-specific batch kernels (the port's copy of
``repro.exec.base``, on device tensors).

A batched driver *wraps* a scalar ``ProtocolDriver`` — the scalar driver
still handles every instruction the batch path declines (barriers, ops
outside ``batch_ops``, singleton groups).  The engine hands a batch as
column arrays:

    execute_batch(op, imm, out_idx, in_idx, memory)

* ``op``      — the shared opcode of the group;
* ``imm``     — the group's (uniform) immediate tuple;
* ``out_idx`` / ``in_idx`` — one ``(starts, length)`` pair per operand
  slot: ``starts`` is an int64 ``(count,)`` host array of span start
  addresses, ``length`` the shared span length;
* ``memory``  — the engine's memory tensor, shape ``(n_slots, lane)``.

Gather and scatter index the device memory with an index tensor built from
the host records of the group: one small host-to-device copy per group.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bytecode import Op
from ..core.engine import ProtocolDriver
from ..kernels import to_device

#: one operand column: (span start addresses (count,), shared span length)
SpanCol = tuple[np.ndarray, int]


def _index(memory: torch.Tensor, col: SpanCol) -> torch.Tensor:
    starts, length = col
    return to_device(starts[:, None] + np.arange(length, dtype=np.int64),
                     memory.device)


def gather_spans(memory: torch.Tensor, col: SpanCol) -> torch.Tensor:
    """(count, length, lane) copy of the group's operand spans."""
    return memory[_index(memory, col)]


def scatter_spans(memory: torch.Tensor, col: SpanCol,
                  vals: torch.Tensor) -> None:
    memory[_index(memory, col)] = vals.reshape(len(col[0]), col[1], -1)


def strided_positions(col: SpanCol, n: int, stride: int) -> np.ndarray:
    """(count, n) slot addresses at ``start + k*stride``: the wire-strided
    value positions the plaintext driver reads and writes."""
    starts, _ = col
    return starts[:, None] + np.arange(n, dtype=np.int64) * stride


class BatchedProtocolDriver(ProtocolDriver):
    """Wraps a scalar driver; adds ``execute_batch`` over span columns."""

    #: ops this driver can execute batched; everything else scalar-delegates
    batch_ops: frozenset = frozenset()

    def __init__(self, inner: ProtocolDriver):
        self.inner = inner
        self.lane = inner.lane
        self.dtype = inner.dtype
        self.name = f"{inner.name}+batched"

    @property
    def outputs(self) -> dict:
        return getattr(self.inner, "outputs", {})

    def execute(self, op: Op, imm: tuple, outs, ins) -> None:
        self.inner.execute(op, imm, outs, ins)

    def finalize(self) -> None:
        self.inner.finalize()

    def execute_batch(self, op: Op, imm: tuple, out_idx: list[SpanCol],
                      in_idx: list[SpanCol], memory: torch.Tensor) -> None:
        raise NotImplementedError
