"""Garbled-circuit protocol drivers for the port's engine (§7.3): the
counterparts of ``repro.protocols.garbled.driver``'s garbler and evaluator.

Wire-addressed address space: one slot = one 128-bit wire label (lane=2,
int64).  The garbler's memory holds zero-labels, the evaluator's the
active labels; swapping either is sound because labels are flat data (no
pointers, §7.1).  Both parties interpret the SAME bytecode and expand each
instruction identically, keeping the streamed garbled tables in lockstep.
The ops are those the ported workloads emit; the other integer ops and the
plaintext oracle driver wait for later slices.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...core.bytecode import Op
from ...core.engine import ProtocolDriver
from .engineops import AndXorOps
from .gates import EvaluatorGates, GarblerGates, Gates, PartyChannel

InputProvider = Callable[[int], np.ndarray]  # tag -> uint64 vector


def _split_bits(vals: np.ndarray, w: int) -> np.ndarray:
    """(n,) uint64 -> (n, w) uint8 little-endian bits."""
    shifts = np.arange(w, dtype=np.uint64)
    return ((vals[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)


def _join_bits(bits: np.ndarray) -> np.ndarray:
    """(n, w) bits -> (n,) uint64, the inverse of :func:`_split_bits`."""
    shifts = np.arange(bits.shape[1], dtype=np.uint64)
    return np.bitwise_or.reduce(bits.astype(np.uint64) << shifts, axis=1)


class _GCDriverBase(ProtocolDriver):
    lane = 2
    dtype = torch.int64

    def __init__(self, gates: Gates, input_provider: InputProvider | None):
        self.gates = gates
        self.ops = AndXorOps(gates)
        self.input_provider = input_provider
        self.outputs: dict[int, np.ndarray] = {}

    def execute(self, op: Op, imm: tuple, outs, ins) -> None:
        o = self.ops
        if op == Op.INPUT:
            n, w, party, tag = imm[0], imm[1], imm[2], imm[3]
            outs[0].copy_(self._input(n, w, party, tag).reshape(-1, 2))
        elif op == Op.OUTPUT:
            n, w, tag = imm[0], imm[1], imm[2]
            self._output(ins[0].reshape(n, w, 2), n, w, tag)
        elif op == Op.MINMAX:
            n, w, kw = imm[0], imm[1], imm[2]
            mn, mx = o.minmax(ins[0].reshape(n, w, 2),
                              ins[1].reshape(n, w, 2), kw)
            outs[0].copy_(mn.reshape(-1, 2))
            outs[1].copy_(mx.reshape(-1, 2))
        elif op == Op.SORT_LOCAL:
            n, w, kw = imm[0], imm[1], imm[2]
            desc = bool(imm[3]) if len(imm) > 3 else False
            merge_only = bool(imm[4]) if len(imm) > 4 else False
            r = o.sort_local(ins[0].reshape(1, n, w, 2), kw,
                             direction_up=not desc, merge_only=merge_only)
            outs[0].copy_(r.reshape(-1, 2))
        elif op == Op.REVERSE:
            n, w = imm[0], imm[1]
            outs[0].copy_(ins[0].reshape(n, w, 2).flip(0).reshape(-1, 2))
        else:
            raise NotImplementedError(f"GC driver: {op.name} is not ported "
                                      f"yet")

    # party-specific:
    def _input(self, n, w, party, tag) -> torch.Tensor:
        raise NotImplementedError

    def _output(self, labels, n, w, tag) -> None:
        raise NotImplementedError


class GarblerDriver(_GCDriverBase):
    name = "gc-garbler"
    PARTY = 0

    def __init__(self, channel: PartyChannel, device: torch.device,
                 input_provider: InputProvider | None = None, seed: int = 7):
        super().__init__(GarblerGates(channel, device, seed=seed),
                         input_provider)

    def _input(self, n, w, party, tag):
        g = self.gates
        if party == GarblerDriver.PARTY:
            vals = np.asarray(self.input_provider(tag), dtype=np.uint64)
            return g.input_garbler(_split_bits(vals, w).reshape(-1))
        return g.input_evaluator(n * w)

    def _output(self, labels, n, w, tag):
        self.gates.output(labels.reshape(-1, 2))


class EvaluatorDriver(_GCDriverBase):
    name = "gc-evaluator"
    PARTY = 1

    def __init__(self, channel: PartyChannel, device: torch.device,
                 input_provider: InputProvider | None = None):
        super().__init__(EvaluatorGates(channel, device), input_provider)

    def _input(self, n, w, party, tag):
        g = self.gates
        if party == EvaluatorDriver.PARTY:
            vals = np.asarray(self.input_provider(tag), dtype=np.uint64)
            return g.input_evaluator(_split_bits(vals, w).reshape(-1))
        return g.input_garbler(n * w)

    def _output(self, labels, n, w, tag):
        bits = self.gates.output(labels.reshape(-1, 2)).reshape(n, w)
        self.outputs[tag] = _join_bits(bits)
