"""Garbled-circuit protocol drivers for the port's engine (§7.3): the
counterparts of ``repro.protocols.garbled.driver``.

Wire-addressed address space: one slot = one 128-bit wire label (lane=2,
int64).  The garbler's memory holds zero-labels, the evaluator's the
active labels; swapping either is sound because labels are flat data (no
pointers, §7.1).  Both parties interpret the SAME bytecode and expand each
instruction identically, keeping the streamed garbled tables in lockstep.
``PlaintextDriver`` executes the bytecode in the clear: it is the
correctness oracle and the cheap stand-in for real executions.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...core.bytecode import Op
from ...core.engine import ProtocolDriver
from ...kernels import to_device
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


def gc_bitwise(g: Gates, op: Op, a: torch.Tensor, b: torch.Tensor | None,
               and_: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
               ) -> torch.Tensor:
    """XOR/AND/OR/NOT of label tensors; ``and_`` makes the AND gates of
    (a, b), and an OR is a ^ b ^ (a & b)."""
    if op == Op.NOT:
        return g.not_(a)
    if op == Op.XOR:
        return g.xor(a, b)
    ands = and_(a, b)
    return ands if op == Op.AND else g.xor(g.xor(a, b), ands)


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
            return
        if op == Op.OUTPUT:
            n, w, tag = imm[0], imm[1], imm[2]
            self._output(ins[0].reshape(n, w, 2), n, w, tag)
            return
        if op == Op.COPY:
            outs[0].copy_(ins[0])
            return
        if op == Op.MINMAX:
            n, w, kw = imm[0], imm[1], imm[2]
            mn, mx = o.minmax(ins[0].reshape(n, w, 2),
                              ins[1].reshape(n, w, 2), kw)
            outs[0].copy_(mn.reshape(-1, 2))
            outs[1].copy_(mx.reshape(-1, 2))
            return
        n, w = imm[0], imm[1]

        def val(k: int, ww: int = w) -> torch.Tensor:
            return ins[k].reshape(n, ww, 2)

        if op in (Op.XOR, Op.AND, Op.OR, Op.NOT):
            r = gc_bitwise(self.gates, op, val(0),
                           None if op == Op.NOT else val(1), self._and_bits)
        elif op == Op.ADD:
            r = o.add(val(0), val(1))
        elif op == Op.SUB:
            r = o.sub(val(0), val(1))
        elif op == Op.MUL:
            r = o.mul(val(0), val(1))
        elif op == Op.CMP_GE:
            r = o.cmp_ge(val(0), val(1), imm[2])
        elif op == Op.CMP_EQ:
            r = o.cmp_eq(val(0), val(1), imm[2])
        elif op == Op.SELECT:
            r = o.select(val(0, 1), val(1), val(2))
        elif op == Op.SORT_LOCAL:
            desc = bool(imm[3]) if len(imm) > 3 else False
            merge_only = bool(imm[4]) if len(imm) > 4 else False
            r = o.sort_local(val(0)[None], imm[2], direction_up=not desc,
                             merge_only=merge_only)
        elif op == Op.REVERSE:
            r = val(0).flip(0)
        elif op == Op.PAIR_JOIN:
            na, nb, w, kw = imm
            r = o.pair_join(ins[0].reshape(na, w, 2),
                            ins[1].reshape(nb, w, 2), kw)
        elif op == Op.MAC8:
            nr, nj, acc_w = imm
            r = o.dot8(ins[0].reshape(nr * nj, 8, 2),
                       ins[1].reshape(nj, 8, 2),
                       ins[2].reshape(nr, acc_w, 2), nr, nj, acc_w)
        elif op == Op.XNOR_POP_SIGN:
            nr, nj = imm
            r = o.xnor_pop_sign(ins[0].reshape(nr * nj, 1, 2),
                                ins[1].reshape(nj, 1, 2), nr, nj)
        elif op == Op.REDUCE_ADD:
            r = o.reduce_add(val(0))
        else:
            raise NotImplementedError(f"GC driver: {op.name}")
        outs[0].copy_(r.reshape(-1, 2))

    def _and_bits(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a & b of (n, w) values, one AND call per bit, as the JAX
        package's scalar driver makes them."""
        g = self.gates
        at, bt = a.transpose(0, 1).contiguous(), b.transpose(0, 1).contiguous()
        return torch.stack([g.and_(at[i], bt[i]) for i in range(a.shape[1])],
                           dim=1)

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


# -- the plaintext oracle ------------------------------------------------------

_I64_MIN = -(1 << 63)


def value_mask(w: int) -> int:
    """The low-w-bit mask as an int64 (all ones, -1, from w = 64 up)."""
    return (1 << w) - 1 if w < 64 else -1


def unsigned_key(x: torch.Tensor, w: int) -> torch.Tensor:
    """The low w bits of int64 bit views as signed keys that order like
    the unsigned values (bit 63 flipped): torch has no unsigned compare."""
    return (x & value_mask(w)) ^ _I64_MIN


def shl(x: torch.Tensor, s: int) -> torch.Tensor:
    """x << s on 64-bit words; 0 from s = 64 up, as NumPy's uint64."""
    return x << s if s < 64 else torch.zeros_like(x)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical x >> s on 64-bit words (int64's ``>>`` is arithmetic)."""
    return (x >> s) & value_mask(64 - s) if s < 64 else torch.zeros_like(x)


def stable_order(key: torch.Tensor, descending: bool) -> torch.Tensor:
    """Indices that sort ``key`` (signed int64) ascending along the last
    axis, stably; ``descending`` reverses that order, as the JAX package's
    ``argsort(...)[::-1]`` does."""
    order = torch.sort(key, dim=-1, stable=True).indices
    return order.flip(-1) if descending else order


#: the ops :func:`clear_elementwise` computes: the batched drivers' ops
#: but COPY, which moves slots as they are
CLEAR_OPS = frozenset({
    Op.ADD, Op.SUB, Op.MUL, Op.XOR, Op.AND, Op.OR, Op.NOT, Op.CMP_GE,
    Op.CMP_EQ, Op.SELECT, Op.MINMAX, Op.REVERSE, Op.SORT_LOCAL,
})


def clear_strides(op: Op, w: int, n_in: int) -> tuple[list[int], int]:
    """The slot strides of an op's inputs and of its outputs in the
    plaintext layout: a value of w bits at every w-th slot, a 1-bit value
    (a condition, a comparison's result) at every slot."""
    ins = [1, w, w] if op == Op.SELECT else [w] * n_in
    return ins, (1 if op in (Op.CMP_GE, Op.CMP_EQ) else w)


def clear_elementwise(op: Op, imm: tuple, v: list[torch.Tensor]
                      ) -> list[torch.Tensor]:
    """The outputs of one of :data:`CLEAR_OPS` on plaintext values of
    shape (..., n), n the op's vector length: (n,) for one op, (count, n)
    for a batch of count."""
    m, w = value_mask, imm[1]
    if op == Op.ADD:
        return [(v[0] + v[1]) & m(w)]
    if op == Op.SUB:
        return [(v[0] - v[1]) & m(w)]
    if op == Op.MUL:
        return [(v[0] * v[1]) & m(w)]
    if op == Op.XOR:
        return [v[0] ^ v[1]]
    if op == Op.AND:
        return [v[0] & v[1]]
    if op == Op.OR:
        return [v[0] | v[1]]
    if op == Op.NOT:
        return [~v[0] & m(w)]
    if op in (Op.CMP_GE, Op.CMP_EQ):
        a, b = unsigned_key(v[0], imm[2]), unsigned_key(v[1], imm[2])
        return [(a >= b) if op == Op.CMP_GE else (a == b)]
    if op == Op.SELECT:
        return [torch.where(v[0] != 0, v[1], v[2])]
    if op == Op.MINMAX:
        ge = unsigned_key(v[0], imm[2]) >= unsigned_key(v[1], imm[2])
        return [torch.where(ge, v[1], v[0]), torch.where(ge, v[0], v[1])]
    if op == Op.REVERSE:
        return [v[0].flip(-1)]
    if op == Op.SORT_LOCAL:
        desc = bool(imm[3]) if len(imm) > 3 else False
        key = unsigned_key(v[0], imm[2])
        return [v[0].gather(-1, stable_order(key, desc))]
    raise NotImplementedError(f"plaintext: {op.name}")


class PlaintextDriver(ProtocolDriver):
    """Executes the same bytecode in the clear (lane 1, int64 bit views):
    the correctness oracle and the cheap stand-in for real executions.

    The bytecode is wire-addressed (count*width slots a value); a plaintext
    value lives at its element's first wire slot (stride w), and only those
    slots are written, so the final engine memory equals the JAX package's
    ``gc-plaintext`` run bit for bit.  Values wider than 64 bits keep their
    low 64."""

    lane = 1
    dtype = torch.int64
    name = "gc-plaintext"

    def __init__(self, input_provider: InputProvider | None = None):
        self.input_provider = input_provider
        self.outputs: dict[int, np.ndarray] = {}

    def execute(self, op: Op, imm: tuple, outs, ins) -> None:
        m = value_mask
        if op in CLEAR_OPS:
            s_in, s_out = clear_strides(op, imm[1], len(ins))
            res = clear_elementwise(op, imm, [x[::s, 0]
                                              for x, s in zip(ins, s_in)])
            for o, r in zip(outs, res):
                o[::s_out, 0] = r
            return
        if op == Op.INPUT:
            n, w, party, tag = imm[0], imm[1], imm[2], imm[3]
            vals = np.asarray(self.input_provider(tag), dtype=np.uint64)
            outs[0][::w, 0] = to_device(vals.view(np.int64),
                                        outs[0].device) & m(w)
            return
        if op == Op.OUTPUT:
            w = imm[1]
            self.outputs[imm[2]] = (ins[0][::w, 0] & m(w)).cpu().numpy() \
                .view(np.uint64)
            return
        if op == Op.COPY:
            outs[0].copy_(ins[0])
            return
        if op == Op.PAIR_JOIN:
            na, nb, w, kw = imm
            a = ins[0][::w, 0].repeat_interleave(nb)
            b = ins[1][::w, 0].repeat(na)
            half = (w - kw) // 2
            packed = ((a & m(kw)) | shl(shr(a, kw) & m(half), kw)
                      | shl(shr(b, kw) & m(w - kw - half), kw + half)) & m(w)
            outs[0][::w, 0] = torch.where((a & m(kw)) == (b & m(kw)), packed,
                                          torch.zeros_like(a))
        elif op == Op.MAC8:
            nr, nj, acc_w = imm
            mat = (ins[0][::8, 0] & m(8)).reshape(nr, nj)
            prod = (mat * (ins[1][::8, 0] & m(8))[None, :]) & m(16)
            tot = prod.sum(dim=1) & m(acc_w)
            outs[0][::acc_w, 0] = (ins[2][::acc_w, 0] + tot) & m(acc_w)
        elif op == Op.XNOR_POP_SIGN:
            nr, nj = imm
            mat = (ins[0][:, 0] & 1).reshape(nr, nj)
            cnt = (1 - (mat ^ (ins[1][:, 0] & 1)[None, :])).sum(dim=1)
            outs[0][:, 0] = cnt >= (nj + 1) // 2
        elif op == Op.REDUCE_ADD:
            w = imm[1]
            outs[0][0, 0] = ins[0][::w, 0].sum() & m(w)
        else:
            raise NotImplementedError(f"plaintext driver: {op.name}")

