"""CKKS protocol driver for the port's engine (§7.4) + the Batch DSL: the
counterparts of ``repro.protocols.ckks.driver``'s ``CkksDriver``,
``Plain`` and ``Batch``.

The address space is word-addressed (one slot = 8 bytes, lane 1, int64);
a ciphertext at level l occupies ncomp*(l+1)*N slots, an encoded plaintext
(levels+1)*N.  Ciphertexts are flat buffers, so swapping them is a byte
copy.  The driver maps bytecode ops 1:1 onto ``cipher.py``, including the
paper's lazy relinearization (CT_MUL_NR + CT_ADD on 3-component
ciphertexts + one CT_RELIN).  ``CkksCostModel`` is the timing simulator's
per-instruction price (the JAX package's, value for value).
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Callable

import numpy as np
import torch

from ...core.bytecode import Instr, Op
from ...core.dsl import Value
from ...core.engine import ProtocolDriver
from .cipher import CkksContext
from .params import CkksParams

InputProvider = Callable[[int], np.ndarray]

#: the homomorphic operations (what "homomorphic ops per second" counts)
HOMOMORPHIC_OPS = frozenset({Op.CT_ADD, Op.CT_MUL, Op.CT_MUL_NR,
                             Op.CT_RELIN, Op.CT_ADD_PLAIN, Op.CT_MUL_PLAIN})


def homomorphic_ops(op_counts: dict[str, int]) -> int:
    """The homomorphic operations among instruction counts by op name."""
    names = {op.name for op in HOMOMORPHIC_OPS}
    return sum(k for name, k in op_counts.items() if name in names)


@dataclasses.dataclass
class CkksCostModel:
    """Per-op seconds from NTT counts (calibrated to single-core SEAL-era
    throughput: an N-point NTT ~ kappa*N*log2(N) seconds)."""
    kappa: float = 2.0e-9
    pointwise: float = 0.3e-9     # per-coefficient modmul epilogue
    instr_overhead_s: float = 2e-6

    def ntt_s(self, n: int) -> float:
        return self.kappa * n * math.log2(max(n, 2))

    def cost(self, instr: Instr, n_ring: int) -> float:
        op, imm = instr.op, instr.imm
        t = self.instr_overhead_s
        if op == Op.CT_ADD:
            lvl, nc = imm[0], max(imm[1], imm[2])
            t += nc * (lvl + 1) * n_ring * self.pointwise
        elif op in (Op.CT_MUL, Op.CT_MUL_NR, Op.CT_RELIN, Op.CT_MUL_PLAIN):
            lvl = imm[0]
            nprime = lvl + 1
            if op in (Op.CT_MUL, Op.CT_MUL_NR):
                ntts = 7 * nprime                      # 4 fwd + 3 inv
            else:
                ntts = 0
            if op in (Op.CT_MUL, Op.CT_RELIN):
                ntts += nprime * (nprime + 1) + 2 * (nprime + 1) + 2 * nprime
            if op == Op.CT_MUL_PLAIN:
                ntts += 2 * 2 * nprime + nprime
            t += ntts * self.ntt_s(n_ring)
            t += nprime * n_ring * 6 * self.pointwise
        elif op in (Op.CT_ADD_PLAIN,):
            lvl = imm[0]
            t += (lvl + 1) * n_ring * self.pointwise
        elif op in (Op.INPUT, Op.OUTPUT):
            t += 4 * self.ntt_s(n_ring)
        return t

    def cost_chunk(self, ops: np.ndarray, imm: np.ndarray,
                   n_ring: int) -> np.ndarray:
        """Vectorized :meth:`cost` over one record chunk.

        ``ops`` is int64 [m]; ``imm`` the zero-padded int64 immediate
        matrix (the NTT-count formulas only read the integer level/
        component immediates).  Per-instruction results are IDENTICAL to
        the scalar path: every count stays exact int64 and the float
        operations replay ``cost``'s order (overhead, then NTTs, then the
        pointwise epilogue)."""
        ops = np.asarray(ops, dtype=np.int64)
        imm = np.asarray(imm, dtype=np.int64)
        t = np.full(ops.shape[0], self.instr_overhead_s, dtype=np.float64)
        ntt = self.ntt_s(n_ring)
        lvl = imm[:, 0]

        mk = ops == int(Op.CT_ADD)
        if mk.any():
            nc = np.maximum(imm[mk, 1], imm[mk, 2])
            t[mk] += (nc * (lvl[mk] + 1) * n_ring).astype(np.float64) \
                * self.pointwise
        is_mul = (ops == int(Op.CT_MUL)) | (ops == int(Op.CT_MUL_NR))
        mk = is_mul | (ops == int(Op.CT_RELIN)) | (ops == int(Op.CT_MUL_PLAIN))
        if mk.any():
            nprime = lvl[mk] + 1
            ntts = np.where(is_mul[mk], 7 * nprime, 0)
            relin = is_mul[mk] & (ops[mk] == int(Op.CT_MUL))
            relin |= ops[mk] == int(Op.CT_RELIN)
            ntts = ntts + np.where(
                relin, nprime * (nprime + 1) + 2 * (nprime + 1) + 2 * nprime,
                0)
            ntts = ntts + np.where(ops[mk] == int(Op.CT_MUL_PLAIN),
                                   2 * 2 * nprime + nprime, 0)
            t[mk] += ntts.astype(np.float64) * ntt
            t[mk] += (nprime * n_ring * 6).astype(np.float64) * self.pointwise
        mk = ops == int(Op.CT_ADD_PLAIN)
        if mk.any():
            t[mk] += ((lvl[mk] + 1) * n_ring).astype(np.float64) \
                * self.pointwise
        mk = (ops == int(Op.INPUT)) | (ops == int(Op.OUTPUT))
        if mk.any():
            t[mk] += 4 * ntt
        return t


class CkksDriver(ProtocolDriver):
    lane = 1
    dtype = torch.int64
    name = "ckks"

    def __init__(self, params: CkksParams,
                 input_provider: InputProvider | None = None,
                 seed: int = 0xCEC5,
                 device: str | torch.device | None = None):
        self.p = params
        self.ctx = CkksContext(params, seed=seed, device=device)
        self.input_provider = input_provider
        self.outputs: dict[int, np.ndarray] = {}
        #: instructions executed, by opcode (batched ones included)
        self.op_counts: Counter = Counter()

    # -- layout helpers -------------------------------------------------------

    def _ct(self, view: torch.Tensor, level: int,
            ncomp: int = 2) -> torch.Tensor:
        return view.reshape(ncomp, level + 1, self.p.n_ring)

    def _pt(self, view: torch.Tensor) -> torch.Tensor:
        return view.reshape(self.p.levels + 1, self.p.n_ring)

    def execute(self, op: Op, imm: tuple, outs, ins) -> None:
        ctx = self.ctx
        self.op_counts[op] += 1
        if op == Op.INPUT:
            tag, kind = imm[0], imm[1]
            z = np.asarray(self.input_provider(tag), dtype=np.float64)
            pt = ctx.encode(z)
            r = pt if kind == 1 else ctx.encrypt(pt)
        elif op == Op.OUTPUT:
            tag, level, ncomp, scale = imm[0], imm[1], imm[2], imm[3]
            ct = self._ct(ins[0], level, ncomp)
            z = ctx.decode(ctx.decrypt(ct, level), level, scale)
            self.outputs[tag] = z.real
            return
        elif op == Op.COPY:
            r = ins[0]
        elif op == Op.CT_ADD:
            level, nc1, nc2 = imm[0], imm[1], imm[2]
            sub = bool(imm[3]) if len(imm) > 3 else False
            fn = ctx.sub if sub else ctx.add
            r = fn(self._ct(ins[0], level, nc1),
                   self._ct(ins[1], level, nc2), level)
        elif op == Op.CT_MUL:
            level = imm[0]
            r = ctx.mul(self._ct(ins[0], level), self._ct(ins[1], level),
                        level)
        elif op == Op.CT_MUL_NR:
            level = imm[0]
            r = ctx.mul_tensor(self._ct(ins[0], level),
                               self._ct(ins[1], level), level)
        elif op == Op.CT_RELIN:
            level = imm[0]
            r = ctx.rescale(ctx.relinearize(self._ct(ins[0], level, 3),
                                            level), level)
        elif op == Op.CT_MUL_PLAIN:
            level = imm[0]
            r = ctx.mul_plain(self._ct(ins[0], level), self._pt(ins[1]),
                              level)
        elif op == Op.CT_ADD_PLAIN:
            level = imm[0]
            r = ctx.add_plain(self._ct(ins[0], level), self._pt(ins[1]),
                              level)
        else:
            raise NotImplementedError(f"ckks driver: {op}")
        outs[0].copy_(r.reshape(outs[0].shape))


# ---------------------------------------------------------------------------
# Batch DSL (§7.4: "Batches" + Add-Multiply engine)
# ---------------------------------------------------------------------------


class Plain(Value):
    """An encoded plaintext vector (usable at any level)."""

    __slots__ = ("params",)

    def __init__(self, params: CkksParams, builder=None):
        super().__init__(params.pt_slots(), builder)
        self.params = params

    def mark_input(self, tag: int) -> "Plain":
        self.builder.emit(Op.INPUT, outs=(self.span,), imm=(tag, 1))
        return self


class Batch(Value):
    """One CKKS ciphertext: a vector of N/2 encrypted reals."""

    __slots__ = ("params", "level", "ncomp", "scale")

    def __init__(self, params: CkksParams, level: int | None = None,
                 ncomp: int = 2, scale: float | None = None, builder=None):
        level = params.levels if level is None else level
        super().__init__(params.ct_slots(level, ncomp), builder)
        self.params = params
        self.level = level
        self.ncomp = ncomp
        self.scale = params.scale if scale is None else scale

    def mark_input(self, tag: int) -> "Batch":
        assert self.level == self.params.levels and self.ncomp == 2
        self.builder.emit(Op.INPUT, outs=(self.span,), imm=(tag, 0))
        return self

    def mark_output(self, tag: int) -> None:
        self.builder.emit(Op.OUTPUT, ins=(self.span,),
                          imm=(tag, self.level, self.ncomp, self.scale))

    # -- ops ------------------------------------------------------------------

    def __add__(self, o: "Batch") -> "Batch":
        assert self.level == o.level, "CKKS add: level mismatch"
        r = Batch(self.params, self.level, max(self.ncomp, o.ncomp),
                  max(self.scale, o.scale), self.builder)
        self.builder.emit(Op.CT_ADD, outs=(r.span,),
                          ins=(self.span, o.span),
                          imm=(self.level, self.ncomp, o.ncomp, 0))
        return r

    def __sub__(self, o: "Batch") -> "Batch":
        assert self.level == o.level, "CKKS sub: level mismatch"
        r = Batch(self.params, self.level, max(self.ncomp, o.ncomp),
                  max(self.scale, o.scale), self.builder)
        self.builder.emit(Op.CT_ADD, outs=(r.span,),
                          ins=(self.span, o.span),
                          imm=(self.level, self.ncomp, o.ncomp, 1))
        return r

    def __mul__(self, o: "Batch") -> "Batch":
        assert self.level == o.level and self.level >= 1, \
            f"CKKS mul needs level>=1 (have {self.level})"
        assert self.ncomp == 2 and o.ncomp == 2
        drop = self.params.level_primes(self.level)[-1]
        r = Batch(self.params, self.level - 1, 2,
                  self.scale * o.scale / drop, self.builder)
        self.builder.emit(Op.CT_MUL, outs=(r.span,),
                          ins=(self.span, o.span), imm=(self.level,))
        return r

    def mul_norelin(self, o: "Batch") -> "Batch":
        """Tensor product without relinearization (lazy-relin sums)."""
        assert self.level == o.level and self.ncomp == 2 and o.ncomp == 2
        r = Batch(self.params, self.level, 3, self.scale * o.scale,
                  self.builder)
        self.builder.emit(Op.CT_MUL_NR, outs=(r.span,),
                          ins=(self.span, o.span), imm=(self.level,))
        return r

    def relin(self) -> "Batch":
        assert self.ncomp == 3 and self.level >= 1
        drop = self.params.level_primes(self.level)[-1]
        r = Batch(self.params, self.level - 1, 2, self.scale / drop,
                  self.builder)
        self.builder.emit(Op.CT_RELIN, outs=(r.span,), ins=(self.span,),
                          imm=(self.level,))
        return r

    def mul_plain(self, pt: Plain) -> "Batch":
        assert self.level >= 1 and self.ncomp == 2
        drop = self.params.level_primes(self.level)[-1]
        r = Batch(self.params, self.level - 1, 2,
                  self.scale * self.params.scale / drop, self.builder)
        self.builder.emit(Op.CT_MUL_PLAIN, outs=(r.span,),
                          ins=(self.span, pt.span), imm=(self.level,))
        return r

    def add_plain(self, pt: Plain) -> "Batch":
        r = Batch(self.params, self.level, self.ncomp, self.scale,
                  self.builder)
        self.builder.emit(Op.CT_ADD_PLAIN, outs=(r.span,),
                          ins=(self.span, pt.span), imm=(self.level,))
        return r
