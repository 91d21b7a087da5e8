"""The n-party Shamir secret-sharing protocol driver (the port's copy of
``repro.protocols.shamir.driver``).

One :class:`ShamirDriver` runs per *worker* engine: the n Shamir parties
are deployed as the n workers of a single registry party
(``driver_parties("shamir") == 1``), so every resharing round of the
degree-reduction multiplication appears in the traced bytecode as
``F_EVAL`` + ``NET_SEND``/``NET_RECV`` + a recombine chain riding the
same worker links as worker-parallel GC: the planner and the overlap
loop see (and can hide) each round.

Execution is passive-secure *in structure* (round pattern, message
sizes, per-party share state); input dealing and resharing randomness
are derived from PRFs keyed only by trace-time constants (tag / round
id), so all n engines deal consistent shares with no extra dealer round,
and the scalar, batched and overlap loops, which execute the same
instructions in different orders, draw bit-identical coefficients.

Shares live in the engine's memory on its device (lane 1, int64 words
holding the JAX package's uint64 bits); the field ops run there as
PyTorch tensor ops.  The PRF's coefficients are drawn on the host and
uploaded; an input vector and a revealed output cross the same way.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...core.bytecode import Instr, Op
from ...core.engine import ProtocolDriver
from ...kernels import to_device
from .field import (P, addmod, as_tensor, eval_point, fold, mulmod,
                    mulmod_scalar, prf_coeffs, submod, to_numpy)

InputProvider = Callable[[int], np.ndarray]

#: default PRF keys: input-poly dealing / resharing polynomials
SEED_INPUT = 0x511A3170
SEED_RESHARE = 0x5ECE7B17


class ShamirDriver(ProtocolDriver):
    """Share-local field ops + deterministic share dealing for one party.

    ``threshold`` defaults to the largest t with 2t + 1 <= n_parties, the
    degree-reduction requirement of the one-round multiplication.
    """

    lane = 1
    dtype = torch.int64
    name = "shamir"

    def __init__(self, n_parties: int, party: int,
                 input_provider: InputProvider,
                 threshold: int | None = None,
                 seed_input: int = SEED_INPUT,
                 seed_reshare: int = SEED_RESHARE):
        if n_parties < 3:
            raise ValueError(f"shamir needs n >= 3 parties, got {n_parties}")
        if not 0 <= party < n_parties:
            raise ValueError(f"party {party} out of range for n={n_parties}")
        t = (n_parties - 1) // 2 if threshold is None else threshold
        if not 1 <= t or 2 * t + 1 > n_parties:
            raise ValueError(f"threshold t={t} needs 2t+1 <= n={n_parties}")
        self.n_parties = n_parties
        self.party = party
        self.threshold = t
        self.provider = input_provider
        self.seed_input = seed_input
        # fold the party id into the resharing key: each party's resharing
        # polynomial for round rid must be private to (derived only by) it
        self.seed_reshare = seed_reshare ^ (party + 1) * 0x9E3779B9
        self.outputs: dict[int, np.ndarray] = {}

    # -- polynomial helpers -------------------------------------------------

    def _poly_eval(self, const: torch.Tensor, key: int, which: int,
                   t: int, at_party: int) -> torch.Tensor:
        """const + sum_k c_k * alpha^k with c_k = PRF(key, which, k)."""
        count = const.shape[0]
        a = eval_point(at_party)
        acc = torch.zeros_like(const)
        for k in range(t, 0, -1):                   # Horner, highest first
            c = to_device(prf_coeffs(key, which, k, count).view(np.int64),
                          const.device)
            acc = addmod(mulmod_scalar(acc, a), c)
        return addmod(mulmod_scalar(acc, a), const)

    # -- ProtocolDriver -----------------------------------------------------

    def execute(self, op: Op, imm: tuple, outs, ins) -> None:
        if op == Op.F_ADD:
            r = addmod(ins[0][:, 0], ins[1][:, 0])
        elif op == Op.F_SUB:
            r = submod(ins[0][:, 0], ins[1][:, 0])
        elif op == Op.F_MUL_LOCAL:
            r = mulmod(ins[0][:, 0], ins[1][:, 0])
        elif op == Op.F_MULC:
            r = mulmod_scalar(ins[0][:, 0], imm[1])
        elif op == Op.F_ADDC:
            r = addmod(ins[0][:, 0], imm[1] % P)
        elif op == Op.F_MULC_ADD:
            r = addmod(ins[0][:, 0], mulmod_scalar(ins[1][:, 0], imm[1]))
        elif op == Op.F_EVAL:
            _, j, t, rid = imm
            r = self._poly_eval(ins[0][:, 0], self.seed_reshare, rid, t, j)
        elif op == Op.INPUT:
            _, tag = imm
            x = fold(as_tensor(self.provider(tag))).to(outs[0].device)
            r = self._poly_eval(x, self.seed_input, tag, self.threshold,
                                self.party)
        elif op == Op.OUTPUT:
            # the reveal chain already interpolated at 0: ins[0] is plain
            self.outputs[imm[1]] = to_numpy(ins[0][:, 0]).copy()
            return
        elif op == Op.COPY:
            outs[0].copy_(ins[0])
            return
        else:
            raise NotImplementedError(f"shamir driver cannot run {op!r}")
        outs[0][:, 0] = r

    def cost(self, instr: Instr) -> float:
        n = instr.outs[0][1] if instr.outs else \
            (instr.ins[0][1] if instr.ins else 1)
        if instr.op in (Op.F_MUL_LOCAL, Op.F_EVAL, Op.INPUT):
            return 30e-9 * n
        return 6e-9 * n
