"""Analytic gate counts + timing/bandwidth model for garbled circuits: the
port's copy of ``repro.protocols.garbled.cost``, host code on NumPy.

``gate_cost(op, imm)`` mirrors the subcircuits in engineops.py exactly (a
test holds formula == the gates' AND counters for every op), so the timing
simulator can price paper-scale traces without executing cryptography.
Every per-instruction value, from ``cost`` and from ``cost_chunk``, equals
the JAX package's bit for bit.

Timing constants are calibrated to the paper's era (fixed-key AES-NI
garbling, §8: ~10-20M AND gates/s on a D16d_v4 core): garbling an AND
costs 4 AES calls + a 32 B table write, evaluation 2 AES calls.  They are
the model's constants, not times taken on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core.bytecode import DIRECTIVES, Instr, Op


def _adder_ands(w: int, want_carry: bool = False) -> int:
    return w if want_carry else w - 1


def _tree_widen_ands(n: int, w0: int, cap: int) -> int:
    """ANDs for a pairwise reduction tree over n values of width w0 where
    each level widens by one bit up to ``cap`` (matches dot8/popcount)."""
    total = 0
    vals = n
    w = w0
    while vals > 1:
        w = min(w + 1, cap)
        pairs = vals // 2
        total += pairs * _adder_ands(w)
        vals = pairs + (vals % 2)
    return total


def _mul_widening_ands(w: int) -> int:
    # per element: w partial-product rows of w ANDs + a (w-1)-adder tree
    # at full 2w width (shifted+zero-extended rows)
    return w * w + (w - 1) * _adder_ands(2 * w)


def _bitonic_sort_ce(n: int) -> int:
    """compare-exchanges in a bitonic sort of n lanes."""
    total = 0
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            total += n // 2
            j //= 2
        k *= 2
    return total


def _bitonic_merge_ce(n: int) -> int:
    total = 0
    j = n // 2
    while j >= 1:
        total += n // 2
        j //= 2
    return total


def gate_cost(op: Op, imm: tuple) -> tuple[int, int]:
    """Returns (AND gates, const wires) for one instruction.  XORs are free
    and not modeled for time (they are ~50x cheaper than ANDs)."""
    if op in (Op.XOR, Op.AND, Op.OR, Op.NOT):
        n, w = imm[0], imm[1]
        if op == Op.AND:
            return n * w, 0
        if op == Op.OR:
            return n * w, 0
        return 0, 0
    if op in (Op.ADD,):
        n, w = imm[0], imm[1]
        return n * _adder_ands(w), 0
    if op == Op.SUB:
        n, w = imm[0], imm[1]
        return n * _adder_ands(w), n
    if op == Op.MUL:
        n, w = imm[0], imm[1]
        # truncated school multiplier
        ands = sum(w - i for i in range(w))            # partial products
        ands += sum(_adder_ands(w - i) for i in range(1, w))
        return n * ands, 0
    if op == Op.CMP_GE:
        n, w, kw = imm[0], imm[1], imm[2]
        return n * kw, n
    if op == Op.CMP_EQ:
        n, w, kw = imm[0], imm[1], imm[2]
        return n * (kw - 1), 0         # xnor is free; AND tree costs kw-1
    if op == Op.SELECT:
        n, w = imm[0], imm[1]
        return n * w, 0
    if op == Op.MINMAX:
        n, w, kw = imm[0], imm[1], imm[2]
        return n * (kw + 2 * w), n
    if op == Op.SORT_LOCAL:
        n, w, kw = imm[0], imm[1], imm[2]
        merge_only = bool(imm[4]) if len(imm) > 4 else False
        ce = _bitonic_merge_ce(n) if merge_only else _bitonic_sort_ce(n)
        return ce * (kw + 2 * w), ce
    if op == Op.REVERSE:
        return 0, 0
    if op == Op.PAIR_JOIN:
        na, nb, w, kw = imm[0], imm[1], imm[2], imm[3]
        m = na * nb
        return m * ((kw - 1) + w), m
    if op == Op.MAC8:
        nr, nj, acc_w = imm[0], imm[1], imm[2]
        ands = nr * nj * _mul_widening_ands(8)
        ands += nr * _tree_widen_ands(nj, 16, acc_w)
        ands += nr * _adder_ands(acc_w)               # final acc add
        return ands, nr * nj                          # const zero per product
    if op == Op.XNOR_POP_SIGN:
        nr, nj = imm[0], imm[1]
        ands = nr * _tree_widen_ands(nj, 1, 64)
        wc = _final_tree_width(nj, 1, 64)
        ands += nr * wc                                # cmp_ge vs constant
        return ands, nr * (wc + _tree_consts(nj))
    if op == Op.REDUCE_ADD:
        n, w = imm[0], imm[1]
        return (n - 1) * _adder_ands(w), 0
    if op in (Op.INPUT, Op.OUTPUT, Op.COPY, Op.REVERSE):
        return 0, 0
    if op in (Op.NET_SEND, Op.NET_RECV, Op.NET_BARRIER) or op in DIRECTIVES:
        return 0, 0
    raise NotImplementedError(f"gate_cost: {op}")


def _final_tree_width(n: int, w0: int, cap: int) -> int:
    w = w0
    vals = n
    while vals > 1:
        w = min(w + 1, cap)
        vals = vals // 2 + (vals % 2)
    return w


def _tree_consts(n: int) -> int:
    """zero-extension const wires per row in the widening tree (upper bound
    folded into the timing model only; exact count asserted in tests via the
    batcher counters, not this helper)."""
    return 0


# ---------------------------------------------------------------------------
# Chunked (vectorized) gate-cost math.
#
# ``gate_cost_chunk`` prices a whole record chunk at once: every formula
# above restated over int64 arrays, with the log-depth helpers
# (_tree_widen_ands, _final_tree_width, the bitonic CE counts) run as
# masked vector loops of at most log2(max lane count) iterations.  All
# intermediate counts are exact int64, so per-instruction results are
# IDENTICAL to the scalar ``gate_cost`` — the contract the array-core
# timing simulators rely on (property-tested in tests/test_array_sim.py).
# ---------------------------------------------------------------------------


def _floor_log2(n: np.ndarray) -> np.ndarray:
    """Exact floor(log2(n)) for positive int64 n (frexp exponent - 1)."""
    return np.frexp(n.astype(np.float64))[1].astype(np.int64) - 1


def _bitonic_sort_ce_vec(n: np.ndarray) -> np.ndarray:
    lg = np.where(n >= 2, _floor_log2(np.maximum(n, 1)), 0)
    return np.where(n >= 2, (n // 2) * (lg * (lg + 1) // 2), 0)


def _bitonic_merge_ce_vec(n: np.ndarray) -> np.ndarray:
    half = n // 2
    lg = np.where(half >= 1, _floor_log2(np.maximum(half, 1)) + 1, 0)
    return half * lg


def _tree_widen_vec(n: np.ndarray, w0: np.ndarray, cap: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized tree walk: (total widening-adder ANDs, final width)."""
    total = np.zeros_like(n)
    vals = n.copy()
    w = np.broadcast_to(w0, n.shape).copy()
    cap = np.broadcast_to(cap, n.shape)
    while True:
        m = vals > 1
        if not m.any():
            break
        w[m] = np.minimum(w[m] + 1, cap[m])
        pairs = vals[m] // 2
        total[m] += pairs * _adder_ands_vec(w[m])
        vals[m] = pairs + vals[m] % 2
    return total, w


def _adder_ands_vec(w: np.ndarray) -> np.ndarray:
    return w - 1


def gate_cost_chunk(ops: np.ndarray, imm: np.ndarray,
                    n_imm: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`gate_cost` over one chunk.

    ``ops`` is int64 [m]; ``imm`` the zero-padded [m, >=MAX_IMM] immediate
    matrix of a record chunk (raw int64 words — GC cost formulas only read
    integer immediates).  ``n_imm`` (optional, from the record heads)
    resolves SORT_LOCAL's ``len(imm) > 4`` merge flag exactly; with the
    zero-padded matrix the default is equivalent.  FREE rows (which the
    simulators never price) cost (0, 0).  Returns exact int64
    (AND gates, const wires) per instruction; raises NotImplementedError
    on ops the scalar formula would also reject.
    """
    ops = np.asarray(ops, dtype=np.int64)
    imm = np.asarray(imm, dtype=np.int64)
    m = ops.shape[0]
    ands = np.zeros(m, dtype=np.int64)
    consts = np.zeros(m, dtype=np.int64)
    handled = np.zeros(m, dtype=bool)

    def sel(*which: Op) -> np.ndarray:
        mk = np.zeros(m, dtype=bool)
        for o in which:
            mk |= ops == int(o)
        handled[mk] = True
        return mk

    c0, c1, c2, c3 = imm[:, 0], imm[:, 1], imm[:, 2], imm[:, 3]

    mk = sel(Op.AND, Op.OR, Op.SELECT)
    ands[mk] = c0[mk] * c1[mk]
    sel(Op.XOR, Op.NOT, Op.REVERSE, Op.COPY, Op.INPUT, Op.OUTPUT, Op.FREE)

    mk = sel(Op.ADD)
    ands[mk] = c0[mk] * (c1[mk] - 1)
    mk = sel(Op.SUB)
    ands[mk] = c0[mk] * (c1[mk] - 1)
    consts[mk] = c0[mk]
    mk = sel(Op.MUL)
    if mk.any():
        w = c1[mk]
        # partial products w(w+1)/2 plus the truncated adder chain
        ands[mk] = c0[mk] * (w * (w + 1) // 2 + (w - 1) * (w - 2) // 2)
    mk = sel(Op.CMP_GE)
    ands[mk] = c0[mk] * c2[mk]
    consts[mk] = c0[mk]
    mk = sel(Op.CMP_EQ)
    ands[mk] = c0[mk] * (c2[mk] - 1)
    mk = sel(Op.MINMAX)
    ands[mk] = c0[mk] * (c2[mk] + 2 * c1[mk])
    consts[mk] = c0[mk]
    mk = sel(Op.SORT_LOCAL)
    if mk.any():
        merge = (imm[:, 4][mk] != 0) if imm.shape[1] > 4 \
            else np.zeros(int(mk.sum()), dtype=bool)
        if n_imm is not None:
            merge &= np.asarray(n_imm, dtype=np.int64)[mk] > 4
        ce = np.where(merge, _bitonic_merge_ce_vec(c0[mk]),
                      _bitonic_sort_ce_vec(c0[mk]))
        ands[mk] = ce * (c2[mk] + 2 * c1[mk])
        consts[mk] = ce
    mk = sel(Op.PAIR_JOIN)
    pairs = c0[mk] * c1[mk]
    ands[mk] = pairs * ((c3[mk] - 1) + c2[mk])
    consts[mk] = pairs
    mk = sel(Op.MAC8)
    if mk.any():
        nr, nj, acc_w = c0[mk], c1[mk], c2[mk]
        tree, _ = _tree_widen_vec(nj, np.int64(16), acc_w)
        ands[mk] = nr * nj * _mul_widening_ands(8) + nr * tree \
            + nr * _adder_ands_vec(acc_w)
        consts[mk] = nr * nj
    mk = sel(Op.XNOR_POP_SIGN)
    if mk.any():
        nr, nj = c0[mk], c1[mk]
        tree, wc = _tree_widen_vec(nj, np.int64(1), np.int64(64))
        ands[mk] = nr * tree + nr * wc
        consts[mk] = nr * (wc + _tree_consts(nj))
    mk = sel(Op.REDUCE_ADD)
    ands[mk] = (c0[mk] - 1) * (c1[mk] - 1)
    sel(Op.NET_SEND, Op.NET_RECV, Op.NET_BARRIER, *DIRECTIVES)

    if not handled.all():
        bad = int(ops[~handled][0])
        raise NotImplementedError(f"gate_cost_chunk: op {bad}")
    return ands, consts


@dataclasses.dataclass
class GCCostModel:
    """Seconds/bytes per gate for the timing simulator."""
    and_s: float = 80e-9          # garble an AND (4 fixed-key AES + table)
    and_eval_s: float = 40e-9     # evaluate an AND (2 AES)
    xor_s: float = 2e-9
    instr_overhead_s: float = 2e-7
    table_bytes: int = 32         # 2 ciphertexts per AND (half gates)
    label_bytes: int = 16
    role: str = "garbler"

    def cost(self, instr: Instr) -> float:
        ands, consts = gate_cost(instr.op, instr.imm)
        per = self.and_s if self.role == "garbler" else self.and_eval_s
        return self.instr_overhead_s + ands * per

    def bytes_of(self, instr: Instr) -> int:
        ands, consts = gate_cost(instr.op, instr.imm)
        return ands * self.table_bytes + consts * self.label_bytes

    # -- chunk-level API (per-element identical to cost()/bytes_of()) --------

    def cost_chunk(self, ops: np.ndarray, imm: np.ndarray,
                   n_imm: np.ndarray | None = None) -> np.ndarray:
        """Per-instruction seconds for a record chunk (float64 [m])."""
        ands, _ = gate_cost_chunk(ops, imm, n_imm)
        per = self.and_s if self.role == "garbler" else self.and_eval_s
        return self.instr_overhead_s + ands.astype(np.float64) * per

    def bytes_chunk(self, ops: np.ndarray, imm: np.ndarray,
                    n_imm: np.ndarray | None = None) -> np.ndarray:
        """Per-instruction GC table traffic for a record chunk (int64)."""
        ands, consts = gate_cost_chunk(ops, imm, n_imm)
        return ands * self.table_bytes + consts * self.label_bytes
