"""Shamir tracing DSL: secret-shared field vectors with explicit rounds
(the port's copy of ``repro.protocols.shamir.dsl``; tracing is host code
and emits the JAX package's bytecode instruction for instruction).

A :class:`Shared` is one <=page span of 8-byte slots holding THIS
worker's share of a secret vector.  Linear operators (``+``, ``-``,
constant-mul) emit one share-local ``F_*`` instruction; :func:`mul`
emits a full VIFF-style degree-reduction round —

    F_MUL_LOCAL                     h = x * y           (degree 2t)
    F_EVAL x n                      subshares q_w(alpha_j), j = 0..n-1
    NET_SEND x (n-1)                subshare j -> party j
    NET_RECV x (n-1)                subshare from party i, i != w
    F_MULC + F_MULC_ADD x (n-1)     z = sum_i lambda_i * s_i  (degree t)

— so every resharing round is visible to the planner and to the overlap
pass as ordinary NET_* directives inside one barrier-free window.  Round
ids (``rid``) and tags are assigned by a deterministic per-builder
counter; all workers trace the same program shape, so sender and
receiver agree on tags without coordination.

Every Shared is pinned on the builder until the trace closes
(``_live``): shamir traces emit no mid-stream FREEs, allocations are
strictly sequential pages, and the vectorized ``fast_trace`` record
builders in ``workloads.shamir_workloads`` can replay the layout
in closed form (digest-identical, tested).
"""

from __future__ import annotations

from ...core.bytecode import Op
from ...core.dsl import Builder, Value, current_builder
from .field import P, inverse, lagrange_at_zero  # noqa: F401  (re-export)

#: tag bases: one tag per resharing round (+rid) and per revealed output
#: (+out index); disjoint from the builder's fresh_tag() counter space.
ROUND_TAG = 1 << 16
REVEAL_TAG = 1 << 28


def _ctx(b: Builder) -> tuple[int, int, int]:
    """(n_parties, this party, threshold) of the active trace."""
    n = b.num_workers
    if n < 3:
        raise ValueError(f"shamir traces need num_workers >= 3, got {n}")
    return n, b.worker, (n - 1) // 2


def _next_rid(b: Builder) -> int:
    rid = getattr(b, "_shamir_rid", 0)
    b._shamir_rid = rid + 1
    return rid


class Shared(Value):
    """One worker's share of a ``count``-lane secret vector in GF(p)."""

    __slots__ = ("count",)

    def __init__(self, count: int, builder: Builder | None = None):
        super().__init__(count, builder)
        self.count = count
        # pin until finish(): no mid-trace FREEs, sequential page layout
        live = getattr(self.builder, "_shamir_live", None)
        if live is None:
            live = self.builder._shamir_live = []
        live.append(self)

    @classmethod
    def mark_input(cls, count: int, tag: int,
                   builder: Builder | None = None) -> "Shared":
        v = cls(count, builder)
        v.builder.emit(Op.INPUT, outs=(v.span,), imm=(count, tag))
        return v

    def mark_output(self, tag: int) -> None:
        self.builder.emit(Op.OUTPUT, ins=(self.span,), imm=(self.count, tag))

    # -- linear (share-local) ops ------------------------------------------

    def _bin(self, op: Op, other: "Shared") -> "Shared":
        z = Shared(self.count, self.builder)
        self.builder.emit(op, outs=(z.span,), ins=(self.span, other.span),
                          imm=(self.count,))
        return z

    def __add__(self, other: "Shared") -> "Shared":
        return self._bin(Op.F_ADD, other)

    def __sub__(self, other: "Shared") -> "Shared":
        return self._bin(Op.F_SUB, other)

    def mulc(self, c: int) -> "Shared":
        z = Shared(self.count, self.builder)
        self.builder.emit(Op.F_MULC, outs=(z.span,), ins=(self.span,),
                          imm=(self.count, c % P))
        return z

    def addc(self, c: int) -> "Shared":
        z = Shared(self.count, self.builder)
        self.builder.emit(Op.F_ADDC, outs=(z.span,), ins=(self.span,),
                          imm=(self.count, c % P))
        return z

    def mulc_add(self, other: "Shared", c: int) -> "Shared":
        """self + c * other — the Lagrange-recombine chain step."""
        z = Shared(self.count, self.builder)
        self.builder.emit(Op.F_MULC_ADD, outs=(z.span,),
                          ins=(self.span, other.span),
                          imm=(self.count, c % P))
        return z

    def __mul__(self, other: "Shared") -> "Shared":
        return mul(self, other)


def _recombine(sub_shares: list[Shared], lam: tuple[int, ...]) -> Shared:
    acc = sub_shares[0].mulc(lam[0])
    for i in range(1, len(sub_shares)):
        acc = acc.mulc_add(sub_shares[i], lam[i])
    return acc


def mul(x: Shared, y: Shared) -> Shared:
    """Secret multiply with one degree-reduction resharing round."""
    b = x.builder
    n, w, t = _ctx(b)
    count = x.count
    rid = _next_rid(b)
    h = x._bin(Op.F_MUL_LOCAL, y)
    evals = []
    for j in range(n):
        e = Shared(count, b)
        b.emit(Op.F_EVAL, outs=(e.span,), ins=(h.span,),
               imm=(count, j, t, rid))
        evals.append(e)
    for j in range(n):
        if j != w:
            b.emit(Op.NET_SEND, ins=(evals[j].span,),
                   imm=(j, ROUND_TAG + rid))
    sub_shares: list[Shared] = []
    for i in range(n):
        if i == w:
            sub_shares.append(evals[w])
        else:
            r = Shared(count, b)
            b.emit(Op.NET_RECV, outs=(r.span,), imm=(i, ROUND_TAG + rid))
            sub_shares.append(r)
    return _recombine(sub_shares, lagrange_at_zero(n))


def reveal(x: Shared, out_index: int, out_tag: int) -> None:
    """Open ``x`` toward worker 0, which interpolates and emits OUTPUT.

    Workers != 0 send their share (one NET_SEND, no output); worker 0
    collects all n shares and recombines at 0 with the public Lagrange
    weights, so the plaintext OUTPUT exists on exactly one rank — the
    single-process run and the n-process fleet merge identically.
    """
    b = x.builder
    n, w, _ = _ctx(b)
    if w != 0:
        b.emit(Op.NET_SEND, ins=(x.span,), imm=(0, REVEAL_TAG + out_index))
        return
    shares = [x]
    for j in range(1, n):
        r = Shared(x.count, b)
        b.emit(Op.NET_RECV, outs=(r.span,), imm=(j, REVEAL_TAG + out_index))
        shares.append(r)
    _recombine(shares, lagrange_at_zero(n)).mark_output(out_tag)


def share_input(count: int, tag: int) -> Shared:
    """Obtain this worker's share of input vector ``tag`` (PRF-dealt)."""
    return Shared.mark_input(count, tag, current_builder())
