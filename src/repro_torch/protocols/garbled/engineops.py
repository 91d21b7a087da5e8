"""The AND-XOR *engine* (§4.2/§4.3) on PyTorch: expands each bytecode
instruction into a subcircuit of AND/XOR gates at run time.  The port's
counterpart of ``repro.protocols.garbled.engineops``.

The same code drives both parties (it only talks to the ``Gates``
interface), which keeps the two interpreters in lockstep on the table
stream.  Values are label tensors shaped (n, w, 2): n vector elements of w
bits, bit 0 the LSB.  Wire shuffles (shifts, broadcasts, bit packing) are
free: tensor reindexing.

Subcircuits follow the classic constructions (§7.3, after Obliv-C):
ripple-carry add/sub (w-1 ANDs), comparison via the borrow chain (w ANDs),
mux (w ANDs), the school multiplier (~w^2 ANDs), bitonic compare-exchange
networks for sort/merge, and the loop-join, 8-bit MAC and binary-FC cells.

Every AND call, its size and its order are those of the JAX package, and
so is every constant drawn from the garbler (``const_bits``), so the gate
ids, the labels and the table messages are identical.  The work around the
ANDs is cut to few tensor operations, since each costs the host several µs
on a card: XORs over whole values where the bits come out the same.  The half-gates
wrappers take contiguous (m, 2) operands: a value is transposed once to
(w, n, 2), or two to (w, 2, n, 2), so that each bit's labels are a
contiguous view.
"""

from __future__ import annotations

import numpy as np
import torch

from .gates import Gates


def _bits(a: torch.Tensor) -> torch.Tensor:
    """(n, w, 2) -> (w, n, 2), contiguous: bit i's labels are ``[i]``."""
    return a.transpose(0, 1).contiguous()


def _pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, w, 2) twice -> (w, 2, n, 2), contiguous: bit i's two operands
    side by side, so one XOR with a carry prepares both AND inputs."""
    return torch.stack([a, b]).permute(2, 0, 1, 3).contiguous()


def _zeros(n: int) -> np.ndarray:
    return np.zeros(n, dtype=np.uint8)


class AndXorOps:
    def __init__(self, gb: Gates):
        self.gb = gb

    # -- arithmetic -----------------------------------------------------------

    def add(self, a: torch.Tensor, b: torch.Tensor,
            cin: torch.Tensor | None = None, want_carry: bool = False):
        """Ripple-carry a + b over w bits; the carry out of the top bit is
        computed only with ``want_carry`` (then returns (sum, carry))."""
        gb = self.gb
        n, w, _ = a.shape
        steps = w if want_carry else w - 1
        first = 0 if cin is not None else 1      # bit 0 has no carry in
        ab = _pairs(a, b) if steps > first else None
        carries = [cin]      # the carry into each bit (None: none yet)
        c = cin
        for i in range(steps):
            if c is None:
                c = gb.and_(a[:, i].contiguous(), b[:, i].contiguous())
            else:
                x = gb.xor(ab[i], c)              # (a_i ^ c, b_i ^ c)
                c = gb.xor(gb.and_(x[0], x[1]), c)
            carries.append(c)
        # sum bit i = a_i ^ b_i ^ carry_i, over the whole value at once
        s = gb.xor(a, b)
        if w == first + 1:
            s[:, first] ^= carries[first]
        elif w > first:
            s[:, first:] ^= torch.stack(carries[first:w], dim=1)
        return (s, c) if want_carry else s

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b = a + ~b + 1."""
        return self.add(a, self.gb.not_(b), cin=self.gb.const_ones(a.shape[0]))

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Truncated w-bit product (school method)."""
        gb = self.gb
        n, w, _ = a.shape
        at, bt = _bits(a), _bits(b)
        acc = None
        for i in range(w):
            pp = torch.stack([gb.and_(bt[i], at[k]) for k in range(w - i)],
                             dim=1)
            if acc is None:
                acc = pp
            else:
                acc = torch.cat([acc[:, :i], self.add(acc[:, i:], pp)], dim=1)
        return acc

    def reduce_add(self, a: torch.Tensor) -> torch.Tensor:
        """(n, w) -> (1, w): tree sum over the n vector elements; an odd
        element is carried up to the next level."""
        vals = a
        while vals.shape[0] > 1:
            m = vals.shape[0] // 2
            s = self.add(vals[:m], vals[m:2 * m])
            if vals.shape[0] % 2:
                s = torch.cat([s, vals[2 * m:]], dim=0)
            vals = s
        return vals

    # -- comparison / selection ------------------------------------------------

    def cmp_ge(self, a: torch.Tensor, b: torch.Tensor,
               key_w: int | None = None) -> torch.Tensor:
        """Unsigned a >= b on the low ``key_w`` bits: the carry-out of
        a + ~b + 1 (borrow chain, one AND per bit).  Returns (n, 1, 2)."""
        gb = self.gb
        n, w, _ = a.shape
        kw = key_w or w
        ab = _pairs(a[:, :kw], gb.not_(b[:, :kw]))
        c = gb.const_ones(n)
        for i in range(kw):
            x = gb.xor(ab[i], c)                  # (a_i ^ c, ~b_i ^ c)
            c = gb.xor(gb.and_(x[0], x[1]), c)
        return c[:, None, :]

    def cmp_eq(self, a: torch.Tensor, b: torch.Tensor,
               key_w: int | None = None) -> torch.Tensor:
        """a == b on the low ``key_w`` bits: XNOR per bit, then a pairwise
        AND tree (an odd bit is carried up).  Returns (n, 1, 2)."""
        gb = self.gb
        n, w, _ = a.shape
        kw = key_w or w
        bits = list(_bits(gb.not_(gb.xor(a[:, :kw], b[:, :kw]))))
        while len(bits) > 1:
            nxt = [gb.and_(bits[i], bits[i + 1])
                   for i in range(0, len(bits) - 1, 2)]
            if len(bits) % 2:
                nxt.append(bits[-1])
            bits = nxt
        return bits[0][:, None, :]

    def select(self, s: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        """s ? a : b, bitwise mux (one AND per bit); s is (n, 1, 2)."""
        gb = self.gb
        s0 = s[:, 0].contiguous()
        d = _bits(gb.xor(a, b))                              # (w, n, 2)
        picked = torch.stack([gb.and_(s0, d[i]) for i in range(a.shape[1])],
                             dim=1)
        return gb.xor(picked, b)

    def minmax(self, a: torch.Tensor, b: torch.Tensor, key_w: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        ge = self.cmp_ge(a, b, key_w)          # a >= b on keys
        return self.select(ge, b, a), self.select(ge, a, b)

    # -- composite workload kernels --------------------------------------------

    def sort_local(self, v: torch.Tensor, key_w: int,
                   direction_up: bool = True,
                   merge_only: bool = False) -> torch.Tensor:
        """Bitonic sort — or, with ``merge_only``, just the final merging
        network of an already-bitonic input — of the n elements within each
        of ``count`` independent values; v is (count, n, w, 2), n a power
        of two.  Each compare-exchange step is one ``minmax`` over all
        count * n/2 pairs, in the JAX package's pair order.

        The layout is public: the pairs (i, i ^ j) of a step are the two
        halves of a (n/2j, 2, j) view, so the lanes are reshuffled by
        reshapes, never by index tensors."""
        count, n, w, _ = v.shape
        assert n & (n - 1) == 0, "bitonic sort needs power-of-two chunk"
        k = 2 * n if merge_only else 2
        while (k <= 2 * n) if merge_only else (k <= n):
            j = min(k, n) // 2 if merge_only else k // 2
            while j >= 1:
                vv = v.reshape(count, n // (2 * j), 2, j, w, 2)
                lo = vv[:, :, 0].reshape(-1, w, 2)
                hi = vv[:, :, 1].reshape(-1, w, 2)
                mn, mx = self.minmax(lo, hi, key_w)
                if merge_only:
                    first, second = (mn, mx) if direction_up else (mx, mn)
                else:
                    # direction per pair: ((lo & k) == 0) == direction_up
                    # with lo = a*2j + c; k >= 2j, so it depends on a only
                    a_up = (torch.arange(n // (2 * j), device=v.device)
                            * 2 * j & k) == 0
                    up = (a_up == direction_up).view(1, -1, 1, 1, 1) \
                        .expand(count, -1, j, 1, 1).reshape(-1, 1, 1)
                    first = torch.where(up, mn, mx)
                    second = torch.where(up, mx, mn)
                shape = (count, n // (2 * j), 1, j, w, 2)
                v = torch.cat([first.view(shape), second.view(shape)],
                              dim=2).view(count, n, w, 2)
                j //= 2
            if merge_only:
                break
            k *= 2
        return v

    def bitonic_merge(self, a: torch.Tensor, key_w: int) -> torch.Tensor:
        """Sort a BITONIC sequence (n, w) ascending: log(n) half-cleaner
        stages, the merging network of :meth:`sort_local`."""
        return self.sort_local(a[None], key_w, merge_only=True)[0]

    def merge_step(self, a: torch.Tensor, b: torch.Tensor, key_w: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Merge two sorted chunks (each (n, w)) -> (low, high) sorted
        chunks: ascending ``a`` against reversed ``b`` half-cleans the
        pair, and one bitonic merge per side finishes."""
        mn, mx = self.minmax(a, b.flip(0), key_w)
        return self.bitonic_merge(mn, key_w), self.bitonic_merge(mx, key_w)

    def pair_join(self, a: torch.Tensor, b: torch.Tensor,
                  key_w: int) -> torch.Tensor:
        """Loop-join cell: all (i, j) pairs, equality on keys, output the
        packed record (key | payload_a | payload_b) or zeros.  a is
        (na, w), b is (nb, w); output (na*nb, w)."""
        na, w, _ = a.shape
        nb = b.shape[0]
        aa = a.repeat_interleave(nb, dim=0)
        bb = b.repeat(na, 1, 1)
        eq = self.cmp_eq(aa, bb, key_w)
        half = (w - key_w) // 2
        packed = torch.cat([aa[:, :key_w + half],
                            bb[:, key_w:key_w + (w - key_w - half)]], dim=1)
        zeros = self.gb.const_bits(_zeros(na * nb))[:, None, :]
        return self.select(eq, packed, zeros.expand(packed.shape))

    def dot8(self, m: torch.Tensor, v: torch.Tensor, acc: torch.Tensor,
             nr: int, nj: int, acc_w: int = 32) -> torch.Tensor:
        """acc[r] += sum_j M[r,j] * v[j] with 8-bit operands.

        m is (nr*nj, 8), v is (nj, 8), acc is (nr, acc_w).  Products are
        computed at 16 bits, the j-reduction tree widens by a bit a level
        up to acc_w, and the result is added into acc."""
        b2 = v[None].expand(nr, nj, 8, 2).reshape(nr * nj, 8, 2)
        prod16 = self._mul_widening(m, b2).reshape(nr, nj, 16, 2)
        vals = [prod16[:, j] for j in range(nj)]
        width = 16
        while len(vals) > 1:
            width = min(width + 1, acc_w)
            vals = self._add_level(vals, width)
        return self.add(acc, self._zext(vals[0], acc_w))

    def _mul_widening(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(n, w) x (n, w) -> (n, 2w) full product: shifted, zero-extended
        partial products summed with a pairwise adder tree (the shifts and
        extensions are free wire placement; one constant zero wire is fanned
        out)."""
        n, w, _ = a.shape
        gb = self.gb
        zero = gb.const_bits(_zeros(n))[:, None, :]
        at, bt = _bits(a), _bits(b)
        pps = []
        for i in range(w):
            pp = torch.stack([gb.and_(bt[i], at[k]) for k in range(w)], dim=1)
            pps.append(torch.cat([zero.expand(n, i, 2), pp,
                                  zero.expand(n, w - i, 2)], dim=1))
        while len(pps) > 1:
            pps = self._add_level(pps)
        return pps[0]

    def _zext(self, a: torch.Tensor, w: int) -> torch.Tensor:
        """Zero-extend to w bits with a fresh constant zero (or truncate)."""
        n, cur, _ = a.shape
        if cur >= w:
            return a[:, :w]
        z = self.gb.const_bits(_zeros(n))
        return torch.cat([a, z[:, None, :].expand(n, w - cur, 2)], dim=1)

    def _add_level(self, vals: list[torch.Tensor], width: int | None = None
                   ) -> list[torch.Tensor]:
        """One level of an adder tree: the sums of (vals[0], vals[1]),
        (vals[2], vals[3]), ... in order, each operand zero-extended to
        ``width`` first (None: as it is), an odd value carried up."""
        ext = ((lambda v: v) if width is None else
               (lambda v: self._zext(v, width)))
        nxt = [self.add(ext(vals[i]), ext(vals[i + 1]))
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(ext(vals[-1]))
        return nxt

    def xnor_pop_sign(self, m: torch.Tensor, v: torch.Tensor, nr: int,
                      nj: int) -> torch.Tensor:
        """Binary FC layer cell (XONN): out[r] = sign(2*popcount_j(
        xnor(M[r,j], v[j])) - nj) as a single bit.  m is (nr*nj, 1), v is
        (nj, 1); output (nr, 1)."""
        gb = self.gb
        vv = v[:, 0][None].expand(nr, nj, 2)
        bits = gb.not_(gb.xor(m.reshape(nr, nj, 2), vv))
        # popcount: an adder tree over 1-bit values, a bit wider a level
        vals = [bits[:, j][:, None, :] for j in range(nj)]
        while len(vals) > 1:
            vals = self._add_level(vals, vals[0].shape[1] + 1)
        cnt = vals[0]                              # (nr, wc)
        thresh = (nj + 1) // 2
        tlab = torch.stack(
            [gb.const_bits(np.full(nr, (thresh >> i) & 1, dtype=np.uint8))
             for i in range(cnt.shape[1])], dim=1)
        return self.cmp_ge(cnt, tlab)
