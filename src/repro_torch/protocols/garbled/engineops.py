"""The AND-XOR *engine* (§4.2/§4.3) on PyTorch: expands each bytecode
instruction into a subcircuit of AND/XOR gates at run time.  The port's
counterpart of ``repro.protocols.garbled.engineops``, for the subcircuits
the ported workloads use (compare, mux, min/max, bitonic networks).

The same code drives both parties (it only talks to the ``Gates``
interface), which keeps the two interpreters in lockstep on the table
stream.  Values are label tensors shaped (n, w, 2): n vector elements of w
bits, bit 0 the LSB.  Wire shuffles are free: tensor reindexing.

Every AND call, its size and its order are those of the JAX package, so
the gate ids and table messages are identical; the XORs around them are
batched over whole values where the result is the same, to issue fewer
tensor operations.
"""

from __future__ import annotations

import torch

from .gates import Gates


class AndXorOps:
    def __init__(self, gb: Gates):
        self.gb = gb

    def cmp_ge(self, a: torch.Tensor, b: torch.Tensor,
               key_w: int | None = None) -> torch.Tensor:
        """Unsigned a >= b on the low ``key_w`` bits: the carry-out of
        a + ~b + 1 (borrow chain, one AND per bit).  Returns (n, 1, 2)."""
        gb = self.gb
        n, w, _ = a.shape
        kw = key_w or w
        nb = gb.not_(b[:, :kw])
        c = gb.const_ones(n)
        for i in range(kw):
            axc = gb.xor(a[:, i], c)
            bxc = gb.xor(nb[:, i], c)
            c = gb.xor(gb.and_(axc, bxc), c)
        return c[:, None, :]

    def select(self, s: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        """s ? a : b, bitwise mux (one AND per bit); s is (n, 1, 2)."""
        gb = self.gb
        s0 = s[:, 0].contiguous()
        d = gb.xor(a, b).transpose(0, 1).contiguous()       # (w, n, 2)
        picked = torch.stack([gb.and_(s0, d[i]) for i in range(a.shape[1])],
                             dim=1)
        return gb.xor(picked, b)

    def minmax(self, a: torch.Tensor, b: torch.Tensor, key_w: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        ge = self.cmp_ge(a, b, key_w)          # a >= b on keys
        return self.select(ge, b, a), self.select(ge, a, b)

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
