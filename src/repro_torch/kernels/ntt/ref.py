"""Plain PyTorch versions of the NTT kernels in ``csrc/ntt.cu``: the same
functions in ``int64`` tensor ops, stage by stage as
``repro.protocols.ckks.ntt`` computes them.

Operands are ``(B, P, N)``: B stacks of P rows, row p of a stack reduced
mod ``q[p]`` (``q`` is ``(P, 1)``, the tables ``(P, N)``).  Every residue is
below 2^31, so each product stays below 2^62.  The CPU path and the tests
run these; ``chip_smoke.py`` holds the kernels against them on the card.
Nothing on the card's main path calls them.
"""

from __future__ import annotations

import torch


def ntt_forward(a: torch.Tensor, q: torch.Tensor,
                psi: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT: standard order in, bit-reversed out."""
    b, p, n = a.shape
    qq = q.reshape(1, p, 1, 1)
    v = a
    t, m = n, 1
    while m < n:
        t //= 2
        w = v.reshape(b, p, m, 2, t)
        s = psi[:, m:2 * m].reshape(1, p, m, 1)
        u = w[..., 0, :]
        x = (w[..., 1, :] * s) % qq
        v = torch.stack([(u + x) % qq, (u + qq - x) % qq],
                        dim=-2).reshape(b, p, n)
        m *= 2
    return v


def ntt_inverse(a: torch.Tensor, q: torch.Tensor, psi_inv: torch.Tensor,
                n_inv: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT: bit-reversed in, standard order out."""
    b, p, n = a.shape
    qq = q.reshape(1, p, 1, 1)
    v = a
    t, m = 1, n
    while m > 1:
        h = m // 2
        w = v.reshape(b, p, h, 2, t)
        s = psi_inv[:, h:2 * h].reshape(1, p, h, 1)
        u = w[..., 0, :]
        x = w[..., 1, :]
        v = torch.stack([(u + x) % qq, ((u + qq - x) % qq * s) % qq],
                        dim=-2).reshape(b, p, n)
        t *= 2
        m = h
    return (v * n_inv.reshape(1, p, 1)) % q.reshape(1, p, 1)


def mul_mod(a: torch.Tensor, b: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """a * b mod q, elementwise."""
    return (a * b) % q.reshape(1, -1, 1)


def ntt_mul(operands: list[torch.Tensor], n_coef: int, terms, q: torch.Tensor,
            psi: torch.Tensor, psi_inv: torch.Tensor,
            n_inv: torch.Tensor) -> torch.Tensor:
    """The fused product as the composition of the three above: operands
    (G, P, N), the first ``n_coef`` transformed forward; output o is the
    inverse of the sum mod q of the products of its terms' operands.
    Returns (G, O, P, N)."""
    x = [ntt_forward(a, q, psi) if i < n_coef else a
         for i, a in enumerate(operands)]
    qq = q.reshape(1, -1, 1)
    outs = []
    for out_terms in terms:
        acc = None
        for i, j in out_terms:
            pr = mul_mod(x[i], x[j], q)
            acc = pr if acc is None else (acc + pr) % qq
        outs.append(ntt_inverse(acc, q, psi_inv, n_inv))
    return torch.stack(outs, dim=1)
