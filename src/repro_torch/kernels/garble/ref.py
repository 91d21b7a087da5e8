"""Plain PyTorch half gates: the same function as the CUDA kernels in
``csrc/garble.cu``, written as tensor ops on int64 bit views.

The CPU path and the tests run these; ``chip_smoke.py`` holds the kernels
against them on the card.  Nothing on the card's main path calls them.
"""

from __future__ import annotations

import torch

from ...protocols.garbled.aes import hash_labels


def _mask(bits: torch.Tensor, lbl: torch.Tensor) -> torch.Tensor:
    """bits (m,) in {0, 1} -> bits * lbl, label-wise."""
    return lbl * bits[:, None]


def _tweaks(gid0: int, m: int, device: torch.device) -> torch.Tensor:
    return 2 * (gid0 + torch.arange(m, dtype=torch.int64, device=device))


def garble_and(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor,
               gid0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-gates garbling (ZRE15) of m AND gates with ids gid0, gid0+1, ...

    a, b: (m, 2) zero labels; r: (2,) the global offset R.  Returns the
    output zero labels (m, 2) and the table (m, 4) laid out [TG | TE]."""
    m = a.shape[0]
    j0 = _tweaks(gid0, m, a.device)
    j1 = j0 + 1
    rr = r.view(1, 2).expand(m, 2)
    # all four hashes in one AES pass: rows [A0 | A0^R | B0 | B0^R]
    h = hash_labels(torch.cat([a, a ^ rr, b, b ^ rr]),
                    torch.cat([j0, j0, j1, j1]))
    ha0, ha1, hb0, hb1 = h.split(m)
    pa = a[:, 0] & 1
    pb = b[:, 0] & 1
    tg = ha0 ^ ha1 ^ _mask(pb, rr)
    wg = ha0 ^ _mask(pa, tg)
    te = hb0 ^ hb1 ^ a
    we = hb0 ^ _mask(pb, te ^ a)
    return wg ^ we, torch.cat([tg, te], dim=1)


def eval_and(wa: torch.Tensor, wb: torch.Tensor, tab: torch.Tensor,
             gid0: int) -> torch.Tensor:
    """Half-gates evaluation: active labels + tables -> active output."""
    m = wa.shape[0]
    j0 = _tweaks(gid0, m, wa.device)
    h = hash_labels(torch.cat([wa, wb]), torch.cat([j0, j0 + 1]))
    hwa, hwb = h.split(m)
    tg, te = tab[:, :2], tab[:, 2:]
    wg = hwa ^ _mask(wa[:, 0] & 1, tg)
    we = hwb ^ _mask(wb[:, 0] & 1, te ^ wa)
    return wg ^ we
