"""Mixture-of-Experts MLP: top-k routing with capacity (GShard-style dense
dispatch at group granularity), optional shared experts (DeepSeekMoE).  The
port's copy of ``repro.models.moe``.

The dispatch is the reference's: tokens go to their experts' queues through
one-hot dispatch and combine tensors (group, experts, capacity), and every
expert's weights are read at every call, whatever the routing.  The
reference's three-operand combine einsum is written as two-operand
products: each (token, expert) pair is chosen by at most one of a token's
top-k choices, so the sum over choices has one term and the result is the
same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, _dtype, _init, mlp


class MoE(nn.Module):
    """``init_moe``: a float32 router, stacked expert weights and, with
    ``cfg.n_shared_experts``, a shared SwiGLU of ``d_ff * n_shared``."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        dt = _dtype(cfg)
        self.router = _init(gen, (d, e), d ** -0.5, torch.float32)
        self.experts_gate = _init(gen, (e, d, f), d ** -0.5, dt)
        self.experts_up = _init(gen, (e, d, f), d ** -0.5, dt)
        self.experts_down = _init(gen, (e, f, d), f ** -0.5, dt)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, gen, d_ff=f * cfg.n_shared_experts)


def group_size(tokens: int, router_group_size: int) -> int:
    """The largest divisor of ``tokens`` not above the configured group
    size."""
    g = min(router_group_size, tokens)
    while tokens % g:
        g -= 1
    return g


def moe_mlp(p: MoE, x: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (b, s, d) -> (out, Switch aux loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = group_size(b * s, cfg.router_group_size)
    n_groups = (b * s) // g
    cap = max(int(g * k * cfg.capacity_factor / e), 1)

    xt = x.reshape(n_groups, g, d)
    probs = torch.softmax(xt.float() @ p.router, dim=-1)      # (G, g, e)
    topv, topi = torch.topk(probs, k, dim=-1)                 # (G, g, k)
    topv = topv / topv.sum(-1, keepdim=True)

    # position of each (token, choice) in its expert's queue, in the
    # flattened (token, choice) order
    sel = F.one_hot(topi, e).float()                          # (G, g, k, e)
    flat = sel.reshape(n_groups, g * k, e)
    pos = (torch.cumsum(flat, 1) - flat).reshape(n_groups, g, k, e)
    pos = (pos * sel).sum(-1)                                 # (G, g, k)
    keep = pos < cap
    weights = topv * keep                                     # dropped = 0

    # dispatch/combine tensors (G, g, e, cap); a dropped choice's position
    # is past the capacity and has no one-hot column
    pos_oh = F.one_hot(pos.long().clamp(max=cap), cap + 1)[..., :cap].float()
    disp = torch.einsum("Ggke,Ggkc->Ggec", sel, pos_oh * keep[..., None])
    comb = torch.einsum("Ggke,Ggkc->Ggec", sel * weights[..., None], pos_oh)

    xin = torch.einsum("Ggd,Ggec->Gecd", xt.float(), disp).to(x.dtype)
    # (e, G * cap, d) @ (e, d, f): one batched product an expert
    xe = xin.permute(1, 0, 2, 3).reshape(e, n_groups * cap, d)
    act = F.silu(torch.bmm(xe, p.experts_gate)) * torch.bmm(xe, p.experts_up)
    eout = torch.bmm(act, p.experts_down).reshape(e, n_groups, cap, d)
    eout = eout.permute(1, 0, 2, 3)                           # (G, e, c, d)
    out = torch.einsum("Gecd,Ggec->Ggd", eout.float(), comb)
    out = out.reshape(b, s, d).to(x.dtype)

    if hasattr(p, "shared"):
        out = out + mlp(p.shared, x)

    # load-balancing aux loss (Switch): e * sum_e f_e * P_e
    me = sel.sum(2).reshape(-1, e).mean(0)
    pe = probs.reshape(-1, e).mean(0)
    return out, e * (me * pe).sum()
