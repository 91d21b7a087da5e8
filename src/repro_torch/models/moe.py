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

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..distributed.sharding import on_shards, shard
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


def _whole_groups(x: torch.Tensor, n_groups: int):
    """(x, the groups' logical axis).  The router groups run over the
    flattened tokens, so a rank holds whole ones when the batch shards
    divide the group count: then the groups shard over "batch".  Else
    ``x`` is made whole over its batch's mesh dims and the groups are
    replicated (None), so they stay the unsharded step's."""
    if not isinstance(x, DTensor):
        return x, "batch"
    shards = math.prod(x.device_mesh.size(i)
                       for i, p in enumerate(x.placements) if p == Shard(0))
    if n_groups % shards == 0:
        return x, "batch"
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p == Shard(0) else p for p in x.placements)), None


def _experts(xt, disp, comb, w_gate, w_up, w_down, cap: int, dtype):
    """Dispatch, the experts' SwiGLU and the combine: xt (G, g, d), disp
    and comb (G, g, e, cap), the experts' weights (e, ...) -> (G, g, d)
    float32."""
    n_groups, _, d = xt.shape
    e = disp.shape[2]
    xin = torch.einsum("Ggd,Ggec->Gecd", xt.float(), disp).to(dtype)
    # (e, G * cap, d) @ (e, d, f): one batched product an expert
    xe = xin.permute(1, 0, 2, 3).reshape(e, n_groups * cap, d)
    act = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    eout = torch.bmm(act, w_down).reshape(e, n_groups, cap, d)
    eout = eout.permute(1, 0, 2, 3)                           # (G, e, c, d)
    return torch.einsum("Gecd,Ggec->Ggd", eout.float(), comb)


def moe_mlp(p: MoE, x: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (b, s, d) -> (out, Switch aux loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = group_size(b * s, cfg.router_group_size)
    n_groups = (b * s) // g
    cap = max(int(g * k * cfg.capacity_factor / e), 1)

    xg, gb = _whole_groups(x, n_groups)
    xt = xg.reshape(n_groups, g, d)
    # softmax and top-k read whole rows: the experts' logits made whole
    logits = shard(xt.float() @ p.router, gb, None, None)
    probs = torch.softmax(logits, dim=-1)                     # (G, g, e)
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
    disp = shard(disp, gb, None, "experts", None)
    comb = shard(comb, gb, None, "experts", None)

    # the experts on each rank's (group, expert) shards: the reference's
    # xin and act constraints ("batch", "experts"); the combine's sum over
    # experts is a partial sum across the experts' shards
    out = on_shards(
        lambda *a: _experts(*a, cap, x.dtype),
        ((xt, ("G", None, None)), (disp, ("G", None, "e", None)),
         (comb, ("G", None, "e", None)), (p.experts_gate, ("e", None, None)),
         (p.experts_up, ("e", None, None)),
         (p.experts_down, ("e", None, None))), ("G", None, None))
    # the tokens' layout again (its backward returns replicated groups'
    # gradients whole)
    out = shard(out.reshape(b, s, d).to(x.dtype), "batch", "seq", None)

    if hasattr(p, "shared"):
        out = out + mlp(p.shared, x)

    # load-balancing aux loss (Switch): e * sum_e f_e * P_e
    me = sel.sum(2).mean((0, 1))
    pe = probs.mean((0, 1))
    return shard(out, "batch", "seq", None), e * (me * pe).sum()
