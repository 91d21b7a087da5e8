"""Mamba2 (SSD) block: chunked state-space duality for prefill and an O(1)
state recurrence for decode.  Single B/C group, scalar-per-head A, the
Mamba2 paper's default ([arXiv:2405.21060]).  The port's copy of
``repro.models.mamba2``.

``_ssd_chunked`` writes the reference's three- and four-operand einsums as
products of two operands at a time, each contracting one index, so no
(b, chunks, Q, Q, heads, head_dim) intermediate is formed whatever the
einsum backend's contraction order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import on_shards, pad, shard
from .layers import _const, _dtype, _init, _zeros

CONV_K = 4


def dims(cfg) -> tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state


class Mamba2(nn.Module):
    """``init_mamba2``: in_proj to z (gate), x, B, C and dt heads; the
    depthwise causal conv; A as log(linspace(1, 16)); out_proj."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        d_in, nh, n = dims(cfg)
        dt = _dtype(cfg)
        dev = gen.device
        conv_ch = d_in + 2 * n
        self.in_proj = _init(gen, (d, 2 * d_in + 2 * n + nh), d ** -0.5, dt)
        self.conv_w = _init(gen, (CONV_K, conv_ch), 0.5, dt)
        self.conv_b = _zeros((conv_ch,), dt, dev)
        self.a_log = _const(torch.log(torch.linspace(1.0, 16.0, nh,
                                                     device=dev)))
        self.dt_bias = _zeros((nh,), torch.float32, dev)
        self.d_skip = _const(torch.ones(nh, device=dev))
        self.out_proj = _init(gen, (d_in, d), d_in ** -0.5, dt)
        self.norm_scale = _const(torch.ones(d_in, device=dev))


def _split_proj(p: Mamba2, x: torch.Tensor, cfg):
    d_in, nh, n = dims(cfg)
    zxbcdt = x @ p.in_proj
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * n]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, xbc, dt_raw


def _causal_conv(p: Mamba2, xbc: torch.Tensor, conv_state=None):
    """Depthwise causal conv (k=4).  xbc: (b, s, ch).  With conv_state (b,
    k-1, ch) (decode), uses and returns the rolled state."""
    if conv_state is not None:
        window = torch.cat([conv_state, xbc], dim=1)         # (b, k, ch)
        out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
        return F.silu(out)[:, None], window[:, 1:]
    b, s, ch = xbc.shape
    xp = pad(xbc, (0, 0, CONV_K - 1, 0))
    out = xp[:, 0:s] * p.conv_w[0]
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + s] * p.conv_w[i]
    return F.silu(out + p.conv_b), None


def _ssd_chunked(x, dtv, B, C, a_log, chunk: int) -> torch.Tensor:
    """SSD scan. x: (b, s, nh, P); dtv: (b, s, nh); B, C: (b, s, N).
    Returns y (b, s, nh, P) float32."""
    b, s, nh, P = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    nc = s // Q
    A = -torch.exp(a_log)                                  # (nh,) negative
    xc = x.reshape(b, nc, Q, nh, P).float()
    dtc = dtv.reshape(b, nc, Q, nh)
    Bc = B.reshape(b, nc, Q, n).float()
    Cc = C.reshape(b, nc, Q, n).float()
    cum = torch.cumsum(dtc * A, dim=2)                     # (b, nc, Q, nh)

    # intra-chunk (quadratic within chunks); masked before exp
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,i,j,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], ldiff, -1e30))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)           # (b,nc,Q,Q)
    w = cb[..., None] * L * dtc[:, :, None, :, :]          # (b,nc,i,j,nh)
    # sum_j w[b,c,i,j,h] x[b,c,j,h,p], a batched product per (b, c, h)
    y_intra = torch.matmul(w.permute(0, 1, 4, 2, 3),
                           xc.permute(0, 1, 3, 2, 4))      # (b,nc,nh,Q,P)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)               # (b,nc,Q,nh,P)

    # chunk state contributions: sum_j exp(tail) dt x_j B_j^T
    tail = cum[:, :, -1:, :] - cum                         # prod_{k>j} a_k
    wx = (torch.exp(tail) * dtc)[..., None] * xc           # (b,nc,Q,nh,P)
    states = torch.matmul(wx.permute(0, 1, 3, 4, 2),
                          Bc[:, :, None])                  # (b,nc,nh,P,N)
    decay_chunk = torch.exp(cum[:, :, -1, :])              # (b,nc,nh)

    h = torch.zeros((b, nh, P, n), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * decay_chunk[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, 1)                            # (b,nc,nh,P,N)

    # sum_n C[b,c,i,n] h[b,c,h,p,n], then the decay to position i
    ch = torch.matmul(h_in, Cc[:, :, None].transpose(-1, -2))  # (b,nc,nh,P,Q)
    y_inter = ch.permute(0, 1, 4, 2, 3) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(b, s, nh, P)


def _gated_norm_out(p: Mamba2, y: torch.Tensor, z: torch.Tensor,
                    dtype) -> torch.Tensor:
    """Gated RMS-norm, then the out projection."""
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-5) * p.norm_scale).to(dtype)
    return y @ p.out_proj


def mamba2_block(p: Mamba2, x: torch.Tensor, cfg) -> torch.Tensor:
    """Prefill path.  x: (b, s, d) -> (b, s, d); the sequence is padded to
    whole chunks and cut back."""
    b, s0, d = x.shape
    n_pad = (-s0) % min(cfg.ssm_chunk, max(s0, 1))
    xp = pad(x, (0, 0, 0, n_pad)) if n_pad else x
    s = xp.shape[1]
    d_in, nh, n = dims(cfg)
    # the projection's parts as whole rows (its output is cut in three
    # along the model-sharded dim)
    z, xbc, dt_raw = (shard(t, "batch", "seq", None)
                      for t in _split_proj(p, xp, cfg))
    xbc, _ = _causal_conv(p, xbc)
    xs = xbc[..., :d_in].reshape(b, s, nh, cfg.ssm_head_dim)
    B = xbc[..., d_in:d_in + n]
    C = xbc[..., d_in + n:]
    dtv = F.softplus(dt_raw.float() + p.dt_bias)
    y = on_shards(lambda *a: _ssd_chunked(*a, cfg.ssm_chunk),
                  ((xs, ("b", None, "h", None)), (dtv, ("b", None, "h")),
                   (B, ("b", None, None)), (C, ("b", None, None)),
                   (p.a_log, ("h",))), ("b", None, "h", None))
    if n_pad:
        y, xs, z = y[:, :s0], xs[:, :s0], z[:, :s0]
    y = y + xs.float() * p.d_skip[None, None, :, None]
    return shard(_gated_norm_out(p, y.reshape(b, s0, d_in), z, x.dtype),
                 "batch", "seq", None)


def mamba2_init_state(cfg, batch: int, device) -> dict:
    d_in, nh, n = dims(cfg)
    return {
        "h": torch.zeros((batch, nh, cfg.ssm_head_dim, n),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d_in + 2 * n),
                            dtype=_dtype(cfg), device=device),
    }


def mamba2_decode(p: Mamba2, x: torch.Tensor, cfg, state: dict):
    """One-token recurrence.  x: (b, 1, d); state: {'h', 'conv'}.  Returns
    (y, new state)."""
    b = x.shape[0]
    d_in, nh, n = dims(cfg)
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    conv_out, conv_state = _causal_conv(p, xbc, state["conv"])
    xs = conv_out[:, 0, :d_in].reshape(b, nh, cfg.ssm_head_dim).float()
    B = conv_out[:, 0, d_in:d_in + n].float()
    C = conv_out[:, 0, d_in + n:].float()
    dtv = F.softplus(dt_raw[:, 0].float() + p.dt_bias)
    a = torch.exp(dtv * -torch.exp(p.a_log))               # (b, nh)
    h = state["h"] * a[:, :, None, None] + \
        (dtv[:, :, None] * xs)[..., None] * B[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", C, h)
    y = y + xs * p.d_skip[None, :, None]
    return (_gated_norm_out(p, y.reshape(b, 1, d_in), z, x.dtype),
            {"h": h, "conv": conv_state})

