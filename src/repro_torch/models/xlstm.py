"""xLSTM blocks ([arXiv:2405.04517]): mLSTM (matrix memory: the parallel
quadratic form, the chunkwise form for long sequences, an O(1) recurrence
for decode) and sLSTM (scalar memory, a sequential scan with exponential
gating).  The port's copy of ``repro.models.xlstm``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import on_shards, shard
from .layers import _const, _dtype, _init


def _norm(p, y: torch.Tensor, dtype) -> torch.Tensor:
    """The blocks' closing RMS-norm (epsilon 1e-5), cast to ``dtype``."""
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + 1e-5) * p.norm_scale).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """``init_mlstm``: q/k/v and out projections, float32 input and forget
    gates (forget bias 3: forget ~ 1 at init)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        dt = _dtype(cfg)
        dev = gen.device
        self.mq = _init(gen, (d, d), d ** -0.5, dt)
        self.mk = _init(gen, (d, d), d ** -0.5, dt)
        self.mv = _init(gen, (d, d), d ** -0.5, dt)
        self.w_i = _init(gen, (d, nh), d ** -0.5, torch.float32)
        self.w_f = _init(gen, (d, nh), d ** -0.5, torch.float32)
        self.f_bias = _const(torch.full((nh,), 3.0, device=dev))
        self.m_out = _init(gen, (d, d), d ** -0.5, dt)
        self.norm_scale = _const(torch.ones(d, device=dev))


def _mlstm_qkv(p: MLSTM, x: torch.Tensor, cfg):
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    q = shard((x @ p.mq).reshape(b, s, nh, hd), "batch", "seq", "heads",
              None)
    k = shard((x @ p.mk).reshape(b, s, nh, hd), "batch", "seq", "heads",
              None)
    v = shard((x @ p.mv).reshape(b, s, nh, hd), "batch", "seq", "heads",
              None)
    logi = x.float() @ p.w_i                                  # (b, s, nh)
    logf = -F.softplus(-(x.float() @ p.w_f + p.f_bias))      # log sigmoid
    return q, k, v, logi, logf


# Chunkwise form from this sequence length on (the reference's threshold)
MLSTM_CHUNK_THRESHOLD = 2048
MLSTM_CHUNK = 512


#: the parallel region's labels: batch and heads
_QKV = ((("b", None, "h", None),) * 3) + ((("b", None, "h"),) * 2)


def _on_heads(fn, q, k, v, logi, logf):
    """``fn(q, k, v, logi, logf) -> y (b, s, nh, hd)``, each rank on its
    batch and head shards (``distributed.sharding.on_shards``)."""
    return on_shards(fn, tuple(zip((q, k, v, logi, logf), _QKV)),
                     ("b", None, "h", None))


def mlstm_block_chunked(p: MLSTM, x: torch.Tensor, cfg,
                        chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Chunkwise-parallel mLSTM: O(s * chunk) memory instead of O(s^2).
    A within-chunk quadratic D-matrix plus the inter-chunk (C, n, M)
    recurrent state with running max-stabilizers."""
    b, s0, d = x.shape
    y = _on_heads(lambda *a: _mlstm_chunks(*a, chunk), *_mlstm_qkv(p, x, cfg))
    return shard(_norm(p, y.reshape(b, s0, d), x.dtype) @ p.m_out,
                 "batch", "seq", None)


def _mlstm_chunks(q, k, v, logi, logf, chunk: int) -> torch.Tensor:
    """The chunkwise form's core: (b, s, nh, hd) q, k, v and (b, s, nh)
    gates -> y (b, s, nh, hd) float32."""
    b, s0, nh, hd = q.shape
    pad = (-s0) % chunk
    dev = q.device
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logi = torch.cat([logi, torch.full((b, pad, nh), -1e30,
                                           device=dev)], 1)
        logf = torch.cat([logf, torch.zeros((b, pad, nh), device=dev)], 1)
    s = s0 + pad
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, nh, hd).float() * hd ** -0.5
    kc = k.reshape(b, nc, chunk, nh, hd).float()
    vc = v.reshape(b, nc, chunk, nh, hd).float()
    lic = logi.reshape(b, nc, chunk, nh)
    lfc = logf.reshape(b, nc, chunk, nh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    C = torch.zeros((b, nh, hd, hd), device=dev)
    n = torch.zeros((b, nh, hd), device=dev)
    M = torch.full((b, nh), -1e30, device=dev)
    ys = []
    for c in range(nc):
        qi, ki, vi, li, lf = qc[:, c], kc[:, c], vc[:, c], lic[:, c], \
            lfc[:, c]
        g = torch.cumsum(lf, 1)                              # (b, Q, nh)
        bmat = g[:, :, None, :] - g[:, None, :, :] + li[:, None, :, :]
        bmat = torch.where(tri[None, :, :, None], bmat, -1e30)
        s_inter = g + M[:, None, :]                          # (b, Q, nh)
        m = torch.maximum(bmat.amax(2), s_inter)             # (b, Q, nh)
        dexp = torch.exp(bmat - m[:, :, None, :])
        w = torch.einsum("bihd,bjhd->bijh", qi, ki) * dexp
        inter_scale = torch.exp(s_inter - m)                 # (b, Q, nh)
        num = (torch.einsum("bijh,bjhd->bihd", w, vi)
               + inter_scale[..., None]
               * torch.einsum("bihd,bhde->bihe", qi, C))
        den_dot = (w.sum(2)
                   + inter_scale * torch.einsum("bihd,bhd->bih", qi, n))
        den = torch.maximum(den_dot.abs(), torch.exp(-m))
        ys.append(num / den[..., None])
        # state update
        tot = g[:, -1]                                       # (b, nh)
        decay_j = tot[:, None, :] - g + li                   # (b, Q, nh)
        M_new = torch.maximum(tot + M, decay_j.amax(1))
        carry_scale = torch.exp(tot + M - M_new)
        wj = torch.exp(decay_j - M_new[:, None, :])
        C = (carry_scale[:, :, None, None] * C
             + torch.einsum("bjhd,bjhe->bhde", wj[..., None] * ki, vi))
        n = carry_scale[..., None] * n + torch.einsum("bjh,bjhd->bhd", wj, ki)
        M = M_new
    return torch.stack(ys, 1).reshape(b, s, nh, hd)[:, :s0]


def mlstm_block(p: MLSTM, x: torch.Tensor, cfg) -> torch.Tensor:
    """Parallel (stabilized) quadratic form; x: (b, s, d)."""
    b, s, d = x.shape
    if s >= MLSTM_CHUNK_THRESHOLD:
        return mlstm_block_chunked(p, x, cfg)
    y = _on_heads(_mlstm_parallel, *_mlstm_qkv(p, x, cfg))
    return shard(_norm(p, y.reshape(b, s, d), x.dtype) @ p.m_out,
                 "batch", "seq", None)


def _mlstm_parallel(q, k, v, logi, logf) -> torch.Tensor:
    """The parallel form's core: (b, s, nh, hd) q, k, v and (b, s, nh)
    gates -> y (b, s, nh, hd) float32."""
    s, hd = q.shape[1], q.shape[3]
    cumf = torch.cumsum(logf, 1)                              # (b, s, nh)
    # log D_ij = cumf_i - cumf_j + logi_j  (i >= j)
    dmat = cumf[:, :, None, :] - cumf[:, None, :, :] + logi[:, None, :, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    dmat = torch.where(mask[None, :, :, None], dmat, -torch.inf)
    m = dmat.amax(2, keepdim=True)                            # row stabilizer
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bihd,bjhd->bijh", q.float(),
                          k.float()) * hd ** -0.5
    w = scores * dexp
    norm = torch.maximum(w.sum(2, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("bijh,bjhd->bihd", w / norm, v.float())


def mlstm_init_state(cfg, batch: int, device) -> dict:
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return {"C": torch.zeros((batch, nh, hd, hd), device=device),
            "n": torch.zeros((batch, nh, hd), device=device),
            "m": torch.full((batch, nh), -1e30, device=device)}


def mlstm_decode(p: MLSTM, x: torch.Tensor, cfg, state: dict):
    """One-token recurrence; x: (b, 1, d).  Returns (y, new state)."""
    b, _, d = x.shape
    hs = (("b", "h", None, None), ("b", "h", None), ("b", "h"))
    y, C, n, m = on_shards(
        _mlstm_step,
        tuple(zip(_mlstm_qkv(p, x, cfg), _QKV)) + tuple(
            zip((state["C"], state["n"], state["m"]), hs)),
        (("b", "h", None),) + hs)
    return _norm(p, y.reshape(b, 1, d), x.dtype) @ p.m_out, \
        {"C": C, "n": n, "m": m}


def _mlstm_step(q, k, v, logi, logf, C, n, m):
    """The recurrence's core: one token's (b, 1, nh, hd) q, k, v and
    (b, 1, nh) gates against the state -> (y (b, nh, hd), C, n, m)."""
    hd = q.shape[-1]
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    logi, logf = logi[:, 0], logf[:, 0]                       # (b, nh)
    m_new = torch.maximum(logf + m, logi)
    a = torch.exp(logf + m - m_new)
    bgt = torch.exp(logi - m_new)
    C = C * a[..., None, None] + \
        bgt[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = n * a[..., None] + bgt[..., None] * k
    qf = q * hd ** -0.5
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], C, n, m_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """``init_slstm``: float32 input and recurrent weights of the four
    gates."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        dev = gen.device
        self.w_x = _init(gen, (d, 4 * d), d ** -0.5, torch.float32)
        self.w_h = _init(gen, (d, 4 * d), d ** -0.5, torch.float32)
        self.bias = _const(torch.zeros(4 * d, device=dev))
        self.norm_scale = _const(torch.ones(d, device=dev))


def slstm_init_state(cfg, batch: int, device) -> dict:
    z = torch.zeros((batch, cfg.d_model), device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((batch, cfg.d_model), -1e30, device=device)}


def _slstm_step(p: SLSTM, state: dict, xt: torch.Tensor) -> dict:
    """xt: (b, d) f32; the exponential-gated scalar LSTM cell."""
    pre = xt @ p.w_x + state["h"] @ p.w_h + p.bias
    zi, zf, zz, zo = pre.chunk(4, dim=-1)
    logf = -F.softplus(-zf)
    m_new = torch.maximum(logf + state["m"], zi)
    a = torch.exp(logf + state["m"] - m_new)
    bgt = torch.exp(zi - m_new)
    c = state["c"] * a + bgt * torch.tanh(zz)
    n = state["n"] * a + bgt
    h = torch.sigmoid(zo) * c / n.clamp(min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_block(p: SLSTM, x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequential scan over time; x: (b, s, d)."""
    b, s, d = x.shape
    state = slstm_init_state(cfg, b, x.device)
    xf = x.float()
    hs = []
    for t in range(s):
        state = _slstm_step(p, state, xf[:, t])
        hs.append(state["h"])
    return shard(_norm(p, torch.stack(hs, 1), x.dtype), "batch", "seq", None)


def slstm_decode(p: SLSTM, x: torch.Tensor, cfg, state: dict):
    new = _slstm_step(p, state, x[:, 0].float())
    return _norm(p, new["h"][:, None], x.dtype), new
