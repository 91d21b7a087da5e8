"""Core transformer layers: RMSNorm, RoPE, GQA attention (full, prefill,
decode against a contiguous, an int8 or a paged KV cache, cross-attention),
SwiGLU MLP, embeddings.  The port's copy of ``repro.models.layers``.

Parameters live in small ``nn.Module``s (:class:`RMSNorm`,
:class:`Attention`, :class:`MLP`, :class:`Embed`) on an explicit device, in
the reference's ``(d_in, d_out)`` layout with ``x @ W``; the apply
functions keep the reference's names and take the module in place of its
parameter dict.  The reference's sharding constraints are no-ops outside a
mesh and are dropped.  Prompts of ``CHUNKED_SDPA_THRESHOLD`` tokens or
more take the flash-style ``_sdpa_chunked`` (online softmax over q and kv
blocks), as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..kernels.paged_attn import ops as paged_ops


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init(gen: torch.Generator, shape, scale: float,
          dtype: torch.dtype) -> nn.Parameter:
    """A standard normal draw times ``scale``, made in float32 on the
    generator's device and cast, as ``layers._init`` does."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


def _const(t: torch.Tensor) -> nn.Parameter:
    """A parameter holding ``t`` as it is (biases, gates, norm scales)."""
    return nn.Parameter(t, requires_grad=False)


def _zeros(shape, dtype, device) -> nn.Parameter:
    return _const(torch.zeros(shape, dtype=dtype, device=device))


def remat_call(fn, *args, remat: bool = True):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    autograd is recording: the reference's ``jax.checkpoint`` with its
    default ("full") policy, which keeps only the inputs and recomputes
    the rest in the backward pass.  Without a graph being built there is
    nothing to recompute, so serving calls ``fn`` directly."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# norm
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device),
                                  requires_grad=False)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Float64, as the reference computes them before its float32 cast."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq); freqs the
    float32 ``rope_frequencies`` (``Attention.rope_freqs``).  The
    split-halves rotation (not interleaved)."""
    ang = positions[..., :, None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qkv bias)
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        dt = _dtype(cfg)
        s = d ** -0.5
        self.wq = _init(gen, (d, nh * hd), s, dt)
        self.wk = _init(gen, (d, nkv * hd), s, dt)
        self.wv = _init(gen, (d, nkv * hd), s, dt)
        self.wo = _init(gen, (nh * hd, d), (nh * hd) ** -0.5, dt)
        # a constant, not a parameter: outside the state dict
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_frequencies(hd, cfg.rope_theta).astype(np.float32)).to(
                gen.device), persistent=False)
        if cfg.qkv_bias:
            self.q_bias = _zeros((nh * hd,), dt, gen.device)
            self.k_bias = _zeros((nkv * hd,), dt, gen.device)
            self.v_bias = _zeros((nkv * hd,), dt, gen.device)


def _qkv(p: Attention, x: torch.Tensor, cfg, positions) -> tuple:
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.q_bias
        k = k + p.k_bias
        v = v + p.v_bias
    q = apply_rope(q.reshape(b, s, nh, hd), positions, p.rope_freqs)
    k = apply_rope(k.reshape(b, s, nkv, hd), positions, p.rope_freqs)
    return q, k, v.reshape(b, s, nkv, hd)


CHUNKED_SDPA_THRESHOLD = 8192   # flash-style blocking from this seq on
SDPA_Q_BLOCK = 512
SDPA_KV_BLOCK = 1024


def _sdpa_chunked(q, k, v, cfg, causal_offset: int | None,
                  q_block: int = SDPA_Q_BLOCK,
                  kv_block: int = SDPA_KV_BLOCK) -> torch.Tensor:
    """Flash-style online-softmax attention in float32: never materializes
    (sq, skv), one (b, nkv, group, q_block, kv_block) tile at a time.  The
    reference's padding to whole blocks, its -1e30 mask (padded keys
    included) and its 1e-30 floor on the row sums."""
    b, sq0, nh, hd = q.shape
    skv0, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    qpad = (-sq0) % q_block
    kpad = (-skv0) % kv_block
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
    if kpad:
        k = F.pad(k, (0, 0, 0, 0, 0, kpad))
        v = F.pad(v, (0, 0, 0, 0, 0, kpad))
    sq, skv = sq0 + qpad, skv0 + kpad
    scale = hd ** -0.5
    nq, nk = sq // q_block, skv // kv_block
    qb = q.reshape(b, nq, q_block, nkv, group, hd).float()
    kb = k.reshape(b, nk, kv_block, nkv, hd).float()
    vb = v.reshape(b, nk, kv_block, nkv, hd).float()
    dev = q.device
    blocks = []
    for iq in range(nq):
        qi = qb[:, iq] * scale                       # (b, qb, nkv, g, hd)
        m = torch.full((b, nkv, group, q_block), -1e30, device=dev)
        l = torch.zeros((b, nkv, group, q_block), device=dev)
        acc = torch.zeros((b, nkv, group, q_block, hd), device=dev)
        for ik in range(nk):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kb[:, ik])
            cols = ik * kv_block + torch.arange(kv_block, device=dev)[None, :]
            if causal_offset is not None:
                rows = iq * q_block + torch.arange(
                    q_block, device=dev)[:, None] + causal_offset
                keep = (cols <= rows) & (cols < skv0)
            else:
                keep = (cols < skv0).expand(q_block, kv_block)
            s = torch.where(keep[None, None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vb[:, ik])
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4))    # (b, qb, nkv, g, hd)
    out = torch.stack(blocks, 1).reshape(b, sq, nh * hd)
    return out[:, :sq0].to(q.dtype)


def _sdpa_dense(q, k, v, cfg, causal_offset: int | None) -> torch.Tensor:
    """The whole (sq, skv) score matrix at once: the reference's einsum and
    softmax in float32."""
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    qg = q.reshape(b, sq, nkv, group, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * hd ** -0.5
    if causal_offset is not None:
        iq = torch.arange(sq, device=q.device)[:, None] + causal_offset
        ik = torch.arange(skv, device=q.device)[None, :]
        scores = scores.masked_fill(~(ik <= iq)[None, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, nh * hd).to(q.dtype)


def _sdpa(q, k, v, cfg, causal_offset: int | None) -> torch.Tensor:
    """q: (b, sq, nh, hd); k/v: (b, skv, nkv, hd).  causal_offset = skv - sq
    for causal masking; None = no mask (full).  From
    ``CHUNKED_SDPA_THRESHOLD`` query tokens on, the chunked form."""
    if q.shape[1] >= CHUNKED_SDPA_THRESHOLD:
        return _sdpa_chunked(q, k, v, cfg, causal_offset)
    return _sdpa_dense(q, k, v, cfg, causal_offset)


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, device=x.device)[None].expand(b, s)


def attention(p: Attention, x: torch.Tensor, cfg, positions=None,
              causal: bool = True) -> torch.Tensor:
    """Self-attention over the whole sequence (causal, or full for the
    encoder)."""
    if positions is None:
        positions = _positions(x)
    q, k, v = _qkv(p, x, cfg, positions)
    return _sdpa(q, k, v, cfg, 0 if causal else None) @ p.wo


def attention_prefill(p: Attention, x: torch.Tensor, cfg, positions=None):
    """Returns (out, (k, v)) for subsequent decode."""
    if positions is None:
        positions = _positions(x)
    q, k, v = _qkv(p, x, cfg, positions)
    return _sdpa(q, k, v, cfg, 0) @ p.wo, (k, v)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) int8 quantization: x (b, s, h, d) -> (q int8,
    scale f16 (b, s, h)).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp(min=1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def attention_decode(p: Attention, x: torch.Tensor, cfg, cache, cache_len):
    """One new token against a padded KV cache.

    x: (b, 1, d); cache: (k, v) each (b, max_seq, nkv, hd), or with
    ``cfg.kv_cache_dtype == "int8"`` (k_q, v_q, k_scale, v_scale): int8
    payloads and per-(token, head) f16 scales (b, max_seq, nkv).  cache_len
    (b,) valid entries.  The new token is written at position cache_len in
    place (the reference returns an updated copy) and attends over
    positions <= cache_len.  Returns (out, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, cache_len[:, None])
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = torch.arange(b, device=x.device)
    if len(cache) == 4:
        k_cache, v_cache, k_sc, v_sc = cache
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        k_cache[rows, cache_len] = kq[:, 0]
        v_cache[rows, cache_len] = vq[:, 0]
        k_sc[rows, cache_len] = ks[:, 0]
        v_sc[rows, cache_len] = vs[:, 0]
        k_eff = k_cache.float() * k_sc.float()[..., None]
        v_eff = v_cache.float() * v_sc.float()[..., None]
    else:
        k_cache, v_cache = cache
        k_cache[rows, cache_len] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, cache_len] = v_new[:, 0].to(v_cache.dtype)
        k_eff, v_eff = k_cache.float(), v_cache.float()
    skv = k_cache.shape[1]
    qg = q.reshape(b, 1, nkv, nh // nkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_eff) * hd ** -0.5
    valid = torch.arange(skv, device=x.device)[None, :] <= cache_len[:, None]
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_eff)
    out = out.reshape(b, 1, nh * hd).to(x.dtype) @ p.wo
    return out, cache


def attention_cross(p: Attention, x: torch.Tensor, memory: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Cross-attention (decoder -> encoder memory): no mask, no RoPE, no
    biases."""
    b, s, _ = x.shape
    sm = memory.shape[1]
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p.wq).reshape(b, s, nh, hd)
    k = (memory @ p.wk).reshape(b, sm, nkv, hd)
    v = (memory @ p.wv).reshape(b, sm, nkv, hd)
    return _sdpa(q, k, v, cfg, None) @ p.wo


def attention_decode_paged(p: Attention, x: torch.Tensor, cfg, cache,
                           layer: int, step) -> torch.Tensor:
    """One new token against layer ``layer`` of a paged KV cache
    (``serve.paged_kv.PagedKVCache``), through the paged-attention kernel.

    ``step`` is the cache's ``AppendStep`` for this decode step: the slot of
    each sequence's new token, its position (the contiguous path's
    cache_len) and the tables after the append, prepared once for every
    layer of the step.  The token's K/V are
    written into the layer's pages and the kernel attends over the first
    cache_len + 1 tokens, which is what ``attention_decode`` attends over.
    Returns out (b, 1, d)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, cfg, step.positions[:, None])
    cache.write(layer, step, k_new[:, 0], v_new[:, 0])
    out = paged_ops.paged_decode_attention(
        q[:, 0], cache.k_pages[layer], cache.v_pages[layer],
        tables=step.tables)
    return out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype) @ p.wo


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        dt = _dtype(cfg)
        self.w_gate = _init(gen, (d, f), d ** -0.5, dt)
        self.w_up = _init(gen, (d, f), d ** -0.5, dt)
        self.w_down = _init(gen, (f, d), f ** -0.5, dt)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        dt = _dtype(cfg)
        self.embed = _init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)
        if not cfg.tie_embeddings:
            self.lm_head = _init(gen, (cfg.d_model, cfg.vocab_size),
                                 cfg.d_model ** -0.5, dt)


def embed(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.embed[tokens]


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    w = p.lm_head if hasattr(p, "lm_head") else p.embed.T
    return (x @ w).float()
