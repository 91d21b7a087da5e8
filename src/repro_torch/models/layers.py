"""Core transformer layers: RMSNorm, RoPE, GQA attention (full, prefill,
decode against a contiguous, an int8 or a paged KV cache, cross-attention),
SwiGLU MLP, embeddings.  The port's copy of ``repro.models.layers``.

Parameters live in small ``nn.Module``s (:class:`RMSNorm`,
:class:`Attention`, :class:`MLP`, :class:`Embed`) on an explicit device, in
the reference's ``(d_in, d_out)`` layout with ``x @ W``; the apply
functions keep the reference's names and take the module in place of its
parameter dict.  Prompts of ``CHUNKED_SDPA_THRESHOLD`` tokens or more take
the flash-style ``_sdpa_chunked`` (online softmax over q and kv blocks), as
in the reference.

The reference's sharding constraints sit at the same places
(``distributed.sharding.shard``): they redistribute DTensor activations
under active rules and pass plain tensors as they are.  On DTensors the
attention core (``_sdpa``, ``attention_decode``) runs on each rank's shard
(``_attention_local``, ``_decode_local``): batch and KV heads stay where
they are, the queries' heads follow the KV heads, and where the KV heads
cannot shard, the queries' sequence does (the reference's ``scores_q``),
or a decode cache's sequence (``kv_seq``; the softmax is then combined
across ranks).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.sharding import (axis_names, current_rules, local_region,
                                    shard)
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
    q = shard(q.reshape(b, s, nh, hd), "batch", "seq", "heads", None)
    k = shard(k.reshape(b, s, nkv, hd), "batch", "seq", "kv_heads", None)
    v = shard(v.reshape(b, s, nkv, hd), "batch", "seq", "kv_heads", None)
    q = apply_rope(q, positions, p.rope_freqs)
    k = apply_rope(k, positions, p.rope_freqs)
    return q, k, v


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
    ``CHUNKED_SDPA_THRESHOLD`` query tokens on, the chunked form.  On
    DTensors, each rank's shard (``_attention_local``)."""
    form = _sdpa_chunked if q.shape[1] >= CHUNKED_SDPA_THRESHOLD \
        else _sdpa_dense
    if isinstance(q, DTensor):
        return _attention_local(q, k, v, cfg, causal_offset, form)
    return form(q, k, v, cfg, causal_offset)


# ---------------------------------------------------------------------------
# attention on each rank's shard (DTensor activations)
# ---------------------------------------------------------------------------


def _kv_layout(kp):
    """Where K/V's (or a cache's) placement on one mesh dim leaves the
    attention: batch and head shards are kept, anything else replicated."""
    return kp if kp in (Shard(0), Shard(2)) else Replicate()


def _shard_offset(mesh, pl: tuple, dim: int, local: int) -> int:
    """The global index of this rank's first entry on tensor dim ``dim``
    (``local`` entries a rank, even shards): the mesh dims sharding it,
    major to minor."""
    coord = mesh.get_coordinate()
    lin = 0
    for i, p in enumerate(pl):
        if p == Shard(dim):
            lin = lin * mesh.size(i) + coord[i]
    return lin * local


def _attention_local(q, k, v, cfg, causal_offset, form) -> DTensor:
    """``form`` (dense or chunked attention) on each rank's shard of DTensor
    q, k, v.  Keeps K/V's batch and head shards and gives the queries the
    same; where a mesh dim shards neither, the rules' ``scores_q`` names it
    and it divides the query length, the queries' sequence is sharded over
    it (each rank's causal mask offset by its first row).  Returns the
    DTensor (b, sq, nh * hd) in the rules' (batch, seq, heads) layout."""
    mesh = q.device_mesh
    names = axis_names(mesh)
    rules = current_rules()
    scores_q = rules.axis("scores_q") if rules is not None else None
    kv_pl = tuple(_kv_layout(p) for p in k.placements)
    b, sq, nh, hd = q.shape
    q_pl = tuple(Shard(1) if p == Replicate() and names[i] == scores_q
                 and sq % mesh.size(i) == 0 else p
                 for i, p in enumerate(kv_pl))
    seq = tuple(i for i, p in enumerate(q_pl) if p == Shard(1))
    kv_grad = tuple(Partial() if i in seq else p for i, p in enumerate(kv_pl))

    def local(ql, kl, vl):
        offset = causal_offset
        if seq and offset is not None:   # this rank's first query row
            offset += _shard_offset(mesh, q_pl, 1, ql.shape[1])
        return form(ql, kl, vl, cfg, offset)

    out = local_region(local, mesh,
                       (q_pl, kv_pl, kv_pl), (q_pl,),
                       lambda i, o: (b, sq, nh * hd),
                       (q_pl, kv_grad, kv_grad))(q, k, v)
    # back to the activations' layout (a query-sequence shard only bounds
    # the scores)
    return shard(out, "batch", "seq", "heads")


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
    out = _sdpa(q, k, v, cfg, 0 if causal else None) @ p.wo
    return shard(out, "batch", "seq", None)


def attention_prefill(p: Attention, x: torch.Tensor, cfg, positions=None):
    """Returns (out, (k, v)) for subsequent decode."""
    if positions is None:
        positions = _positions(x)
    q, k, v = _qkv(p, x, cfg, positions)
    out = _sdpa(q, k, v, cfg, 0) @ p.wo
    return shard(out, "batch", "seq", None), (k, v)


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
    positions <= cache_len.  DTensor caches: each rank's shard
    (``_decode_local``).  Returns (out, cache)."""
    q, k_new, v_new = _qkv(p, x, cfg, cache_len[:, None])
    if isinstance(cache[0], DTensor):
        out = _decode_local(q, k_new, v_new, cache, cache_len)
    else:
        out = _decode_core(q, k_new, v_new, cache, cache_len)
    return out.to(x.dtype) @ p.wo, cache


def _decode_core(q, k_new, v_new, cache, cache_len, lo: int | None = None,
                 groups: tuple = ()) -> torch.Tensor:
    """The decode attention on plain tensors: writes the new K/V at
    cache_len and attends; returns (b, 1, nh * hd) float32.  A shard of a
    cache whose sequence is split holds positions ``lo`` on: it writes only
    the rows whose position falls in it, and the softmax's max, sum and
    weighted values are reduced over ``groups`` (mesh dims)."""
    b, _, nh, hd = q.shape
    nkv = k_new.shape[2]
    rows = torch.arange(b, device=q.device)
    if len(cache) == 4:
        k_cache, v_cache, k_sc, v_sc = cache
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        writes = ((k_cache, kq), (v_cache, vq), (k_sc, ks), (v_sc, vs))
    else:
        k_cache, v_cache = cache
        writes = ((k_cache, k_new.to(k_cache.dtype)),
                  (v_cache, v_new.to(v_cache.dtype)))
    skv = k_cache.shape[1]
    if lo is None:
        for t, new in writes:
            t[rows, cache_len] = new[:, 0]
    else:
        pos = cache_len - lo
        mine = (pos >= 0) & (pos < skv)
        pos = pos.clamp(0, skv - 1)
        for t, new in writes:
            keep = mine.view((b,) + (1,) * (new.ndim - 2))
            t[rows, pos] = torch.where(keep, new[:, 0], t[rows, pos])
    if len(cache) == 4:
        k_eff = k_cache.float() * k_sc.float()[..., None]
        v_eff = v_cache.float() * v_sc.float()[..., None]
    else:
        k_eff, v_eff = k_cache.float(), v_cache.float()
    qg = q.reshape(b, 1, nkv, nh // nkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_eff) * hd ** -0.5
    cols = torch.arange(skv, device=q.device) + (lo or 0)
    valid = cols[None, :] <= cache_len[:, None]
    scores = scores.masked_fill(~valid[:, None, None, None, :], -1e30)
    if not groups:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_eff)
        return out.reshape(b, 1, nh * hd)
    m = scores.amax(-1, keepdim=True)
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    e = torch.exp(scores - m)
    den = e.sum(-1)                                       # (b, h, g, 1)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", e, v_eff)
    for g in groups:
        den = funcol.all_reduce(den, "sum", g)
        acc = funcol.all_reduce(acc, "sum", g)
    out = acc / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, 1, nh * hd)


def _decode_local(q, k_new, v_new, cache, cache_len) -> DTensor:
    """``_decode_core`` on each rank's shard of DTensor caches: the new
    token's q, K and V take the cache's batch and KV-head shards; a mesh
    dim that shards the cache's sequence (``kv_seq``) gets the rows it
    holds written and joins the softmax's reductions."""
    mesh = cache[0].device_mesh
    cpl = tuple(cache[0].placements)
    head_pl = tuple(_kv_layout(p) for p in cpl)
    batch_pl = tuple(p if p == Shard(0) else Replicate() for p in cpl)
    seq = tuple(i for i, p in enumerate(cpl) if p == Shard(1))
    groups = tuple((mesh, i) for i in seq)

    def local(ql, kl, vl, cl, *c):
        lo = _shard_offset(mesh, cpl, 1, c[0].shape[1]) if seq else None
        return _decode_core(ql, kl, vl, c, cl, lo, groups)

    b, _, nh, hd = q.shape
    return local_region(
        local, mesh, (head_pl,) * 3 + (batch_pl,) + tuple(tuple(t.placements)
                                              for t in cache),
        (head_pl,), lambda i, o: (b, 1, nh * hd))(
        q, k_new, v_new, cache_len, *cache)


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
    return shard(_sdpa(q, k, v, cfg, None) @ p.wo, "batch", "seq", None)


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
    g = shard(x @ p.w_gate, "batch", "seq", "ff")
    u = shard(x @ p.w_up, "batch", "seq", "ff")
    return shard((F.silu(g) * u) @ p.w_down, "batch", "seq", None)


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
    w = p.embed
    if isinstance(w, DTensor) and Shard(0) in w.placements:
        return shard(_embed_vocab_shards(w, tokens), "batch", "seq", None)
    return shard(F.embedding(tokens, w), "batch", "seq", None)


def _embed_vocab_shards(w: DTensor, tokens) -> DTensor:
    """The lookup in a vocab-sharded table: each rank looks up the tokens
    its rows hold and zeros the rest, so the result is a partial sum over
    the vocab's mesh dims (the tokens' batch shards are kept).  Its
    gradient is a plain sum too, as the tied unembedding's is."""
    mesh = w.device_mesh
    tok_pl = tuple(tokens.placements) if isinstance(tokens, DTensor) \
        else (Replicate(),) * mesh.ndim
    tok_pl = tuple(Replicate() if wp == Shard(0) else tp
                   for wp, tp in zip(w.placements, tok_pl))
    wpl = tuple(w.placements)
    w_grad = tuple(Partial() if wp == Replicate() and tp != Replicate()
                   else wp for wp, tp in zip(wpl, tok_pl))

    def lookup(wl, tl):
        lo = _shard_offset(mesh, wpl, 0, wl.shape[0])
        mine = (tl >= lo) & (tl < lo + wl.shape[0])
        return F.embedding((tl - lo).clamp(0, wl.shape[0] - 1), wl) \
            * mine[..., None].to(wl.dtype)

    pl = tuple(Partial() if wp == Shard(0) else tp
               for wp, tp in zip(wpl, tok_pl))
    return local_region(lookup, mesh, (wpl, tok_pl), (pl,),
                        lambda i, o: tuple(tokens.shape) + (w.shape[1],),
                        (w_grad, tok_pl))(w, tokens)


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    w = p.lm_head if hasattr(p, "lm_head") else p.embed.T
    return shard((x @ w).float(), "batch", "seq", "vocab")
