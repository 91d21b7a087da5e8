"""Plain PyTorch paged decode attention: the version the CPU path runs and
the card's kernel is held against (``repro.kernels.paged_attn.ref``).

Gathers KV pages through the block table into dense (batch, seq, kv_heads,
head_dim) tensors and runs masked GQA attention for one decode step, in
float32.  Block-table entries of -1 (pages not allocated) gather page 0;
every position they cover is past ``seq_lens`` and masked.

:func:`paged_decode_attention_split` computes the same function divided as
the card's kernels divide it: per-chunk partials (:func:`chunk_partials`)
and their combination (:func:`combine_partials`).  Both serve the CPU
tests; the CPU path of the wrapper runs the one-pass version.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           seq_lens: torch.Tensor) -> torch.Tensor:
    """q: (batch, q_heads, head_dim); k_pages/v_pages: (num_pages, page_sz,
    kv_heads, head_dim); block_table: (batch, max_pages) int; seq_lens:
    (batch,) int.  Returns (batch, q_heads, head_dim) float32."""
    q = q.float()
    k_pages = k_pages.float()
    v_pages = v_pages.float()
    batch, q_heads, head_dim = q.shape
    _, page_sz, kv_heads, _ = k_pages.shape
    max_pages = block_table.shape[1]
    group = q_heads // kv_heads
    idx = block_table.long().clamp(min=0)
    k = k_pages[idx].reshape(batch, max_pages * page_sz, kv_heads, head_dim)
    v = v_pages[idx].reshape(batch, max_pages * page_sz, kv_heads, head_dim)
    qg = q.reshape(batch, kv_heads, group, head_dim)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * (1.0 / math.sqrt(head_dim))
    pos = torch.arange(max_pages * page_sz, device=q.device)[None, :]
    mask = pos < seq_lens.to(q.device).long()[:, None]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(batch, q_heads, head_dim)


# ---------------------------------------------------------------------------
# the same function divided as the card's kernels divide it: per-chunk
# partials (the split kernel), then their combination (the combine kernel)
# ---------------------------------------------------------------------------

def chunk_starts(seq_lens, page_size: int, chunk_pages: int) -> np.ndarray:
    """(batch + 1,) int32: sequence b owns chunks [out[b], out[b + 1]), each
    of ``chunk_pages`` pages (the last one ragged), ceil(ceil(seq_len /
    page_size) / chunk_pages) of them."""
    pages = -(-np.asarray(seq_lens, dtype=np.int64) // page_size)
    n = -(-pages // chunk_pages)
    return np.concatenate([[0], np.cumsum(n)]).astype(np.int32)


def chunk_partials(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, block_table, seq_lens,
                   chunk_pages: int):
    """Every chunk's softmax partial, in chunk order: returns (m, l, acc) of
    shapes (n_chunks, kv_heads, group), the same and (n_chunks, kv_heads,
    group, head_dim), all float32: m the chunk's largest scaled score, l the
    sum of exp(s - m) and acc the sum of exp(s - m) v over the chunk's
    tokens, and the (batch + 1,) chunk starts."""
    bt = np.asarray(block_table)
    sl = np.asarray(seq_lens)
    q = q.float()
    k_pages = k_pages.float()
    v_pages = v_pages.float()
    batch, q_heads, head_dim = q.shape
    _, page_sz, kv_heads, _ = k_pages.shape
    qg = q.reshape(batch, kv_heads, q_heads // kv_heads, head_dim)
    scale = 1.0 / math.sqrt(head_dim)
    starts = chunk_starts(sl, page_sz, chunk_pages)
    ms, ls, accs = [], [], []
    span = chunk_pages * page_sz
    for b in range(batch):
        for t0 in range(0, int(sl[b]), span):
            pos = np.arange(t0, min(t0 + span, int(sl[b])))
            pages = torch.from_numpy(bt[b, pos // page_sz].astype(np.int64))
            offs = torch.from_numpy(pos % page_sz)
            k = k_pages[pages, offs]                    # (n, kv_heads, hd)
            v = v_pages[pages, offs]
            s = torch.einsum("hgd,nhd->hgn", qg[b], k) * scale
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.einsum("hgn,nhd->hgd", p, v))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs), starts


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     starts) -> torch.Tensor:
    """Merge each sequence's chunks (m = max m_i, l = sum l_i e^{m_i - m},
    acc = sum acc_i e^{m_i - m}) into acc / max(l, 1e-30): (batch,
    kv_heads, group, head_dim) float32."""
    outs = []
    for b in range(len(starts) - 1):
        mb, lb, ab = (x[starts[b]:starts[b + 1]] for x in (m, l, acc))
        mx = mb.amax(dim=0)
        f = torch.exp(mb - mx)
        lsum = (lb * f).sum(dim=0)
        asum = (ab * f[..., None]).sum(dim=0)
        outs.append(asum / lsum.clamp(min=1e-30)[..., None])
    return torch.stack(outs)


def paged_decode_attention_split(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, block_table,
                                 seq_lens, chunk_pages: int) -> torch.Tensor:
    """:func:`paged_decode_attention` computed chunk by chunk, as the card's
    kernels divide it: (batch, q_heads, head_dim) float32."""
    m, l, acc, starts = chunk_partials(q, k_pages, v_pages, block_table,
                                       seq_lens, chunk_pages)
    return combine_partials(m, l, acc, starts).reshape(q.shape[0], -1,
                                                       q.shape[2])
