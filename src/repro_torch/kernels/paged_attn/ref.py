"""Plain PyTorch paged decode attention: the version the CPU path runs and
the card's kernel is held against (``repro.kernels.paged_attn.ref``).

Gathers KV pages through the block table into dense (batch, seq, kv_heads,
head_dim) tensors and runs masked GQA attention for one decode step, in
float32.  Block-table entries of -1 (pages not allocated) gather page 0;
every position they cover is past ``seq_lens`` and masked.
"""

from __future__ import annotations

import math

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
