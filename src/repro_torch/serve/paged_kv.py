"""Paged KV cache with MAGE-planned page schedules: the port's copy of
``repro.serve.paged_kv``.

Decode's KV access pattern is oblivious: step t appends one token and scans
all previous pages.  That lets the MAGE planner (``core/``) precompute the
page residency/prefetch schedule for a device-memory budget, the machinery
of the secure-computation memory programs applied to serving:

  * pages are allocated from a free list as sequences grow;
  * with a budget smaller than the full cache, the planner emits which
    pages to ISSUE-SWAP-IN from the host ahead of the step that reads them
    (the trace is `for t: read pages[0..t/page], append page t/page`);
  * the attention over resident pages runs through the paged-attention
    kernel (``kernels/paged_attn``; ``models.layers.attention_decode_paged``).

The swap directives are planned, not executed, here as in the reference.

:class:`PagedKVCache` keeps the reference's free-list order (page 0 is
allocated first) and block tables (host NumPy, -1 where no page is
allocated), with the pages as tensors on the cache's device.  It holds every
layer of a model under one block table: pages of shape ``(n_layers,
num_pages, page_size, kv_heads, head_dim)``; the reference's one-group cache
is ``n_layers=1``.  Writes are batched index writes in place of the
reference's per-token ``.at[].set``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.bytecode import Instr, Op, Program
from ..core.planner import PlanConfig, plan
from ..kernels import resolve_device, to_device
from ..kernels.paged_attn import ops as paged_ops


@dataclasses.dataclass
class PagedKVConfig:
    page_size: int = 64           # tokens per KV page
    max_pages_per_seq: int = 512


@dataclasses.dataclass(frozen=True)
class AppendStep:
    """Where one decode step's token goes for every sequence of the batch,
    and the tables the attention reads once it is appended: checked, split
    and (on a card) uploaded once for all the step's layers."""
    slots: torch.Tensor       # (2, batch) int64 on the device: page, offset
    positions: torch.Tensor   # (batch,) int64 on the device: the token's
    #                           position (the contiguous path's cache_len)
    tables: paged_ops.DecodeTables   # block table and lengths after the
    #                                    append (copies), and their plan


class PagedKVCache:
    """Block-table paged KV storage.

    k/v pages: (n_layers, num_pages, page_size, kv_heads, head_dim); block
    tables (batch, max_pages); seq_lens (batch,)."""

    def __init__(self, cfg: PagedKVConfig, num_pages: int, batch: int,
                 kv_heads: int, head_dim: int, dtype=torch.bfloat16, *,
                 n_layers: int = 1, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (n_layers, num_pages, cfg.page_size, kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.block_table = np.full((batch, cfg.max_pages_per_seq), -1,
                                   dtype=np.int32)
        self.seq_lens = np.zeros((batch,), dtype=np.int32)
        self._free = list(range(num_pages - 1, -1, -1))

    def alloc_page(self, seq: int) -> int:
        if not self._free:
            raise RuntimeError(f"paged KV cache out of pages "
                               f"({self.k_pages.shape[1]})")
        n = self.seq_lens[seq] // self.cfg.page_size
        if n >= self.block_table.shape[1]:
            raise RuntimeError(f"sequence {seq} exceeds max_pages_per_seq "
                               f"{self.block_table.shape[1]}")
        page = self._free.pop()
        self.block_table[seq, n] = page
        return page

    def _reserve(self, seq: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Allocate the pages that positions seq_len .. seq_len + n - 1 of
        ``seq`` reach, advance its length by n, and return their (page,
        offset) slots."""
        ps = self.cfg.page_size
        start = int(self.seq_lens[seq])
        for pos in range(start, start + n):
            if pos % ps == 0:
                self.seq_lens[seq] = pos
                self.alloc_page(seq)
        self.seq_lens[seq] = start + n
        pos = np.arange(start, start + n)
        return self.block_table[seq, pos // ps].astype(np.int64), pos % ps

    def write_prefill(self, seq: int, k: torch.Tensor,
                      v: torch.Tensor) -> None:
        """Append a run of tokens for ``seq``: k/v (n_layers, s, kv_heads,
        head_dim).  Equals appending them one at a time."""
        pages, offs = self._reserve(seq, k.shape[1])
        idx = to_device(np.stack([pages, offs]), self.device)
        self.k_pages[:, idx[0], idx[1]] = k.to(self.k_pages.dtype)
        self.v_pages[:, idx[0], idx[1]] = v.to(self.v_pages.dtype)

    def append(self, seq: int, k_tok: torch.Tensor,
               v_tok: torch.Tensor) -> None:
        """Append one token's K/V for sequence ``seq``: (n_layers,
        kv_heads, head_dim)."""
        self.write_prefill(seq, k_tok[:, None], v_tok[:, None])

    def append_step(self) -> AppendStep:
        """Reserve the next position of every sequence of the batch for one
        decode step (allocating pages at page boundaries), advance the
        lengths and prepare the attention's tables; the layers then
        :meth:`write` into the slots."""
        pos = self.seq_lens.astype(np.int64)
        slots = [self._reserve(seq, 1) for seq in range(len(pos))]
        dev = to_device(np.stack([np.concatenate([s[0] for s in slots]),
                                  np.concatenate([s[1] for s in slots]),
                                  pos]), self.device)
        tables = paged_ops.prepare_tables(
            self.block_table, self.seq_lens,
            page_size=self.cfg.page_size, num_pages=self.k_pages.shape[1],
            kv_heads=self.k_pages.shape[3], device=self.device)
        return AppendStep(dev[:2], dev[2], tables)

    def write(self, layer: int, step: AppendStep, k_new: torch.Tensor,
              v_new: torch.Tensor) -> None:
        """Store a decode step's K/V (batch, kv_heads, head_dim) of one
        layer in the step's slots."""
        page, off = step.slots
        self.k_pages[layer, page, off] = k_new.to(self.k_pages.dtype)
        self.v_pages[layer, page, off] = v_new.to(self.v_pages.dtype)


def decode_kv_trace(total_tokens: int, page_size: int,
                    kv_page_slots: int = 1) -> Program:
    """The oblivious KV access trace of a full decode as MAGE bytecode:
    step t writes page t//page_size and reads all pages 0..t//page_size.

    Coarsened to page granularity (one slot per page), this feeds the MAGE
    planner directly: replacement + prefetch schedules for a bounded page
    budget."""
    instrs = []
    n_pages = (total_tokens + page_size - 1) // page_size
    for t in range(0, total_tokens, page_size):
        p_cur = t // page_size
        # the current page is appended to (written)...
        instrs.append(Instr(Op.COPY,
                            outs=((p_cur * kv_page_slots, kv_page_slots),),
                            ins=((p_cur * kv_page_slots, kv_page_slots),)))
        # ...and the attention streams every earlier page, one instruction
        # per page (matching the paged-attention kernel's page loop)
        for p in range(p_cur):
            instrs.append(Instr(Op.COPY,
                                outs=(),
                                ins=((p * kv_page_slots, kv_page_slots),)))
    return Program(instrs=instrs, page_shift=0, protocol="kv",
                   vspace_slots=n_pages * kv_page_slots,
                   meta={"total_tokens": total_tokens,
                         "page_size": page_size})


def plan_kv_schedule(total_tokens: int, page_size: int, hbm_pages: int,
                     lookahead: int = 4, prefetch: int = 2):
    """MAGE memory program for a decode whose KV does not fit the device
    budget.  Returns (memory program, plan report).  When the budget is
    below the full working set the schedule thrashes by necessity (every
    step reads every page); the plan quantifies how much."""
    prog = decode_kv_trace(total_tokens, page_size)
    cfg = PlanConfig(num_frames=hbm_pages, lookahead=lookahead,
                     prefetch_pages=prefetch)
    return plan(prog, cfg)
