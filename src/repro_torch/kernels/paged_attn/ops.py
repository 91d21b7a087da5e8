"""The paged decode-attention wrapper the model layer calls, with launch
counters (``repro.kernels.paged_attn.ops``).

``paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens)`` takes
q (batch, q_heads, head_dim) in any float type and K/V pages (num_pages,
page_size, kv_heads, head_dim) in float32 or bfloat16, and returns (batch,
q_heads, head_dim) float32.  It does the reference's GQA reshape: q becomes
(batch, kv_heads, group, head_dim), read as float32 as the Pallas kernel
casts it (a bfloat16 q goes to the kernel as it is: its float32 values are
the same).

The block table (batch, max_pages) and the lengths (batch,) are host data
(NumPy arrays or CPU tensors, as ``serve.paged_kv.PagedKVCache`` keeps
them).  :func:`prepare_tables` checks their values on the host before any
pointer reaches the kernel (every length in [1, max_pages * page_size],
every page the lengths reach inside [0, num_pages)), plans the split over
chunks of pages, and on a card uploads the tables and the plan in one copy:
a :class:`DecodeTables`.  The wrapper takes either the host tables, which
it prepares itself, or ``tables=`` a :class:`DecodeTables`, which a decode
step prepares once for all its layers (``PagedKVCache.append_step``).  The
Pallas kernel returns the mean of V for a length of 0 and the jnp oracle
NaN; here a length of 0 raises.

On a CUDA tensor the wrapper launches the split kernel and, where a
sequence has more than one chunk, the combine kernel, on the current stream
(no synchronisation; the output and the workspace allocated here); on a CPU
tensor it runs the plain version in ``ref.py``; on anything else it raises.
The counters count wrapper calls that reached the card (``launches``: one
per call, whatever it launched), combine launches apart, the tokens of K/V
they read (summed lengths) and each call's lengths, and, apart, the calls
that ran the plain version.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from collections import Counter

import numpy as np
import torch

from .. import to_device
from . import kernel, ref

#: what the kernel takes: head_dim a multiple of 16 up to 256 (whole mma
#: k-steps, 16-byte rows in both page types), group up to 16 (two n-tiles
#: of 8), batch and kv_heads up to a grid's y extent
HEAD_DIM_STEP = 16
MAX_HEAD_DIM = 256
MAX_GROUP = 16
MAX_BATCH = 65535
#: the split plan aims at this many CTAs per SM (kv_heads x chunks): about
#: what the card holds at once (2-3 per SM in bf16 at head_dim 128), so a
#: long batch runs in one wave of equal chunks
CTAS_PER_SM = 3
#: the H100 SXM's SMs: the plan's card size where there is no card (the
#: CPU path, which runs the one-pass plain version, and the tests)
DEFAULT_SMS = 132

_lock = threading.Lock()
launches = 0
combine_launches = 0
tokens = 0
plain_calls = 0
launch_sizes: Counter = Counter()     # tuple(seq_lens) -> launches


def reset_counts() -> None:
    global launches, combine_launches, tokens, plain_calls
    with _lock:
        launches = combine_launches = tokens = plain_calls = 0
        launch_sizes.clear()


def counts() -> dict:
    with _lock:
        return {"launches": launches, "combine_launches": combine_launches,
                "tokens": tokens, "plain_calls": plain_calls,
                "launch_sizes": dict(launch_sizes)}


@dataclasses.dataclass(frozen=True, eq=False)
class DecodeTables:
    """One decode step's block table and lengths, checked, with the split
    plan: sequence b's pages in chunks of ``chunk_pages``, its chunks
    ``chunk_start[b]`` .. ``chunk_start[b + 1] - 1``.  On a card ``dev``
    holds (items, chunk_start, block_table) as int32 views of one uploaded
    tensor: items (n_items, 4) gives each chunk's sequence, first and end
    token and whether it is its sequence's only chunk."""
    block_table: np.ndarray     # (batch, max_pages) int32
    seq_lens: np.ndarray        # (batch,) int32
    page_size: int
    num_pages: int
    kv_heads: int
    chunk_pages: int
    chunk_start: np.ndarray     # (batch + 1,) int32
    device: torch.device
    dev: tuple | None           # on a card: the kernels' tables

    @property
    def batch(self) -> int:
        return len(self.seq_lens)

    @property
    def n_items(self) -> int:
        return int(self.chunk_start[-1])

    @functools.cached_property
    def max_chunks(self) -> int:
        """The most chunks of one sequence: above 1, a combine launch."""
        return int(np.diff(self.chunk_start).max(initial=0))

    @property
    def combine(self) -> bool:
        return self.max_chunks > 1

    @functools.cached_property
    def key(self) -> tuple:
        """The lengths, as ``launch_sizes`` counts them."""
        return tuple(self.seq_lens.tolist())

    @functools.cached_property
    def tokens(self) -> int:
        return int(self.seq_lens.sum())


def _host_ints(x, name: str) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{name} must be host data (NumPy or a CPU "
                             f"tensor), got a tensor on {x.device}")
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.kind not in "iu":
        raise ValueError(f"{name} must hold integers, got {a.dtype}")
    return a.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_chunk_pages(seq_lens, page_size: int, kv_heads: int,
                     sms: int = DEFAULT_SMS) -> int:
    """Pages per chunk: the fewest that keep kv_heads x chunks within
    CTAS_PER_SM x sms CTAs (one page a CTA where the pages are few)."""
    pages = int((-(-np.asarray(seq_lens, dtype=np.int64) // page_size))
                .sum())
    return max(1, -(-kv_heads * pages // (CTAS_PER_SM * sms)))


def prepare_tables(block_table, seq_lens, *, page_size: int, num_pages: int,
                   kv_heads: int, device, chunk_pages: int | None = None
                   ) -> DecodeTables:
    """Check the host tables' values against pages of shape (num_pages,
    page_size, kv_heads, .), plan the split (``chunk_pages`` pages a chunk,
    by :func:`plan_chunk_pages` unless given) and, for a card, upload the
    tables and the plan in one copy.  The tables keep int32 copies of the
    host tables, so the caller may go on changing its own."""
    bt = _host_ints(block_table, "block_table")
    sl = _host_ints(seq_lens, "seq_lens")
    if bt.ndim != 2 or sl.ndim != 1 or bt.shape[0] != sl.shape[0]:
        raise ValueError(f"block_table {bt.shape} and seq_lens {sl.shape} "
                         f"do not fit one batch")
    batch = sl.shape[0]
    cap = bt.shape[1] * page_size
    if batch and (sl.min() < 1 or sl.max() > cap):
        raise ValueError(f"seq_lens must lie in [1, {cap}] (max_pages x "
                         f"page_size), got {sl.tolist()}")
    used = np.arange(bt.shape[1])[None, :] < -(-sl[:, None] // page_size)
    if np.any(used & ((bt < 0) | (bt >= num_pages))):
        raise ValueError(f"block_table reaches a page outside [0, "
                         f"{num_pages}) within seq_lens")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if chunk_pages is None:
        sms = _sm_count(device.index) if device.type == "cuda" \
            else DEFAULT_SMS
        chunk_pages = plan_chunk_pages(sl, page_size, kv_heads, sms)
    elif chunk_pages < 1:
        raise ValueError(f"chunk_pages must be at least 1, got "
                         f"{chunk_pages}")
    starts = ref.chunk_starts(sl, page_size, chunk_pages)
    dev = None
    if device.type == "cuda":
        items = _items(sl, starts, page_size * chunk_pages)
        flat = to_device(np.concatenate([items.ravel(), starts,
                                         bt.ravel()]), device)
        n = items.size      # items first: the tensor's base is aligned
        dev = (flat[:n].view(-1, 4), flat[n:n + batch + 1],
               flat[n + batch + 1:].view(bt.shape))
    return DecodeTables(bt, sl, page_size, num_pages, kv_heads, chunk_pages,
                        starts, device, dev)


def _items(seq_lens: np.ndarray, starts: np.ndarray,
           chunk_tokens: int) -> np.ndarray:
    """(n_items, 4) int32: each chunk's sequence, first token, end token
    and 1 where it is its sequence's only chunk."""
    n = np.diff(starts)
    seq = np.repeat(np.arange(len(seq_lens)), n)
    j = np.arange(int(starts[-1])) - starts[:-1][seq]
    t0 = j * chunk_tokens
    t1 = np.minimum(t0 + chunk_tokens, seq_lens[seq])
    return np.stack([seq, t0, t1, n[seq] == 1], axis=1).astype(np.int32)


def _check_tensors(q, k_pages, v_pages) -> None:
    """Shapes, types and devices of q and the pages."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no paged-attention kernel for device "
                             f"{t.device}")
    if q.dim() != 3 or not q.is_floating_point():
        raise ValueError(f"q must be a float tensor (batch, q_heads, "
                         f"head_dim), got {tuple(q.shape)} {q.dtype}")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"k_pages and v_pages must be (num_pages, "
                         f"page_size, kv_heads, head_dim) of one shape, got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if k_pages.dtype not in (torch.float32, torch.bfloat16) or \
            v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pages must be float32 or bfloat16, of one type; "
                         f"got {k_pages.dtype} and {v_pages.dtype}")
    if k_pages.device != q.device or v_pages.device != q.device:
        raise ValueError(f"q on {q.device}, pages on {k_pages.device} and "
                         f"{v_pages.device}")
    _, q_heads, head_dim = q.shape
    _, _, kv_heads, hd = k_pages.shape
    if hd != head_dim or kv_heads < 1 or q_heads % kv_heads:
        raise ValueError(f"q heads {q_heads} x {head_dim} do not group over "
                         f"{kv_heads} KV heads x {hd}")


def _check_prepared(tables, q, k_pages) -> None:
    if not isinstance(tables, DecodeTables):
        raise TypeError(f"tables must be a DecodeTables (prepare_tables), "
                        f"got {type(tables)}")
    if tables.device != q.device:
        raise ValueError(f"tables prepared for {tables.device}, q on "
                         f"{q.device}")
    num_pages, page_size, kv_heads, _ = k_pages.shape
    if (tables.num_pages, tables.page_size, tables.kv_heads) != \
            (num_pages, page_size, kv_heads):
        raise ValueError(f"tables prepared for {tables.num_pages} pages of "
                         f"{tables.page_size} tokens x {tables.kv_heads} KV "
                         f"heads, pages are {tuple(k_pages.shape)}")


def _check_card(q, k_pages, v_pages) -> None:
    batch, q_heads, head_dim = q.shape
    kv_heads = k_pages.shape[2]
    if head_dim % HEAD_DIM_STEP or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim a multiple of "
                         f"{HEAD_DIM_STEP} up to {MAX_HEAD_DIM}, got "
                         f"{head_dim}")
    if q_heads // kv_heads > MAX_GROUP:
        raise ValueError(f"the kernel takes up to {MAX_GROUP} query heads "
                         f"per KV head, got {q_heads // kv_heads}")
    if batch > MAX_BATCH or kv_heads > MAX_BATCH:
        raise ValueError(f"batch {batch} or kv_heads {kv_heads} exceeds the "
                         f"kernel's {MAX_BATCH}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table=None,
                           seq_lens=None, *,
                           tables: DecodeTables | None = None
                           ) -> torch.Tensor:
    """q: (batch, q_heads, head_dim) -> (batch, q_heads, head_dim) f32,
    over the host tables ``block_table`` and ``seq_lens`` or over
    ``tables`` prepared for these pages' device and shape."""
    global launches, combine_launches, tokens, plain_calls
    _check_tensors(q, k_pages, v_pages)
    num_pages, page_size, kv_heads, head_dim = k_pages.shape
    if tables is None:
        if block_table is None or seq_lens is None:
            raise TypeError("pass block_table and seq_lens, or tables")
        tables = prepare_tables(block_table, seq_lens, page_size=page_size,
                                num_pages=num_pages, kv_heads=kv_heads,
                                device=q.device)
    elif block_table is not None or seq_lens is not None:
        raise TypeError("pass block_table and seq_lens, or tables, not both")
    else:
        _check_prepared(tables, q, k_pages)
    batch, q_heads, _ = q.shape
    if tables.batch != batch:
        raise ValueError(f"tables of {tables.batch} sequences do not fit "
                         f"batch {batch}")
    if q.device.type == "cpu":
        with _lock:
            plain_calls += 1
        return ref.paged_decode_attention(
            q, k_pages, v_pages, torch.from_numpy(tables.block_table),
            torch.from_numpy(tables.seq_lens))
    _check_card(q, k_pages, v_pages)
    group = q_heads // kv_heads
    qg = q if q.dtype in (torch.float32, torch.bfloat16) else q.float()
    qg = qg.reshape(batch, kv_heads, group, head_dim).contiguous()
    out = torch.empty((batch, kv_heads, group, head_dim),
                      dtype=torch.float32, device=q.device)
    if batch:
        combine = tables.combine
        ws = torch.empty(tables.n_items * kv_heads * group * (head_dim + 2)
                         if combine else 0, dtype=torch.float32,
                         device=q.device)
        kernel.launch(qg, k_pages, v_pages, *tables.dev, out, ws,
                      tables.max_chunks, 1.0 / math.sqrt(head_dim))
        with _lock:
            launches += 1
            combine_launches += combine
            tokens += tables.tokens
            launch_sizes[tables.key] += 1
    return out.reshape(batch, q_heads, head_dim)
