"""The paged decode-attention wrapper the model layer calls, with launch
counters (``repro.kernels.paged_attn.ops``).

``paged_decode_attention(q, k_pages, v_pages, block_table, seq_lens)`` takes
q (batch, q_heads, head_dim) in any float type and K/V pages (num_pages,
page_size, kv_heads, head_dim) in float32 or bfloat16, and returns (batch,
q_heads, head_dim) float32.  It does the reference's GQA reshape: q becomes
(batch, kv_heads, group, head_dim) float32, as the Pallas kernel casts it.

The block table (batch, max_pages) and the lengths (batch,) are host data
(NumPy arrays or CPU tensors, as ``serve.paged_kv.PagedKVCache`` keeps
them): the wrapper checks their values on the host before any pointer
reaches the kernel (every length in [1, max_pages * page_size], every page
the lengths reach inside [0, num_pages)), then moves them to the card in one
copy.  The Pallas kernel returns the mean of V for a length of 0 and the
jnp oracle NaN; here a length of 0 raises.

On a CUDA tensor the wrapper launches the kernel on the current stream (no
synchronisation, the output allocated here); on a CPU tensor it runs the
plain version in ``ref.py``; on anything else it raises.  The counters count
kernel launches, the tokens of K/V they read (summed lengths) and each
launch's lengths, and, apart, the calls that ran the plain version.
"""

from __future__ import annotations

import math
import threading
from collections import Counter

import numpy as np
import torch

from .. import to_device
from . import kernel, ref

#: what the kernel takes: head_dim a multiple of 32 up to 256 (one to eight
#: elements a lane), batch up to the grid's y extent
MAX_HEAD_DIM = 256
MAX_BATCH = 65535

_lock = threading.Lock()
launches = 0
tokens = 0
plain_calls = 0
launch_sizes: Counter = Counter()     # tuple(seq_lens) -> launches


def reset_counts() -> None:
    global launches, tokens, plain_calls
    with _lock:
        launches = tokens = plain_calls = 0
        launch_sizes.clear()


def counts() -> dict:
    with _lock:
        return {"launches": launches, "tokens": tokens,
                "plain_calls": plain_calls,
                "launch_sizes": dict(launch_sizes)}


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


def _check(q, k_pages, v_pages, block_table, seq_lens):
    """Shapes, types, devices and the tables' values; returns the tables as
    int32 host arrays."""
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
    batch, q_heads, head_dim = q.shape
    num_pages, page_size, kv_heads, hd = k_pages.shape
    if hd != head_dim or kv_heads < 1 or q_heads % kv_heads:
        raise ValueError(f"q heads {q_heads} x {head_dim} do not group over "
                         f"{kv_heads} KV heads x {hd}")
    bt = _host_ints(block_table, "block_table")
    sl = _host_ints(seq_lens, "seq_lens")
    if bt.ndim != 2 or bt.shape[0] != batch or sl.shape != (batch,):
        raise ValueError(f"block_table {bt.shape} and seq_lens {sl.shape} "
                         f"do not fit batch {batch}")
    cap = bt.shape[1] * page_size
    if batch and (sl.min() < 1 or sl.max() > cap):
        raise ValueError(f"seq_lens must lie in [1, {cap}] (max_pages x "
                         f"page_size), got {sl.tolist()}")
    used = np.arange(bt.shape[1])[None, :] < -(-sl[:, None] // page_size)
    if np.any(used & ((bt < 0) | (bt >= num_pages))):
        raise ValueError(f"block_table reaches a page outside [0, "
                         f"{num_pages}) within seq_lens")
    return bt, sl


def _check_card(q, k_pages, v_pages) -> None:
    batch, _, head_dim = q.shape
    if head_dim % 32 or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim a multiple of 32 up to "
                         f"{MAX_HEAD_DIM}, got {head_dim}")
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch} exceeds the kernel's {MAX_BATCH}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table,
                           seq_lens) -> torch.Tensor:
    """q: (batch, q_heads, head_dim) -> (batch, q_heads, head_dim) f32."""
    global launches, tokens, plain_calls
    bt, sl = _check(q, k_pages, v_pages, block_table, seq_lens)
    if q.device.type == "cpu":
        with _lock:
            plain_calls += 1
        return ref.paged_decode_attention(q, k_pages, v_pages,
                                          torch.from_numpy(bt),
                                          torch.from_numpy(sl))
    _check_card(q, k_pages, v_pages)
    batch, q_heads, head_dim = q.shape
    kv_heads = k_pages.shape[2]
    qg = q.float().reshape(batch, kv_heads, q_heads // kv_heads,
                           head_dim).contiguous()
    out = torch.empty_like(qg)
    if batch:
        tables = to_device(np.concatenate([sl, bt.ravel()]), q.device)
        kernel.launch(qg, k_pages, v_pages, tables[batch:].view(bt.shape),
                      tables[:batch], out, 1.0 / math.sqrt(head_dim))
        with _lock:
            launches += 1
            tokens += int(sl.sum())
            launch_sizes[tuple(sl.tolist())] += 1
    return out.reshape(batch, q_heads, head_dim)
