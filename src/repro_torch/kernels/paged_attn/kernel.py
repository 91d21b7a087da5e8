"""ctypes binding of the paged decode-attention CUDA kernels
(``csrc/paged_attn.cu``: the split kernel and the combine kernel).

The library is built from the sources in the checkout on first use (see
``kernels/_build.py``) and loaded once per process.  The launch function
takes raw tensors and does no checking: ``ops.py`` validates.

The work figures at the bottom feed the roofline bound that
``chip_smoke.py`` reports beside the measured kernel times.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .. import _build

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "repro_torch_paged_attn"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_built: _build.Built | None = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel; idempotent, thread-safe."""
    global _lib, _built
    with _lock:
        if _lib is None:
            built = _build.build(LIB_NAME, CSRC)
            lib = ctypes.CDLL(str(built.path))
            for fn in (lib.paged_attn_f32, lib.paged_attn_bf16):
                fn.argtypes = [_P] * 8 + [_I] * 9 + [_F, _P]
                fn.restype = ctypes.c_int
            lib.paged_attn_error_string.argtypes = [ctypes.c_int]
            lib.paged_attn_error_string.restype = ctypes.c_char_p
            torch.cuda.init()
            _lib, _built = lib, built
        return _lib


def build_info() -> _build.Built:
    """Where the library came from and what the compiler said."""
    library()
    return _built


def launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           items: torch.Tensor, chunk_start: torch.Tensor,
           block_table: torch.Tensor, out: torch.Tensor, ws: torch.Tensor,
           max_chunks: int, scale: float) -> None:
    """q: (batch, kv_heads, group, head_dim) float32 or bfloat16; out the
    same shape in float32; pages (num_pages, page_size, kv_heads, head_dim)
    float32 or bfloat16; the split plan's int32 tables (items (n_items, 4):
    sequence, first token, end token, 1 if the sequence's only chunk, 16-
    byte aligned; chunk_start (batch + 1,); block_table (batch,
    max_pages)); ws float32, n_items x kv_heads x group x (head_dim + 2)
    where max_chunks (the most chunks of one sequence) exceeds 1, all on
    one card.  Launches the split kernel, then, where max_chunks > 1, the
    combine kernel."""
    lib = library()
    batch, kv_heads, group, head_dim = q.shape
    fn = lib.paged_attn_bf16 if k_pages.dtype == torch.bfloat16 \
        else lib.paged_attn_f32
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             items.data_ptr(), chunk_start.data_ptr(),
             block_table.data_ptr(), out.data_ptr(), ws.data_ptr(), batch,
             kv_heads, group, head_dim, k_pages.shape[1],
             block_table.shape[1], items.shape[0], max_chunks,
             int(q.dtype == torch.bfloat16), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA error in paged_attn launch: "
                           f"{lib.paged_attn_error_string(err).decode()} "
                           f"({err})")


# ---------------------------------------------------------------------------
# the work of one launch, for the roofline bound: the bytes the function
# must move (q read once, the first seq_len tokens of K and V of every KV
# head read once, the block-table entries it uses and the lengths read once,
# the output written once), and its floating-point operations (two products
# of group rows against every key, an exp per score).
# ---------------------------------------------------------------------------


def work_bytes(seq_lens, kv_heads: int, group: int, head_dim: int,
               page_size: int, elem: int) -> int:
    tokens = sum(int(s) for s in seq_lens)
    pages = sum(-(-int(s) // page_size) for s in seq_lens)
    qo = 2 * len(seq_lens) * kv_heads * group * head_dim * 4
    return tokens * kv_heads * head_dim * 2 * elem + qo + 4 * (
        pages + len(seq_lens))


def work_flops(seq_lens, kv_heads: int, group: int, head_dim: int) -> int:
    tokens = sum(int(s) for s in seq_lens)
    return tokens * kv_heads * group * (4 * head_dim + 1)
