"""ctypes binding of the half-gates CUDA kernels (``csrc/garble.cu``).

The library is built from the sources in the checkout on first use (see
``kernels/_build.py``) and loaded once per process; loading also copies
the fixed key's round keys into the kernels' constant memory.  The launch
functions take raw tensors and do no checking: ``ops.py`` validates.

The per-gate work figures at the bottom feed the roofline bound that
``chip_smoke.py`` reports beside the measured kernel times.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ...protocols.garbled.aes import ROUND_KEYS

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "repro_torch_garble"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_built: _build.Built | None = None

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; idempotent, thread-safe."""
    global _lib, _built
    with _lock:
        if _lib is None:
            built = _build.build(LIB_NAME, CSRC)
            lib = ctypes.CDLL(str(built.path))
            lib.gc_set_round_keys.argtypes = [_P]
            lib.gc_set_round_keys.restype = ctypes.c_int
            lib.gc_garble_and.argtypes = [_P, _P, _U64, _U64, _U64, _P, _P,
                                          _I64, _P]
            lib.gc_garble_and.restype = ctypes.c_int
            lib.gc_eval_and.argtypes = [_P, _P, _P, _U64, _P, _I64, _P]
            lib.gc_eval_and.restype = ctypes.c_int
            lib.gc_error_string.argtypes = [ctypes.c_int]
            lib.gc_error_string.restype = ctypes.c_char_p
            torch.cuda.init()
            rk = round_key_planes()
            _check(lib, lib.gc_set_round_keys(rk.ctypes.data), "round keys")
            _lib, _built = lib, built
        return _lib


def round_key_planes() -> np.ndarray:
    """The fixed key's 11 round keys bitsliced as the kernels keep them in
    constant memory: (11 * 8,) uint32, plane b of round r holding bit b of
    round-key byte i at bits i and 16 + i."""
    bits = (ROUND_KEYS[:, None, :] >> np.arange(8)[None, :, None]) & 1
    planes = (bits.astype(np.uint32) << np.arange(16, dtype=np.uint32)
              ).sum(axis=2, dtype=np.uint32)
    return np.ascontiguousarray((planes | (planes << 16)).reshape(88))


def build_info() -> _build.Built:
    """Where the library came from and what the compiler said."""
    library()
    return _built


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error in {what}: "
                           f"{lib.gc_error_string(err).decode()} ({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_garble(a: torch.Tensor, b: torch.Tensor, r_lo: int, r_hi: int,
                  gid0: int, c: torch.Tensor, tab: torch.Tensor) -> None:
    lib = library()
    _check(lib, lib.gc_garble_and(a.data_ptr(), b.data_ptr(), r_lo, r_hi,
                                  gid0, c.data_ptr(), tab.data_ptr(),
                                  a.shape[0], _stream(a)), "garble_and launch")


def launch_eval(wa: torch.Tensor, wb: torch.Tensor, tab: torch.Tensor,
                gid0: int, c: torch.Tensor) -> None:
    lib = library()
    _check(lib, lib.gc_eval_and(wa.data_ptr(), wb.data_ptr(), tab.data_ptr(),
                                gid0, c.data_ptr(), wa.shape[0],
                                _stream(wa)), "eval_and launch")


# ---------------------------------------------------------------------------
# the least work per gate, for the roofline bound.  The best known AES-128
# circuits in two-input boolean gates: SubBytes 16 x 113 (Boyar-Peralta's
# smallest; the kernels run their 128-gate depth-16 circuit), MixColumns
# 4 x 92 XORs (Maximov), AddRoundKey 128; the hash adds the doubling-and-
# tweak and output XORs (2 x 128 per hash), the half gates their XORs.
# The card's logic operation is LOP3: any boolean function of three inputs
# on 32 bit lanes in one instruction, so at best it does the work of a
# two-gate tree (an XOR3, or an AND feeding an XOR).  The counts below are
# in those 3-input operations, 32 lanes each: half the two-input gates,
# over 32.
# ---------------------------------------------------------------------------

AES128_GATES = 10 * 16 * 113 + 9 * 4 * 92 + 11 * 128
_HASH_GATES = AES128_GATES + 2 * 128
#: 32-bit 3-input logic operations per AND gate, at least
GARBLE_LOP3_PER_AND = (4 * _HASH_GATES + 6 * 128) / 2 / 32
EVAL_LOP3_PER_AND = (2 * _HASH_GATES + 4 * 128) / 2 / 32
#: bytes a gate must move: each input read once, each output written once
GARBLE_BYTES_PER_AND = 16 + 16 + 16 + 32      # a, b in; c, [TG|TE] out
EVAL_BYTES_PER_AND = 16 + 16 + 32 + 16        # wa, wb, table in; c out
