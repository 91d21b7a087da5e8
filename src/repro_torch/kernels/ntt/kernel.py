"""ctypes binding of the NTT and modular-product CUDA kernels
(``csrc/ntt.cu``).

The library is built from the sources in the checkout on first use (see
``kernels/_build.py``) and loaded once per process.  The launch functions
take raw tensors and do no checking: ``ops.py`` validates.

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
LIB_NAME = "repro_torch_ntt"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_built: _build.Built | None = None

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; idempotent, thread-safe."""
    global _lib, _built
    with _lock:
        if _lib is None:
            built = _build.build(LIB_NAME, CSRC)
            lib = ctypes.CDLL(str(built.path))
            for fn in (lib.ntt_forward, lib.ntt_inverse):
                fn.argtypes = [_P, _P, _P, _P, _I, _I, _I64, _P]
                fn.restype = ctypes.c_int
            lib.ntt_mul_mod.argtypes = [_P, _P, _P, _P, _I, _I, _I64, _P]
            lib.ntt_mul_mod.restype = ctypes.c_int
            lib.ntt_error_string.argtypes = [ctypes.c_int]
            lib.ntt_error_string.restype = ctypes.c_char_p
            torch.cuda.init()
            _lib, _built = lib, built
        return _lib


def build_info() -> _build.Built:
    """Where the library came from and what the compiler said."""
    library()
    return _built


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error in {what}: "
                           f"{lib.ntt_error_string(err).decode()} ({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_transform(inverse: bool, a: torch.Tensor, out: torch.Tensor,
                     tw: torch.Tensor, consts: torch.Tensor, n_primes: int,
                     logn: int, rows: int) -> None:
    lib = library()
    fn = lib.ntt_inverse if inverse else lib.ntt_forward
    _check(lib, fn(a.data_ptr(), out.data_ptr(), tw.data_ptr(),
                   consts.data_ptr(), n_primes, logn, rows, _stream(a)),
           "ntt_inverse launch" if inverse else "ntt_forward launch")


def launch_mul_mod(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                   consts: torch.Tensor, n_primes: int, logn: int,
                   rows: int) -> None:
    lib = library()
    _check(lib, lib.ntt_mul_mod(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                consts.data_ptr(), n_primes, logn, rows,
                                _stream(a)), "mul_mod launch")


# ---------------------------------------------------------------------------
# the work of one launch, for the roofline bound: 32-bit integer operations
# as csrc/ntt_arith.cuh counts them, and the bytes the function must move
# (each input read once, each output written once: int64 rows in and out,
# each prime's twiddle table for the direction and its constants once).
# ---------------------------------------------------------------------------

BUTTERFLY_OPS = 11
SHOUP_MUL_OPS = 5
MUL_MOD_OPS = 14
PRIME_CONST_BYTES = 32


def transform_ops(rows: int, n: int, inverse: bool) -> int:
    per_row = n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS
    if inverse:
        per_row += n * SHOUP_MUL_OPS       # the final x N^-1
    return rows * per_row


def transform_bytes(rows: int, n: int, n_primes: int) -> int:
    return rows * n * 16 + n_primes * (2 * n * 4 + PRIME_CONST_BYTES)


def mul_mod_ops(rows: int, n: int) -> int:
    return rows * n * MUL_MOD_OPS


def mul_mod_bytes(rows: int, n: int, n_primes: int) -> int:
    return rows * n * 24 + n_primes * PRIME_CONST_BYTES
