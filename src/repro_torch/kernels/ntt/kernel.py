"""ctypes binding of the NTT, modular-product and fused negacyclic-product
CUDA kernels (``csrc/ntt.cu``).

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
#: torch's current-stream handle of a device index, as an int (what torch's
#: own compiled kernels call), bound when the library is loaded
_raw_stream = None

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; idempotent, thread-safe."""
    global _lib, _built, _raw_stream
    with _lock:
        if _lib is None:
            built = _build.build(LIB_NAME, CSRC)
            lib = ctypes.CDLL(str(built.path))
            for fn in (lib.ntt_forward, lib.ntt_inverse):
                fn.argtypes = [_P, _P, _P, _P, _I, _I, _I64, _P]
                fn.restype = ctypes.c_int
            lib.ntt_mul_mod.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I64,
                                        _P]
            lib.ntt_mul_mod.restype = ctypes.c_int
            lib.ntt_mul.argtypes = [_P, _I, _P]
            lib.ntt_mul.restype = ctypes.c_int
            lib.ntt_error_string.argtypes = [ctypes.c_int]
            lib.ntt_error_string.restype = ctypes.c_char_p
            torch.cuda.init()
            _raw_stream = torch._C._cuda_getCurrentRawStream
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
    """The raw handle of the current stream of ``t``'s device, read anew at
    every call (a caller may switch streams), without building a
    ``torch.cuda.Stream``."""
    return _raw_stream(t.device.index)


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
                   b_rows: int, rows: int) -> None:
    lib = library()
    _check(lib, lib.ntt_mul_mod(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                consts.data_ptr(), n_primes, logn, b_rows,
                                rows, _stream(a)), "mul_mod launch")


def launch_mul(desc: int, logn: int, device: int) -> None:
    """The fused product on ``device``'s current stream; ``desc`` is the
    address of the job's descriptor as ``parse_job`` in
    ``csrc/ntt_sched.cuh`` reads it (``ops.ntt_mul`` builds it)."""
    lib = library()
    _check(lib, lib.ntt_mul(desc, logn, _raw_stream(device)),
           "ntt_mul launch")


# ---------------------------------------------------------------------------
# the fused kernel's shared memory (csrc/ntt_sched.cuh, MulThread), which
# the wrapper checks before a launch on either device
# ---------------------------------------------------------------------------

#: the dynamic shared memory one CTA may take (H100: 227 KiB, less 1 KiB
#: for the kernel's own)
MUL_MAX_SMEM = 232448 - 1024
#: the job's limits (ntt_sched.cuh: kMulMaxIn, kMulMaxTerms, kMulMaxOut,
#: kMulMaxTeams)
MUL_MAX_IN, MUL_MAX_TERMS, MUL_MAX_OUT, MUL_MAX_TEAMS = 16, 32, 16, 8


def mul_smem_bytes(logn: int, n_coef: int, n_ntt: int,
                   stage: bool) -> int:
    """Shared memory of one CTA of a fused cluster
    (``MulThread::smem_bytes``): the exchange buffers (none below N = 16,
    where a row is one pass), the inverse's twiddle table (up to
    N = 4096), the NTT-domain operands if staged, every transformed
    coefficient row."""
    n = 1 << logn
    exchange = 2 * n if logn > 3 else 0
    tw = 2 * n if logn <= 12 else 0
    return 4 * (exchange + tw + (2 * n * n_ntt if stage else 0) +
                n * n_coef)


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


#: a modular add (add_mod: add, the corrected value, minimum)
ADD_MOD_OPS = 3


def ntt_mul_ops(n_coef: int, n_terms: int, n_out: int, ctas: int,
                n: int) -> int:
    """The fused launch: per CTA (a group's prime) n_coef forward
    transforms, n_terms products, n_terms - n_out modular adds (each
    output sums its terms) and n_out inverse transforms."""
    return ctas * (transform_ops(n_coef, n, False) +
                   mul_mod_ops(n_terms, n) +
                   (n_terms - n_out) * n * ADD_MOD_OPS +
                   transform_ops(n_out, n, True))


def ntt_mul_bytes(n_in: int, n_out: int, ctas: int, n: int,
                  n_primes: int) -> int:
    """Operand rows in (int64), output rows out, and each prime's twiddle
    tables for both directions and its constants once."""
    return ctas * (n_in + n_out) * n * 8 + \
        n_primes * (2 * 2 * n * 4 + PRIME_CONST_BYTES)
