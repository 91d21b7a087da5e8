"""ctypes binding of the half-gates CUDA kernels (``csrc/garble.cu``).

The library is built from the sources in the checkout on first use (see
``kernels/_build.py``) and loaded once per process; loading also hands
the library the fixed key's round keys, which every launch passes as a
kernel parameter, and binds the launch functions, so that a launch after
the first takes no lock.  The
launch functions take addresses and do no checking: ``ops.py``
validates.

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
#: the S-box's affine constant, which the kernels add with the round keys
SBOX_CONSTANT = 0x63
LIB_NAME = "repro_torch_garble"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_built: _build.Built | None = None
# bound at load: gc_garble_and, gc_eval_and, and the current raw stream of
# a device index
_garble = _eval = _raw_stream = None

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; idempotent, thread-safe."""
    global _lib, _built, _garble, _eval, _raw_stream
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
            lib.gc_empty.argtypes = [_P]
            lib.gc_empty.restype = ctypes.c_int
            lib.gc_error_string.argtypes = [ctypes.c_int]
            lib.gc_error_string.restype = ctypes.c_char_p
            torch.cuda.init()
            rk = round_key_planes()
            _check(lib, lib.gc_set_round_keys(rk.ctypes.data), "round keys")
            # the current stream's handle as an int, without building a
            # torch.cuda.Stream (what torch's own compiled kernels call)
            _raw_stream = torch._C._cuda_getCurrentRawStream
            _garble, _eval = lib.gc_garble_and, lib.gc_eval_and
            _lib, _built = lib, built
        return _lib


def round_key_planes() -> np.ndarray:
    """The fixed key's 11 round keys bitsliced as the kernels take them:
    (11 * 8,) uint32.  Plane k of round i holds bit k of
    the round key's byte (row r, column c - i*r mod 4), the rows rotated as
    the fixsliced state is after round i (``csrc/aes_ct.cuh``), at bits
    8r + c and 8r + 4 + c (one copy for each of the two blocks); from
    round 1 on XORed with 0x63 in every byte, the constant that the
    kernels' S-box leaves out."""
    rnd = np.arange(11)[:, None, None]
    col = np.arange(4)[None, :, None]
    row = np.arange(4)[None, None, :]
    keys = ROUND_KEYS.reshape(11, 4, 4)                  # [round, col, row]
    rot = keys[rnd, (col - rnd * row) % 4, row]
    bits = (rot[:, None] >> np.arange(8)[None, :, None, None]) & 1
    pos = (8 * row + col).astype(np.uint32)[None]
    planes = (bits.astype(np.uint32) << pos).sum(axis=(2, 3),
                                                 dtype=np.uint32)
    planes |= planes << 4
    # rounds 1-10 also add the S-box's affine constant to every byte
    planes[1:] ^= ((SBOX_CONSTANT >> np.arange(8)) & 1).astype(np.uint32) \
        * np.uint32(0xFFFFFFFF)
    return np.ascontiguousarray(planes.reshape(88))


def build_info() -> _build.Built:
    """Where the library came from and what the compiler said."""
    library()
    return _built


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error in {what}: "
                           f"{lib.gc_error_string(err).decode()} ({err})")


def launch_garble(a: int, b: int, r_lo: int, r_hi: int, gid0: int, c: int,
                  tab: int, m: int, device: int) -> None:
    """Launch on ``device``'s current stream; a, b, c and tab are the
    tensors' addresses."""
    if _garble is None:
        library()
    err = _garble(a, b, r_lo, r_hi, gid0, c, tab, m, _raw_stream(device))
    if err:
        _check(_lib, err, "garble_and launch")


def launch_eval(wa: int, wb: int, tab: int, gid0: int, c: int, m: int,
                device: int) -> None:
    if _eval is None:
        library()
    err = _eval(wa, wb, tab, gid0, c, m, _raw_stream(device))
    if err:
        _check(_lib, err, "eval_and launch")


def launch_empty(device: torch.device) -> None:
    """One launch of a kernel that does nothing: the floor under a launch's
    device time, which ``chip_smoke.py`` reports beside the kernels'."""
    lib = library()
    _check(lib, lib.gc_empty(_raw_stream(device.index or 0)), "empty launch")


# ---------------------------------------------------------------------------
# the least work per gate, for the roofline bound.  The best known AES-128
# circuits in two-input boolean gates: SubBytes 16 x 113 (Boyar-Peralta's
# smallest; the kernels run their 128-gate depth-16 circuit as 82 LOP3s,
# csrc/aes_ct.cuh), MixColumns 4 x 92 XORs (Maximov), AddRoundKey 128; the
# hash adds the doubling-and-tweak and output XORs (2 x 128 per hash), the
# half gates their XORs.
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
