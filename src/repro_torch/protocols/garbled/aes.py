"""Fixed-key AES-128 for half-gates garbling, as plain PyTorch.

The same gate hash as the JAX package's NumPy gates:

    H(x, i) = AES_k(sigma(x) XOR i) XOR sigma(x) XOR i,   sigma(x) = 2*x

with 2*x the doubling in GF(2^128) (x^128 + x^7 + x^2 + x + 1), the tweak
``i`` XORed into the low 64 bits, and the fixed public key 00 01 .. 0f.

Labels are ``(n, 2)`` int64 tensors: the bit patterns of the uint64 pairs
(little-endian lanes), because torch lacks shifts and comparisons on
uint64.  This module is the plain version the CPU path and the tests run;
on the card the CUDA kernels (``kernels/garble``) compute the same hash.
The tables below are computed here, not imported, so the port stands alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _build_sbox() -> np.ndarray:
    # GF(2^8) inverse via log/antilog tables (generator 3)
    exp = np.zeros(256, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= ((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF  # x *= 3
    inv = np.zeros(256, dtype=np.uint8)
    for a in range(1, 256):
        inv[a] = exp[(255 - log[a]) % 255]
    s = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        b = int(inv[a])
        res = 0x63
        for sh in range(5):
            res ^= ((b << sh) | (b >> (8 - sh))) & 0xFF
        s[a] = res
    return s


SBOX = _build_sbox()

# ShiftRows on the column-major AES state: byte i sits at row i%4, col i//4
SHIFT_ROWS = np.array([(i + 4 * (i % 4)) % 16 for i in range(16)],
                      dtype=np.int64)

FIXED_KEY = np.frombuffer(bytes(range(16)), dtype=np.uint8).copy()

RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10,
                 0x20, 0x40, 0x80, 0x1B, 0x36], dtype=np.uint8)


def key_schedule(key: np.ndarray = FIXED_KEY) -> np.ndarray:
    """The 11 round keys as an (11, 16) uint8 array."""
    w = [key[4 * i:4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = SBOX[t]
            t[0] ^= RCON[i // 4 - 1]
        w.append(w[i - 4] ^ t)
    return np.concatenate(w).reshape(11, 16)


ROUND_KEYS = key_schedule()


def round_key_words() -> np.ndarray:
    """The round keys as 44 little-endian uint32 column words: the layout
    the CUDA kernels keep in constant memory."""
    return np.ascontiguousarray(ROUND_KEYS).view("<u4").reshape(44).copy()


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    xtime = np.array([((x << 1) ^ (0x1B if x & 0x80 else 0)) & 0xFF
                      for x in range(256)], dtype=np.int64)
    as_t = functools.partial(torch.as_tensor, device=device)
    return (as_t(SBOX.astype(np.int64)), as_t(xtime),
            as_t(ROUND_KEYS.astype(np.int64)), as_t(SHIFT_ROWS),
            as_t(np.array([[(r + k) % 4 for r in range(4)]
                           for k in (1, 2, 3)], dtype=np.int64)),
            torch.arange(0, 64, 8, dtype=torch.int64, device=device))


def aes128_encrypt_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """AES-128 under the fixed key: (n, 16) int64 byte values -> (n, 16).
    A plain version: SubBytes and xtime are table lookups here."""
    sbox, xtime, rk, shift_rows, rot, _ = _tables(blocks.device)
    s = blocks ^ rk[0]
    for rnd in range(1, 10):
        # SubBytes + ShiftRows, then MixColumns on the columns (rows of v):
        # out[r] = 2 v[r] ^ 3 v[r+1] ^ v[r+2] ^ v[r+3]
        v = torch.take(sbox, s.index_select(1, shift_rows)).view(-1, 4, 4)
        r1, r2, r3 = (v.index_select(2, rot[k]) for k in range(3))
        s = (torch.take(xtime, v ^ r1) ^ r1 ^ r2 ^ r3).view(-1, 16) \
            ^ rk[rnd]
    return torch.take(sbox, s.index_select(1, shift_rows)) ^ rk[10]


def labels_to_blocks(lbl: torch.Tensor) -> torch.Tensor:
    """(n, 2) int64 labels -> (n, 16) int64 little-endian byte values."""
    shifts = _tables(lbl.device)[5]
    return ((lbl[:, :, None] >> shifts) & 0xFF).reshape(-1, 16)


def blocks_to_labels(blk: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`labels_to_blocks`.  The shifted bytes occupy
    disjoint bits, so their wrapping int64 sum is their OR."""
    shifts = _tables(blk.device)[5]
    return (blk.view(-1, 2, 8) << shifts).sum(dim=2)


def gf128_double(lbl: torch.Tensor) -> torch.Tensor:
    """x -> 2*x in GF(2^128) on (n, 2) int64 labels."""
    lo, hi = lbl[:, 0], lbl[:, 1]
    carry = (hi >> 63) & 1
    nhi = (hi << 1) | ((lo >> 63) & 1)
    nlo = (lo << 1) ^ (carry * 0x87)
    return torch.stack([nlo, nhi], dim=1)


def hash_labels(lbl: torch.Tensor, gate_ids: torch.Tensor) -> torch.Tensor:
    """H(x, i) = AES_k(2x ^ i) ^ 2x ^ i over (n, 2) labels; ``gate_ids``
    is (n,) int64, XORed into the low word."""
    y = gf128_double(lbl)
    y[:, 0] ^= gate_ids
    return blocks_to_labels(aes128_encrypt_blocks(labels_to_blocks(y))) ^ y
