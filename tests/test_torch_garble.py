"""The port's half gates against the JAX package's: the plain PyTorch
versions (which the CPU path runs) against the Pallas kernels in interpret
mode, the jnp oracle and the NumPy gates; the CUDA source's arithmetic,
built for the host; and the wrappers' checks.  Every comparison is bitwise.
"""

import ctypes
import importlib.util
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro.kernels.garble import ops as jops
from repro.protocols.garbled import aes as npaes
from repro.protocols.garbled.gates import (EvaluatorGates as NpEvaluator,
                                           GarblerGates as NpGarbler,
                                           PartyChannel as NpChannel)
from repro_torch.kernels.garble import kernel as tkernel
from repro_torch.kernels.garble import ops as tops
from repro_torch.kernels.garble import ref as tref
from repro_torch.protocols.garbled import aes as taes

GIDS = [0, (1 << 31) + 5, 1 << 40]


def _t(x: np.ndarray) -> torch.Tensor:
    """uint64 labels -> the port's int64 bit views."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64).copy())


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _labels(rng, m):
    a = rng.integers(0, 2**63, (m, 2), dtype=np.uint64)
    b = rng.integers(0, 2**63, (m, 2), dtype=np.uint64)
    r = rng.integers(0, 2**63, 2, dtype=np.uint64)
    r[0] |= 1
    return a, b, r


# ---------------------------------------------------------------------------
# AES and the gate hash
# ---------------------------------------------------------------------------


def test_aes_matches_numpy_and_fips197():
    rng = np.random.default_rng(0)
    blk = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    got = taes.aes128_encrypt_blocks(torch.from_numpy(blk.astype(np.int64)))
    assert np.array_equal(got.numpy().astype(np.uint8),
                          npaes.aes128_encrypt_blocks(blk))
    assert np.array_equal(taes.ROUND_KEYS, npaes.ROUND_KEYS)
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       dtype=np.uint8).astype(np.int64)[None]
    ct = taes.aes128_encrypt_blocks(torch.from_numpy(pt))
    assert bytes(ct.numpy().astype(np.uint8)[0]).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("gid0", GIDS)
def test_hash_labels_matches_numpy(gid0):
    rng = np.random.default_rng(gid0 % 97)
    x = rng.integers(0, 2**63, (33, 2), dtype=np.uint64)
    ids = gid0 + np.arange(33, dtype=np.int64)
    got = taes.hash_labels(_t(x), torch.from_numpy(ids))
    assert np.array_equal(_u(got), npaes.hash_labels(x, ids))


# ---------------------------------------------------------------------------
# half gates: plain versions against the JAX package
# ---------------------------------------------------------------------------


def test_garble_eval_match_pallas_interpret_and_jnp_ref():
    """gid0 < 2^30, where the Pallas path's int32 tweak is exact; one
    shape, so the interpreted kernels compile once."""
    m = 37
    a, b, r = _labels(np.random.default_rng(m), m)
    for gid0 in (0, 5, 1 << 20):
        c_k, t_k = jops.garble_and(a, b, r, gid0, interpret=True, block_m=64)
        c_j, t_j = jops.garble_and(a, b, r, gid0, use_kernel=False)
        c, tab = tref.garble_and(_t(a), _t(b), _t(r), gid0)
        for want_c, want_t in ((c_k, t_k), (c_j, t_j)):
            assert np.array_equal(_u(c), want_c)
            assert np.array_equal(_u(tab), want_t)
        wa, wb = a ^ r[None], b
        w_k = jops.eval_and(wa, wb, t_k, gid0, interpret=True, block_m=64)
        w = tref.eval_and(_t(wa), _t(wb), tab, gid0)
        assert np.array_equal(_u(w), w_k)


@pytest.mark.parametrize("gid0", GIDS)
def test_half_gates_match_numpy_gates(gid0):
    """The NumPy gates carry the full 64-bit tweak; so does the port."""
    ch = NpChannel()
    g = NpGarbler(ch, seed=9)
    e = NpEvaluator(ch)
    g.gid = e.gid = gid0
    m = 40
    A, B = g._fresh(m), g._fresh(m)
    C = g.and_(A.copy(), B.copy())
    tab = ch.recv("tab")
    c, t = tops.garble_and(_t(A), _t(B), tops.offset(g.R), gid0)
    assert np.array_equal(_u(c), C) and np.array_equal(_u(t), tab)
    wa, wb = A ^ g.R[None], B ^ g.R[None]
    ch.send("tab", tab)
    assert np.array_equal(_u(tops.eval_and(_t(wa), _t(wb), t, gid0)),
                          e.and_(wa, wb))


@pytest.mark.parametrize("bit_a,bit_b", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_truth_table(bit_a, bit_b):
    a, b, r = _labels(np.random.default_rng(bit_a * 2 + bit_b), 32)
    c0, tab = tops.garble_and(_t(a), _t(b), tops.offset(r), 0)
    wa = a ^ (r[None] * np.uint64(bit_a))
    wb = b ^ (r[None] * np.uint64(bit_b))
    wc = tops.eval_and(_t(wa), _t(wb), tab, 0)
    assert np.array_equal(_u(wc), _u(c0) ^ (r[None] * np.uint64(bit_a & bit_b)))


@pytest.mark.parametrize("m", [0, 1, 37])
def test_odd_batch_all_rows(m):
    a, b, r = _labels(np.random.default_rng(m), m)
    c0, tab = tops.garble_and(_t(a), _t(b), tops.offset(r), 5)
    assert tuple(c0.shape) == (m, 2) and tuple(tab.shape) == (m, 4)
    for bit_a in (0, 1):
        for bit_b in (0, 1):
            wa = a ^ (r[None] * np.uint64(bit_a))
            wb = b ^ (r[None] * np.uint64(bit_b))
            wc = tops.eval_and(_t(wa), _t(wb), tab, 5)
            assert np.array_equal(
                _u(wc), _u(c0) ^ (r[None] * np.uint64(bit_a & bit_b)))


def test_cpu_path_launches_no_kernel():
    tops.reset_counts()
    a, b, r = _labels(np.random.default_rng(1), 8)
    c, tab = tops.garble_and(_t(a), _t(b), tops.offset(r), 0)
    tops.eval_and(_t(a), _t(b), tab, 0)
    got = tops.counts()
    assert got["garble_launches"] == got["eval_launches"] == 0
    assert got["garble_ands"] == got["eval_ands"] == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device",
                                 "gid"])
def test_wrappers_reject_bad_input(bad):
    a, b, r = _labels(np.random.default_rng(2), 8)
    ta, tb, gid = _t(a), _t(b), 0
    if bad == "dtype":
        ta = ta.to(torch.int32)
    elif bad == "shape":
        ta = ta[:, :1]
    elif bad == "strided":
        ta = torch.cat([ta, ta], dim=1)[:, ::2]
    elif bad == "device":
        ta, tb = ta.to("meta"), tb.to("meta")
    else:
        gid = -1
    with pytest.raises((TypeError, ValueError)):
        tops.garble_and(ta, tb, tops.offset(r), gid)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device",
                                 "gid", "tab"])
def test_eval_rejects_bad_input(bad):
    """eval_and keeps every check garble_and has, and checks the table."""
    a, b, r = _labels(np.random.default_rng(3), 8)
    ta, tb, gid = _t(a), _t(b), 0
    _, tab = tops.garble_and(ta, tb, tops.offset(r), 0)
    if bad == "dtype":
        ta = ta.to(torch.int32)
    elif bad == "shape":
        ta = ta[:, :1]
    elif bad == "strided":
        ta = torch.cat([ta, ta], dim=1)[:, ::2]
    elif bad == "device":
        ta, tb, tab = ta.to("meta"), tb.to("meta"), tab.to("meta")
    elif bad == "gid":
        gid = (1 << 62) - 4
    else:
        tab = tab[:, :2]
    with pytest.raises((TypeError, ValueError)):
        tops.eval_and(ta, tb, tab, gid)


@pytest.mark.parametrize("bad", [
    "array", "floats", "negative", "too_wide", "three_words"])
def test_garble_takes_r_as_two_ints(bad):
    """R crosses as (lo, hi) Python ints; anything else is refused, and
    offset() gives the pair from the NumPy R."""
    a, b, r = _labels(np.random.default_rng(4), 8)
    lo, hi = tops.offset(r)
    assert (lo, hi) == (int(r[0]), int(r[1]))
    assert all(type(w) is int for w in (lo, hi))
    r_bad = {"array": r, "floats": (float(lo), float(hi)),
             "negative": (-1, hi), "too_wide": (lo, 1 << 64),
             "three_words": (lo, hi, 0)}[bad]
    with pytest.raises((TypeError, ValueError)):
        tops.garble_and(_t(a), _t(b), r_bad, 0)


@pytest.mark.parametrize("m", [1, 16, 37])
def test_garble_outputs_share_one_buffer(m):
    """The card path's outputs: c (m, 2) and the table (m, 4), contiguous,
    16-byte aligned, in one allocation without overlap."""
    c, tab = tops._garble_outputs(m, torch.zeros((m, 2), dtype=torch.int64))
    assert tuple(c.shape) == (m, 2) and tuple(tab.shape) == (m, 4)
    assert c.dtype == tab.dtype == torch.int64
    assert c.is_contiguous() and tab.is_contiguous()
    assert c.data_ptr() % 16 == 0 and tab.data_ptr() % 16 == 0
    assert c.untyped_storage().data_ptr() == tab.untyped_storage().data_ptr()
    assert c.data_ptr() + c.nbytes <= tab.data_ptr()
    c.fill_(1)
    tab.fill_(2)
    assert bool((c == 1).all()) and bool((tab == 2).all())


def test_round_key_planes_hold_the_key_schedule():
    """Both halves of every plane agree; undoing the layout, each round's
    fixsliced row rotation and (rounds 1-10) the S-box's constant gives the
    key schedule."""
    planes = tkernel.round_key_planes().reshape(11, 8)
    const = (tkernel.SBOX_CONSTANT >> np.arange(8)) & 1
    planes[1:] ^= (const * 0xFFFFFFFF).astype(np.uint32)
    assert np.array_equal((planes >> 4) & 0x0F0F0F0F, planes & 0x0F0F0F0F)
    pos = 8 * np.arange(4)[None, :] + np.arange(4)[:, None]   # [col, row]
    bits = (planes[:, :, None, None] >> pos) & 1              # (11,8,4,4)
    stored = (bits << np.arange(8)[None, :, None, None]).sum(axis=1)
    rnd = np.arange(11)[:, None, None]
    col = np.arange(4)[None, :, None]
    row = np.arange(4)[None, None, :]
    keys = stored[rnd, (col + rnd * row) % 4, row]            # [rnd,col,row]
    assert np.array_equal(keys.reshape(11, 16),
                          npaes.ROUND_KEYS.astype(np.int64))


# ---------------------------------------------------------------------------
# the CUDA source, built for the host: its arithmetic is plain C++
# ---------------------------------------------------------------------------

_HOST_HARNESS = r"""
#include "aes_ct.cuh"
extern "C" {
void planes(const uint32_t* a, const uint32_t* b, uint32_t* p) {
  to_planes(a, b, p);
}
void unplanes(const uint32_t* p, uint32_t* a, uint32_t* b) {
  from_planes(p, a, b);
}
void sbox(uint32_t* p) { sub_bytes(p); }
void mixcol(uint32_t* p, int j, const uint32_t* rk) { mix_columns(p, j, rk); }
void dsr(uint32_t* w) { double_shift_rows(w); }
void enc(uint32_t* a, uint32_t* b, const uint32_t* rk) {
  aes128_encrypt2(a, b, rk);
}
// the kernel's two lanes of each gate, run one after the other; the XOR of
// their W is what the kernel's lane exchange gives
void garble(const uint64_t* a, const uint64_t* b, uint64_t rlo, uint64_t rhi,
            uint64_t gid0, uint64_t* c, uint64_t* tab, int64_t m,
            const uint32_t* rk) {
  for (int64_t i = 0; i < m; ++i) {
    Label t[2], w[2];
    for (uint32_t lane = 0; lane < 2; ++lane)
      garble_lane(Label{a[2*i], a[2*i+1]}, Label{b[2*i], b[2*i+1]},
                  Label{rlo, rhi}, gid0 + i, lane, rk, &t[lane], &w[lane]);
    const Label o = lxor(w[0], w[1]);
    c[2*i] = o.lo; c[2*i+1] = o.hi;
    tab[4*i] = t[0].lo; tab[4*i+1] = t[0].hi;
    tab[4*i+2] = t[1].lo; tab[4*i+3] = t[1].hi;
  }
}
void eval(const uint64_t* a, const uint64_t* b, const uint64_t* tab,
          uint64_t gid0, uint64_t* c, int64_t m, const uint32_t* rk) {
  for (int64_t i = 0; i < m; ++i) {
    Label o = half_gates_eval(Label{a[2*i], a[2*i+1]}, Label{b[2*i], b[2*i+1]},
                              Label{tab[4*i], tab[4*i+1]},
                              Label{tab[4*i+2], tab[4*i+3]}, gid0 + i, rk);
    c[2*i] = o.lo; c[2*i+1] = o.hi;
  }
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """aes_ct.cuh built by the host compiler, with its layers exported."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed"
    tmp = tmp_path_factory.mktemp("aes_ct")
    src = tmp / "host.cpp"
    src.write_text(_HOST_HARNESS)
    lib_path = tmp / "libhost.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{tkernel.CSRC}", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, U, I = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    for name in ("planes", "unplanes", "enc"):
        getattr(lib, name).argtypes = [P, P, P]
    lib.sbox.argtypes = [P]
    lib.mixcol.argtypes = [P, ctypes.c_int, P]
    lib.dsr.argtypes = [P]
    lib.garble.argtypes = [P, P, U, U, U, P, P, I, P]
    lib.eval.argtypes = [P, P, P, U, P, I, P]
    return lib


def _blocks(rng, n=2) -> np.ndarray:
    """n random AES states, (n, 16) uint8, byte 4c + r at (row r, col c)."""
    return rng.integers(0, 256, (n, 16), dtype=np.uint8)


def _to_planes(lib, blk: np.ndarray) -> np.ndarray:
    w = np.ascontiguousarray(blk).view("<u4").copy()          # (2, 4)
    p = np.zeros(8, np.uint32)
    lib.planes(w[0].ctypes.data, w[1].ctypes.data, p.ctypes.data)
    return p


def _from_planes(lib, p: np.ndarray) -> np.ndarray:
    a, b = np.zeros(4, np.uint32), np.zeros(4, np.uint32)
    lib.unplanes(np.ascontiguousarray(p).ctypes.data, a.ctypes.data,
                 b.ctypes.data)
    return np.stack([a, b]).view(np.uint8)


def _rotate_rows(blk: np.ndarray, j: int) -> np.ndarray:
    """The fixsliced order after round j: byte (r, c) <- (r, c - j r)."""
    idx = [4 * ((i // 4 - j * (i % 4)) % 4) + i % 4 for i in range(16)]
    return blk[:, idx]


def _mix_columns(blk: np.ndarray) -> np.ndarray:
    """MixColumns as protocols/garbled/aes.py computes it in a round."""
    v = blk.reshape(-1, 4, 4)
    rot1 = np.roll(v, -1, axis=2)
    mixed = (npaes._xtime(v) ^ rot1 ^ npaes._xtime(rot1)
             ^ np.roll(v, -2, axis=2) ^ np.roll(v, -3, axis=2))
    return mixed.reshape(-1, 16)


def test_host_planes_layout(host_lib):
    """Plane k holds bit k of block blk's byte (row r, column c) at bit
    8r + 4blk + c; the transpose out of the planes inverts it."""
    rng = np.random.default_rng(20)
    for _ in range(8):
        blk = _blocks(rng)
        p = _to_planes(host_lib, blk)
        want = np.zeros(8, np.uint32)
        for k in range(8):
            for bl in range(2):
                for i in range(16):
                    bit = (int(blk[bl, i]) >> k) & 1
                    want[k] |= np.uint32(bit << (8 * (i % 4) + 4 * bl + i // 4))
        assert np.array_equal(p, want)
        assert np.array_equal(_from_planes(host_lib, p), blk)


def test_host_sub_bytes_matches_sbox(host_lib):
    """The S-box without its affine constant, which the round keys of
    rounds 1-10 carry instead."""
    want = npaes.SBOX ^ np.uint8(tkernel.SBOX_CONSTANT)
    rng = np.random.default_rng(21)
    for _ in range(8):
        blk = _blocks(rng)
        p = _to_planes(host_lib, blk)
        host_lib.sbox(p.ctypes.data)
        assert np.array_equal(_from_planes(host_lib, p), want[blk])
    # every byte value once
    blk = np.arange(256, dtype=np.uint8).reshape(-1, 2, 16)
    for pair in blk:
        p = _to_planes(host_lib, pair)
        host_lib.sbox(p.ctypes.data)
        assert np.array_equal(_from_planes(host_lib, p), want[pair])


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_host_fixsliced_mix_columns(host_lib, j):
    """Round j's MixColumns on the rotated order, then the key, equals the
    rotated MixColumns of the plain state XOR the key."""
    rng = np.random.default_rng(22 + j)
    for _ in range(8):
        x, key = _blocks(rng), _blocks(rng)
        rk = _to_planes(host_lib, key)
        p = _to_planes(host_lib, _rotate_rows(x, j))
        host_lib.mixcol(p.ctypes.data, j, rk.ctypes.data)
        assert np.array_equal(_from_planes(host_lib, p),
                              _rotate_rows(_mix_columns(x), j) ^ key)


def test_host_double_shift_rows(host_lib):
    rng = np.random.default_rng(26)
    for _ in range(8):
        blk = _blocks(rng, 1)
        w = blk.view("<u4").copy()
        host_lib.dsr(w.ctypes.data)
        sr = npaes.SHIFT_ROWS
        assert np.array_equal(w.view(np.uint8), blk[:, sr][:, sr])


def test_host_aes_pass_matches_numpy_and_fips197(host_lib):
    rk = tkernel.round_key_planes()
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       dtype=np.uint8)
    rng = np.random.default_rng(27)
    for blk in [np.stack([pt, pt[::-1]])] + [_blocks(rng) for _ in range(16)]:
        w = np.ascontiguousarray(blk).view("<u4").copy()
        host_lib.enc(w[0].ctypes.data, w[1].ctypes.data, rk.ctypes.data)
        assert np.array_equal(w.view(np.uint8),
                              npaes.aes128_encrypt_blocks(blk))
    w = np.stack([pt, pt]).view("<u4").copy()
    host_lib.enc(w[0].ctypes.data, w[1].ctypes.data, rk.ctypes.data)
    assert bytes(w[0].view(np.uint8)).hex() == \
        "69c4e0d86a7b0430d8cdb78070b4c55a"


@pytest.mark.parametrize("gid0", GIDS)
def test_cuda_source_arithmetic_on_host(host_lib, gid0):
    """aes_ct.cuh is host+device code: built by the host compiler, its two
    garbling lanes and its evaluation equal the NumPy gates at every
    gate-id range and batch size."""
    rk = tkernel.round_key_planes()
    for m in (1, 16, 32, 37):
        ch = NpChannel()
        g = NpGarbler(ch, seed=11 + m)
        g.gid = gid0
        A, B = g._fresh(m), g._fresh(m)
        C = g.and_(A.copy(), B.copy())
        tab = ch.recv("tab")
        c = np.zeros((m, 2), np.uint64)
        t = np.zeros((m, 4), np.uint64)
        host_lib.garble(A.ctypes.data, B.ctypes.data, int(g.R[0]),
                        int(g.R[1]), gid0, c.ctypes.data, t.ctypes.data, m,
                        rk.ctypes.data)
        assert np.array_equal(c, C) and np.array_equal(t, tab)
        for bit_a in (0, 1):
            for bit_b in (0, 1):
                wa = A ^ (g.R[None] * np.uint64(bit_a))
                wb = B ^ (g.R[None] * np.uint64(bit_b))
                out = np.zeros((m, 2), np.uint64)
                host_lib.eval(wa.ctypes.data, wb.ctypes.data, t.ctypes.data,
                              gid0, out.ctypes.data, m, rk.ctypes.data)
                assert np.array_equal(
                    out, C ^ (g.R[None] * np.uint64(bit_a & bit_b)))


def _run_sbox_body(body: str, x: np.ndarray) -> np.ndarray:
    """Evaluate a generated ``sub_bytes`` body on bytes x (bit k of each
    byte is plane k), in Python."""
    env = {f"U{i}": (x >> (7 - i)) & 1 for i in range(8)}
    out = np.zeros_like(x)
    for line in body.strip().splitlines():
        target, expr = (s.strip(" ;") for s in line.split("=", 1))
        m = re.fullmatch(r"lop3<0x(\w+)>\((\w+), (\w+), (\w+)\)", expr)
        if m:
            lut = int(m[1], 16)
            a, b, c = (env.get(v, 0) for v in m.groups()[1:])
            val = (lut >> (4 * a + 2 * b + c)) & 1
        else:
            a, op, b = expr.split()
            val = env[a] ^ env[b] if op == "^" else env[a] & env[b]
        name = target.split()[-1]
        if name.startswith("p["):
            out |= val << int(name[2])
        env[name] = val
    return out


def test_sbox_cover_tool_matches_the_header():
    """tools/sbox_lut3.py finds a cover as small as the one in aes_ct.cuh,
    and what it prints computes the S-box without its constant."""
    spec = importlib.util.spec_from_file_location(
        "sbox_lut3", pathlib.Path(__file__).parents[1] / "tools" /
        "sbox_lut3.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    chosen = tool.cover()
    header = (tkernel.CSRC / "aes_ct.cuh").read_text()
    body = header.split("U7 = p[0];\n", 1)[1].split("\n}\n", 1)[0]
    assert len(chosen) == len(body.strip().splitlines()) == 82
    x = np.arange(256)
    want = npaes.SBOX.astype(np.int64) ^ tkernel.SBOX_CONSTANT
    assert np.array_equal(_run_sbox_body(tool.emit(chosen), x), want)
    assert np.array_equal(_run_sbox_body(body, x), want)
