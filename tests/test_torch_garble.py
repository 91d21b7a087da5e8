"""The port's half gates against the JAX package's: the plain PyTorch
versions (which the CPU path runs) against the Pallas kernels in interpret
mode, the jnp oracle and the NumPy gates; the CUDA source's arithmetic,
built for the host; and the wrappers' checks.  Every comparison is bitwise.
"""

import ctypes
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
    c, t = tops.garble_and(_t(A), _t(B), g.R, gid0)
    assert np.array_equal(_u(c), C) and np.array_equal(_u(t), tab)
    wa, wb = A ^ g.R[None], B ^ g.R[None]
    ch.send("tab", tab)
    assert np.array_equal(_u(tops.eval_and(_t(wa), _t(wb), t, gid0)),
                          e.and_(wa, wb))


@pytest.mark.parametrize("bit_a,bit_b", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_truth_table(bit_a, bit_b):
    a, b, r = _labels(np.random.default_rng(bit_a * 2 + bit_b), 32)
    c0, tab = tops.garble_and(_t(a), _t(b), r, 0)
    wa = a ^ (r[None] * np.uint64(bit_a))
    wb = b ^ (r[None] * np.uint64(bit_b))
    wc = tops.eval_and(_t(wa), _t(wb), tab, 0)
    assert np.array_equal(_u(wc), _u(c0) ^ (r[None] * np.uint64(bit_a & bit_b)))


@pytest.mark.parametrize("m", [0, 1, 37])
def test_odd_batch_all_rows(m):
    a, b, r = _labels(np.random.default_rng(m), m)
    c0, tab = tops.garble_and(_t(a), _t(b), r, 5)
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
    c, tab = tops.garble_and(_t(a), _t(b), r, 0)
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
        tops.garble_and(ta, tb, r, gid)


def test_round_key_planes_hold_the_key_schedule():
    planes = tkernel.round_key_planes().reshape(11, 8)
    assert np.array_equal(planes >> 16, planes & 0xFFFF)
    bits = (planes[:, :, None] >> np.arange(16)) & 1          # (11, 8, 16)
    rebuilt = (bits << np.arange(8)[None, :, None]).sum(axis=1)
    assert np.array_equal(rebuilt, npaes.ROUND_KEYS.astype(np.int64))


# ---------------------------------------------------------------------------
# the CUDA source, built for the host: its arithmetic is plain C++
# ---------------------------------------------------------------------------

_HOST_HARNESS = r"""
#include "aes_ct.cuh"
extern "C" {
void garble(const uint64_t* a, const uint64_t* b, uint64_t rlo, uint64_t rhi,
            uint64_t gid0, uint64_t* c, uint64_t* tab, int64_t m,
            const uint32_t* rk) {
  for (int64_t i = 0; i < m; ++i) {
    Label o, tg, te;
    half_gates_garble(Label{a[2*i], a[2*i+1]}, Label{b[2*i], b[2*i+1]},
                      Label{rlo, rhi}, gid0 + i, rk, &o, &tg, &te);
    c[2*i] = o.lo; c[2*i+1] = o.hi;
    tab[4*i] = tg.lo; tab[4*i+1] = tg.hi; tab[4*i+2] = te.lo; tab[4*i+3] = te.hi;
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


def test_cuda_source_arithmetic_on_host(tmp_path):
    """aes_ct.cuh is host+device code: built by the host compiler, its
    half gates equal the NumPy gates at every gate-id range."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed"
    src = tmp_path / "host.cpp"
    src.write_text(_HOST_HARNESS)
    lib_path = tmp_path / "libhost.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{tkernel.CSRC}", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    P, U, I = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    lib.garble.argtypes = [P, P, U, U, U, P, P, I, P]
    lib.eval.argtypes = [P, P, P, U, P, I, P]
    rk = tkernel.round_key_planes()
    for gid0 in GIDS:
        ch = NpChannel()
        g = NpGarbler(ch, seed=11)
        g.gid = gid0
        m = 37
        A, B = g._fresh(m), g._fresh(m)
        C = g.and_(A.copy(), B.copy())
        tab = ch.recv("tab")
        c = np.zeros((m, 2), np.uint64)
        t = np.zeros((m, 4), np.uint64)
        lib.garble(A.ctypes.data, B.ctypes.data, int(g.R[0]), int(g.R[1]),
                   gid0, c.ctypes.data, t.ctypes.data, m, rk.ctypes.data)
        assert np.array_equal(c, C) and np.array_equal(t, tab)
        for bit_a in (0, 1):
            for bit_b in (0, 1):
                wa = A ^ (g.R[None] * np.uint64(bit_a))
                wb = B ^ (g.R[None] * np.uint64(bit_b))
                out = np.zeros((m, 2), np.uint64)
                lib.eval(wa.ctypes.data, wb.ctypes.data, t.ctypes.data, gid0,
                         out.ctypes.data, m, rk.ctypes.data)
                assert np.array_equal(
                    out, C ^ (g.R[None] * np.uint64(bit_a & bit_b)))
