"""The port's NTT and modular-product functions against the JAX package's:
the plain PyTorch versions (which the CPU path runs) against the Pallas
kernels in interpret mode and the NumPy transform; the CUDA source's
arithmetic, built for the host; the wrappers' checks and counters.  Every
comparison is bitwise, on inputs made from a seed with NumPy.

The reference's jnp oracle (``repro/kernels/ntt/ref.py``) is not used: it
calls ``jax.experimental.enable_x64``, which this jax does not have.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro.kernels.ntt import kernel as jkernel
from repro.kernels.ntt import ops as jops
from repro.protocols.ckks import ntt as npntt
from repro.protocols.ckks.params import CkksParams, gen_primes
from repro_torch.kernels.ntt import kernel as tkernel
from repro_torch.kernels.ntt import ops as tops
from repro_torch.kernels.ntt import tables as ttables
from repro_torch.protocols.ckks import ntt as tntt

#: the repo's benchmark width: chain primes q0, q1, q2 and the special P
BENCH = CkksParams(n_ring=1024, levels=2)
CHAIN = BENCH.primes
SPECIAL = BENCH.special_prime


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64))


def _u(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint64)


def _residues(rng, q: int, shape) -> np.ndarray:
    return rng.integers(0, q, shape, dtype=np.uint64)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

#: the JAX package's sweep (tests/test_kernels.py), then N = 1024 at the
#: three chain primes of the benchmark width
SWEEP = [(n, gen_primes(n, [bits])[0]) for n, bits in
         [(64, 25), (64, 29), (256, 25), (256, 29), (512, 28)]] + \
    [(1024, q) for q in CHAIN]


@pytest.mark.parametrize("n,q", SWEEP, ids=[f"{n}-{q}" for n, q in SWEEP])
def test_plain_matches_pallas_interpret(n, q):
    rng = np.random.default_rng(n + q % 1000)
    a = _residues(rng, q, (8, n))
    b = _residues(rng, q, (8, n))
    f = tntt.ntt_forward(_t(a), q)
    assert np.array_equal(_u(f), jops.ntt_forward(a, q, interpret=True))
    inv = tntt.ntt_inverse(f, q)
    assert np.array_equal(_u(inv), jops.ntt_inverse(_u(f), q,
                                                    interpret=True))
    assert np.array_equal(_u(inv), a)
    c = tntt.negacyclic_mul(_t(a), _t(b), q)
    assert np.array_equal(_u(c), jops.negacyclic_mul(a, b, q,
                                                     interpret=True))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_plain_odd_batch_matches_pallas(k):
    q = gen_primes(64, [29])[0]
    rng = np.random.default_rng(k)
    a = _residues(rng, q, (k, 64))
    b = _residues(rng, q, (k, 64))
    f = tntt.ntt_forward(_t(a), q)
    assert np.array_equal(_u(f), jops.ntt_forward(a, q, interpret=True))
    assert np.array_equal(_u(tntt.ntt_inverse(f, q)), a)
    c = tntt.negacyclic_mul(_t(a), _t(b), q)
    assert np.array_equal(_u(c), jops.negacyclic_mul(a, b, q,
                                                     interpret=True))


@pytest.mark.parametrize("q", CHAIN)
def test_plain_product_matches_pointwise_pallas(q):
    rng = np.random.default_rng(q % 997)
    a = _residues(rng, q, (8, 1024))
    b = _residues(rng, q, (8, 1024))
    want = np.asarray(jkernel.pointwise_mul_pallas(
        a.astype(np.uint32), b.astype(np.uint32), q=q, interpret=True))
    assert np.array_equal(_u(tntt.mul_mod(_t(a), _t(b), q)),
                          want.astype(np.uint64))


def test_special_prime_matches_numpy():
    """P = 1073750017 >= 2^30, which the Pallas guard refuses; the port
    takes it, held against the NumPy transform."""
    assert SPECIAL >= 1 << 30
    with pytest.raises(AssertionError):
        jkernel._barrett_consts(SPECIAL)
    rng = np.random.default_rng(5)
    a = _residues(rng, SPECIAL, (3, 1024))
    b = _residues(rng, SPECIAL, (3, 1024))
    f = tntt.ntt_forward(_t(a), SPECIAL)
    assert np.array_equal(_u(f), npntt.ntt_forward(a, SPECIAL))
    assert np.array_equal(_u(tntt.ntt_inverse(f, SPECIAL)), a)
    assert np.array_equal(_u(tntt.mul_mod(_t(a), _t(b), SPECIAL)),
                          a * b % np.uint64(SPECIAL))
    c = tntt.negacyclic_mul(_t(a), _t(b), SPECIAL)
    assert np.array_equal(_u(c), np.stack([npntt.negacyclic_mul(
        a[i], b[i], SPECIAL) for i in range(3)]))


def test_stacked_primes_match_per_prime():
    """(count, P, N) stacks, row p of each stack mod primes[p]: one call
    equals P separate transforms."""
    primes = CHAIN + [SPECIAL]
    rng = np.random.default_rng(11)
    a = np.stack([_residues(rng, q, (3, 1024)) for q in primes], axis=1)
    b = np.stack([_residues(rng, q, (3, 1024)) for q in primes], axis=1)
    f = tntt.ntt_forward(_t(a), primes)
    p = tntt.mul_mod(f, _t(b), primes)
    inv = tntt.ntt_inverse(p, primes)
    for j, q in enumerate(primes):
        fj = npntt.ntt_forward(a[:, j], q)
        assert np.array_equal(_u(f[:, j]), fj)
        pj = fj * b[:, j] % np.uint64(q)
        assert np.array_equal(_u(p[:, j]), pj)
        assert np.array_equal(_u(inv[:, j]), npntt.ntt_inverse(pj, q))


def test_negacyclic_mul_matches_schoolbook():
    q = gen_primes(64, [29])[0]
    rng = np.random.default_rng(3)
    a, b = _residues(rng, q, 64), _residues(rng, q, 64)
    c = tntt.negacyclic_mul(_t(a), _t(b), q)
    assert np.array_equal(_u(c), npntt.negacyclic_mul_naive(a, b, q))


def test_tables_match_reference():
    for q in CHAIN + [SPECIAL]:
        got, want = ttables.ntt_tables(q, 1024), npntt.ntt_tables(q, 1024)
        assert all(np.array_equal(g, w) for g, w in zip(got[:2], want[:2]))
        assert got[2] == want[2]
    assert np.array_equal(ttables.bit_reverse_indices(256),
                          npntt.bit_reverse_indices(256))
    assert tntt.ntt_tables is ttables.ntt_tables


# ---------------------------------------------------------------------------
# wrappers: refusals and counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["q_too_big", "n_not_pow2", "n_too_big",
                                 "dtype", "device", "primes_rows",
                                 "not_ntt_friendly", "shape_b"])
def test_wrappers_reject_bad_input(bad):
    q, n = CHAIN[1], 64
    a = torch.zeros((3, n), dtype=torch.int64)
    b = a
    primes = q
    if bad == "q_too_big":
        primes = (1 << 31) + 2 * n + 1
    elif bad == "n_not_pow2":
        a = b = torch.zeros((3, 96), dtype=torch.int64)
    elif bad == "n_too_big":
        a = b = torch.zeros((1, 2 * tops.MAX_N), dtype=torch.int64)
        primes = gen_primes(2 * tops.MAX_N, [29])[0]
    elif bad == "dtype":
        a = b = a.to(torch.int32)
    elif bad == "device":
        a = b = a.to("meta")
    elif bad == "primes_rows":
        primes = (q, CHAIN[2])
    elif bad == "not_ntt_friendly":
        primes = 1000003
    else:
        b = torch.zeros((2, n), dtype=torch.int64)
    calls = [lambda: tops.mul_mod(a, b, primes)]
    if bad != "shape_b":
        calls += [lambda: tops.ntt_forward(a, primes),
                  lambda: tops.ntt_inverse(a, primes)]
    for call in calls:
        with pytest.raises((TypeError, ValueError)):
            call()


def test_cpu_path_launches_no_kernel():
    tops.reset_counts()
    q = CHAIN[0]
    a = _t(_residues(np.random.default_rng(0), q, (2, 3, 1024)))
    tntt.ntt_inverse(tntt.ntt_forward(a, q), q)
    tntt.mul_mod(a, a, q)
    c = tops.counts()
    assert c["launches"] == {k: 0 for k in tops.KINDS}
    assert c["rows"] == {k: 0 for k in tops.KINDS}
    assert c["plain_calls"] == {k: 1 for k in tops.KINDS}


def test_bound_work_figures():
    """The roofline figures count what csrc/ntt_arith.cuh says."""
    n = 1024
    assert tkernel.transform_ops(1, n, False) == 512 * 10 * 11
    assert tkernel.transform_ops(2, n, True) == 2 * (512 * 10 * 11 + 5 * n)
    assert tkernel.mul_mod_ops(3, n) == 3 * n * 14
    assert tkernel.transform_bytes(4, n, 3) == 4 * n * 16 + 3 * (8 * n + 32)
    assert tkernel.mul_mod_bytes(4, n, 3) == 4 * n * 24 + 3 * 32


# ---------------------------------------------------------------------------
# the CUDA source, built for the host: its arithmetic is plain C++
# ---------------------------------------------------------------------------

_HOST_HARNESS = r"""
#include "ntt_arith.cuh"
extern "C" {
// whole transforms of one row, stage by stage and butterfly by butterfly
// in the order one thread of the kernel would run them
void forward(uint32_t* v, int logn, const uint32_t* psi, const uint32_t* ps,
             uint32_t q) {
  const int n = 1 << logn;
  for (int lt = logn - 1, m = 1; lt >= 0; --lt, m <<= 1)
    for (int b = 0; b < n / 2; ++b) fwd_butterfly(v, lt, m, b, psi, ps, q);
}
void inverse(uint32_t* v, int logn, const uint32_t* psi, const uint32_t* ps,
             uint32_t q, uint32_t n_inv, uint32_t n_inv_shoup) {
  const int n = 1 << logn;
  for (int lt = 0, h = n / 2; h >= 1; ++lt, h >>= 1)
    for (int b = 0; b < n / 2; ++b) inv_butterfly(v, lt, h, b, psi, ps, q);
  for (int k = 0; k < n; ++k) v[k] = shoup_mul(v[k], n_inv, n_inv_shoup, q);
}
void product(const uint32_t* a, const uint32_t* b, uint32_t* out, int n,
             uint32_t q, uint32_t mu, uint32_t k) {
  NttPrime p = {q, 0, 0, mu, k, {0, 0, 0}};
  for (int i = 0; i < n; ++i) out[i] = mul_mod(a[i], b[i], p);
}
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a host C++ compiler is needed"
    d = tmp_path_factory.mktemp("ntt_host")
    src = d / "host.cpp"
    src.write_text(_HOST_HARNESS)
    path = d / "libhost.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{tkernel.CSRC}", "-o", str(path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.forward.argtypes = [P, I, P, P, U]
    lib.inverse.argtypes = [P, I, P, P, U, U, U]
    lib.product.argtypes = [P, P, P, I, U, U, U]
    return lib


@pytest.mark.parametrize("q", CHAIN + [SPECIAL])
def test_cuda_source_arithmetic_on_host(host_lib, q):
    """ntt_arith.cuh built by the host compiler: a whole forward and
    inverse transform at N = 1024 and the modular product equal the NumPy
    transform of the JAX package, for every prime of the benchmark width."""
    n, logn = 1024, 10
    psi, psi_inv, n_inv = ttables.ntt_tables(q, n)
    # keep every array the library reads alive across its call
    u32 = lambda x: np.ascontiguousarray(x, dtype=np.uint32)  # noqa: E731
    tw = [u32(psi), u32(ttables.shoup(psi, q)), u32(psi_inv),
          u32(ttables.shoup(psi_inv, q))]
    rng = np.random.default_rng(q % 1009)
    a = _residues(rng, q, n)
    b = _residues(rng, q, n)
    v = u32(a)
    host_lib.forward(v.ctypes.data, logn, tw[0].ctypes.data,
                     tw[1].ctypes.data, q)
    assert np.array_equal(v.astype(np.uint64), npntt.ntt_forward(a, q))
    host_lib.inverse(v.ctypes.data, logn, tw[2].ctypes.data,
                     tw[3].ctypes.data, q, n_inv,
                     int(ttables.shoup(n_inv, q)))
    assert np.array_equal(v.astype(np.uint64), a)
    out = np.zeros(n, np.uint32)
    mu, k = ttables.barrett(q)
    a32, b32 = u32(a), u32(b)
    host_lib.product(a32.ctypes.data, b32.ctypes.data, out.ctypes.data, n,
                     q, mu, k)
    assert np.array_equal(out.astype(np.uint64), a * b % np.uint64(q))
    # the extremes of the Barrett and Shoup ranges
    edge = np.array([0, 1, q - 1, q - 2, q // 2, q // 2 + 1] * 4,
                    dtype=np.uint64)
    e32, r32 = u32(edge), u32(edge[::-1])
    host_lib.product(e32.ctypes.data, r32.ctypes.data, out.ctypes.data,
                     edge.size, q, mu, k)
    assert np.array_equal(out[:edge.size].astype(np.uint64),
                          edge * edge[::-1] % np.uint64(q))
