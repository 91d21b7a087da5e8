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
#include <stddef.h>
#include <vector>
#include "ntt_arith.cuh"
#include "ntt_sched.cuh"
using namespace ntt_sched;

// a CTA of the card's kernels, thread by thread: every thread runs a phase
// before any thread runs the next (the kernels' __syncthreads)
template <int LOGN, bool INV>
void run_rows(const int64_t* in, int64_t* out, const uint32_t* tw,
              const NttPrime* primes, int n_primes, long rows) {
  using Pl = Plan<LOGN, INV>;
  std::vector<NttThread<LOGN, INV>> th(Pl::T);
  std::vector<uint32_t> smem(2 * Pl::N);
  for (long r = 0; r < rows; ++r) {
    const int p = (int)(r % n_primes);
    const ntt_u4* src = reinterpret_cast<const ntt_u4*>(in + r * Pl::N);
    ntt_u4* dst = reinterpret_cast<ntt_u4*>(out + r * Pl::N);
    const ntt_u2* tab =
        reinterpret_cast<const ntt_u2*>(tw) + ((size_t)p * 2 + INV) * Pl::N;
    static_for<0, Pl::NP>([&](auto e) {
      for (int t = 0; t < Pl::T; ++t)
        th[t].template phase<decltype(e)::value>(t, src, dst, tab,
                                                 primes + p, smem.data());
    });
  }
}

// the most words of one bank that a warp's access to an exchange touches
// (1: every access of 32 lanes hits 32 banks)
template <int LOGN, bool INV, int E, int P>
int bank_ways() {
  using Pl = Plan<LOGN, INV>;
  using Th = NttThread<LOGN, INV>;
  int worst = 1;
  static_for<0, Pl::R>([&](auto k) {
    for (int w = 0; w < Pl::T; w += 32) {
      std::vector<std::vector<uint32_t>> bank(32);
      for (int t = w; t < w + 32 && t < Pl::T; ++t) {
        const uint32_t a = Th::template smem_index<E, P, decltype(k)::value>(t);
        auto& b = bank[a % 32];
        bool seen = false;
        for (uint32_t x : b) seen = seen || x == a;
        if (!seen) b.push_back(a);
        worst = (int)b.size() > worst ? (int)b.size() : worst;
      }
    }
  });
  return worst;
}

template <int LOGN, bool INV>
void info(int* out) {
  using Pl = Plan<LOGN, INV>;
  int worst = 1;
  static_for<0, Pl::NP - 1>([&](auto e) {
    constexpr int E = decltype(e)::value;
    const int w = bank_ways<LOGN, INV, E, E>();      // pass E writes
    const int r = bank_ways<LOGN, INV, E, E + 1>();  // pass E+1 reads
    worst = w > worst ? w : worst;
    worst = r > worst ? r : worst;
  });
  out[0] = Pl::T;
  out[1] = Pl::R;
  out[2] = Pl::NP - 1;        // barriers
  out[3] = worst;
  out[4] = slots(LOGN, INV, true);
  out[5] = Pl::kAhead;
}

template <bool INV, int L = 1>
int dispatch(int logn, const int64_t* in, int64_t* out, const uint32_t* tw,
             const NttPrime* primes, int n_primes, long rows, int* inf) {
  if constexpr (L > kMaxLogN) {
    return 1;
  } else {
    if (logn != L)
      return dispatch<INV, L + 1>(logn, in, out, tw, primes, n_primes, rows,
                                  inf);
    if (inf) info<L, INV>(inf);
    else run_rows<L, INV>(in, out, tw, primes, n_primes, rows);
    return 0;
  }
}

extern "C" {
// whole transforms of one row, stage by stage (m groups of half-width
// 2^lt, twiddle psi[m + i] for group i) and butterfly by butterfly, as
// repro.protocols.ckks.ntt's stage loops run them
void forward(uint32_t* v, int logn, const uint32_t* psi, const uint32_t* ps,
             uint32_t q) {
  const int n = 1 << logn;
  for (int lt = logn - 1, m = 1; lt >= 0; --lt, m <<= 1)
    for (int b = 0; b < n / 2; ++b) {
      const int i = b >> lt, j = (i << (lt + 1)) + (b & ((1 << lt) - 1));
      ct_butterfly(v[j], v[j + (1 << lt)], psi[m + i], ps[m + i], q);
    }
}
void inverse(uint32_t* v, int logn, const uint32_t* psi, const uint32_t* ps,
             uint32_t q, uint32_t n_inv, uint32_t n_inv_shoup) {
  const int n = 1 << logn;
  for (int lt = 0, h = n / 2; h >= 1; ++lt, h >>= 1)
    for (int b = 0; b < n / 2; ++b) {
      const int i = b >> lt, j = (i << (lt + 1)) + (b & ((1 << lt) - 1));
      gs_butterfly(v[j], v[j + (1 << lt)], psi[h + i], ps[h + i], q);
    }
  for (int k = 0; k < n; ++k) v[k] = shoup_mul(v[k], n_inv, n_inv_shoup, q);
}
void product(const uint32_t* a, const uint32_t* b, uint32_t* out, int n,
             uint32_t q, uint32_t mu, uint32_t k) {
  NttPrime p = {q, 0, 0, mu, k, 0, 0, 0};
  for (int i = 0; i < n; ++i) out[i] = mul_mod(a[i], b[i], p);
}
// the card's transform kernels (ntt.cu) with their arguments: int64 rows,
// the wrapper's (P, 2, N, 2) twiddle table and (P, 8) NttPrime rows
int sched_transform(int inv, const int64_t* in, int64_t* out,
                    const uint32_t* tw, const uint32_t* primes, int n_primes,
                    int logn, long rows) {
  const NttPrime* pr = reinterpret_cast<const NttPrime*>(primes);
  return inv ? dispatch<true>(logn, in, out, tw, pr, n_primes, rows, nullptr)
             : dispatch<false>(logn, in, out, tw, pr, n_primes, rows,
                               nullptr);
}
// threads, registers a thread, barriers, worst bank ways of an exchange,
// twiddles a thread loads, passes loaded ahead
int sched_info(int inv, int logn, int* out) {
  return inv ? dispatch<true>(logn, 0, 0, 0, 0, 1, 0, out)
             : dispatch<false>(logn, 0, 0, 0, 0, 1, 0, out);
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
    subprocess.run([cxx, "-O0", "-std=c++17", "-shared", "-fPIC",
                    f"-I{tkernel.CSRC}", "-o", str(path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    P, I, U, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_long
    lib.forward.argtypes = [P, I, P, P, U]
    lib.inverse.argtypes = [P, I, P, P, U, U, U]
    lib.product.argtypes = [P, P, P, I, U, U, U]
    lib.sched_transform.argtypes = [I, P, P, P, P, I, I, L]
    lib.sched_info.argtypes = [I, I, P]
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


def _sched(host_lib, inverse: bool, a: np.ndarray, primes) -> np.ndarray:
    """The card's transform, thread by thread on the host, over the
    wrapper's own tables; a is (rows, N), row r mod primes[r % P]."""
    n = a.shape[-1]
    t = tops.tables(tuple(primes), n, torch.device("cpu"))
    tw = np.ascontiguousarray(t.tw.numpy())
    c = np.ascontiguousarray(t.consts.numpy())
    x = np.ascontiguousarray(a.astype(np.int64))
    out = np.full_like(x, -1)
    assert host_lib.sched_transform(int(inverse), x.ctypes.data,
                                    out.ctypes.data, tw.ctypes.data,
                                    c.ctypes.data, len(primes),
                                    n.bit_length() - 1, x.shape[0]) == 0
    return out.astype(np.uint64)


@pytest.mark.parametrize("q", CHAIN + [SPECIAL])
def test_schedule_on_host_matches_numpy(host_lib, q):
    """ntt_sched.cuh's per-thread code (the card's kernels without the
    card): forward and inverse at N = 1024 equal the NumPy transform bit for
    bit, for every prime of the benchmark width, P = 1073750017 included."""
    rng = np.random.default_rng(q % 1013)
    a = _residues(rng, q, (5, 1024))
    f = _sched(host_lib, False, a, [q])
    assert np.array_equal(f, npntt.ntt_forward(a, q))
    assert np.array_equal(_sched(host_lib, True, f, [q]), a)
    assert np.array_equal(_sched(host_lib, True, a, [q]),
                          npntt.ntt_inverse(a, q))
    edge = np.array([[0] * 1024, [q - 1] * 1024], dtype=np.uint64)
    assert np.array_equal(_sched(host_lib, False, edge, [q]),
                          npntt.ntt_forward(edge, q))
    assert np.array_equal(_sched(host_lib, True, edge, [q]),
                          npntt.ntt_inverse(edge, q))


def test_schedule_on_host_stacked_primes(host_lib):
    """Row r takes prime r % P: the four primes of a level in one call."""
    primes = CHAIN + [SPECIAL]
    rng = np.random.default_rng(17)
    a = np.stack([_residues(rng, q, (3, 1024)) for q in primes], axis=1)
    f = _sched(host_lib, False, a.reshape(-1, 1024), primes).reshape(a.shape)
    inv = _sched(host_lib, True, f.reshape(-1, 1024), primes)
    for j, q in enumerate(primes):
        assert np.array_equal(f[:, j], npntt.ntt_forward(a[:, j], q))
    assert np.array_equal(inv.reshape(a.shape), a)


RINGS = [1 << k for k in range(1, 14)]


@pytest.mark.parametrize("n", RINGS)
def test_schedule_on_host_every_ring(host_lib, n):
    """Every ring the kernels take, N = 2 .. MAX_N, at one prime: the same
    kernel family (its own threads, registers and passes at each N)."""
    assert RINGS[-1] == tops.MAX_N
    q = gen_primes(n, [29])[0]
    rng = np.random.default_rng(n)
    a = _residues(rng, q, (3, n))
    f = _sched(host_lib, False, a, [q])
    assert np.array_equal(f, npntt.ntt_forward(a, q))
    assert np.array_equal(_sched(host_lib, True, f, [q]), a)
    assert np.array_equal(_sched(host_lib, True, a, [q]),
                          npntt.ntt_inverse(a, q))


@pytest.mark.parametrize("n", RINGS)
def test_schedule_shape(host_lib, n):
    """Threads and registers a row, barriers, and shared-memory banks: every
    warp access of every exchange hits 32 banks; N = 1024 takes 128 threads
    of 8 coefficients and 4 barriers (a stage a barrier took 10)."""
    for inverse in (False, True):
        got = np.zeros(6, np.int32)
        assert host_lib.sched_info(int(inverse), n.bit_length() - 1,
                                   got.ctypes.data) == 0
        threads, regs, barriers, ways, twiddles, ahead = (int(x) for x in got)
        assert threads * regs == n and ways == 1
        assert twiddles < regs * (barriers + 1)
        if n == 1024:
            assert (threads, regs, barriers, ahead) == (128, 8, 4, 4)
        if n == 8192:
            assert (threads, regs, ahead) == (512, 16, 1)


@pytest.mark.parametrize("n", [2, 1024, 8192])
def test_folded_constants_match_python_ints(n):
    """ops.tables' NttPrime rows: psi^-1[1] N^-1 mod q and its Shoup
    quotient (the inverse's last stage with N^-1 folded in), beside q,
    N^-1, its quotient and Barrett's mu and k, in Python ints."""
    primes = tuple(CkksParams(n_ring=max(n, 64), levels=2).primes) \
        if n >= 64 else (gen_primes(n, [29])[0],)
    if n == 1024:
        primes = tuple(CHAIN + [SPECIAL])
    t = tops.tables(primes, n, torch.device("cpu"))
    got = t.consts.numpy().view(np.uint32).astype(object)
    for row, q in zip(got, primes):
        _, psi_inv, n_inv = npntt.ntt_tables(q, n)
        assert n_inv * n % q == 1
        w1 = int(psi_inv[1]) * n_inv % q
        k = q.bit_length()
        assert list(row) == [q, n_inv, (n_inv << 32) // q,
                             (1 << 2 * k) // q, k, w1, (w1 << 32) // q, 0]
    tw = t.tw.numpy().view(np.uint32).astype(object)
    assert tw.shape == (len(primes), 2, n, 2)
    for i, q in enumerate(primes):
        psi, psi_inv, _ = npntt.ntt_tables(q, n)
        for d, w in enumerate((psi, psi_inv)):
            assert [int(x) for x in tw[i, d, :, 0]] == [int(x) for x in w]
            assert [int(x) for x in tw[i, d, :, 1]] == \
                [(int(x) << 32) // q for x in w]
