"""The port's NTT and modular-product functions against the JAX package's:
the plain PyTorch versions (which the CPU path runs) against the Pallas
kernels in interpret mode and the NumPy transform; the CUDA source's
arithmetic, built for the host; the wrappers' checks and counters.  Every
comparison is bitwise, on inputs made from a seed with NumPy.

The reference's jnp oracle (``repro/kernels/ntt/ref.py``) is not used: it
calls ``jax.experimental.enable_x64``, which this jax does not have.
"""

import ctypes
import functools
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
    tntt.negacyclic_mul(a, a, q)
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
    # the fused product of two coefficient rows: two forward transforms, a
    # product, an inverse; 188,416 operations a row of N = 1024, so 4096
    # rows are bound by operations (0.046 ms) above bytes (0.030 ms)
    assert tkernel.ntt_mul_ops(2, 1, 1, 1, n) == 188_416
    ops4k = tkernel.ntt_mul_ops(2, 1, 1, 4096, n)
    bytes4k = tkernel.ntt_mul_bytes(2, 1, 4096, n, 1)
    assert bytes4k == 4096 * 3 * n * 8 + (16 * n + 32)
    assert round(ops4k / 1.67e13 * 1e3, 3) == 0.046
    assert round(bytes4k / 3.35e12 * 1e3, 3) == 0.030
    # relinearize's shape: 3 digits, 2 outputs of 3 terms each (4 adds)
    assert tkernel.ntt_mul_ops(3, 6, 2, 4, n) == 4 * (
        3 * 56_320 + 6 * n * 14 + 4 * n * 3 + 2 * (56_320 + 5 * n))


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

// the fused product (ntt.cu's ntt_mul_kernel) thread by thread: every
// cluster of the job, each phase for every thread of its CTAs before the
// next; a CTA's shared memory starts as all ones, so a read of a word
// nothing wrote shows, and peer(j, ptr) is the same address in CTA j's
template <int LOGN>
void run_mul(const MulJob& job, int64_t groups, const uint32_t* tw,
             const NttPrime* primes) {
  using Th = MulThread<LOGN>;
  const int64_t words = Th::smem_bytes(job.n_coef, job.n_in - job.n_coef,
                                       job.stage_ntt) / 4 + 4;
  std::vector<ntt_u4> smem(job.teams * words / 4 + 1);
  uint32_t* base = reinterpret_cast<uint32_t*>(smem.data());
  const int runs_in = (job.n_coef + job.teams - 1) / job.teams;
  const int runs_out = (job.n_out + job.teams - 1) / job.teams;
  for (int64_t g = 0; g < groups; ++g)
    for (int p = 0; p < job.n_primes; ++p) {
      for (auto& w : smem) w = ntt_u4{~0u, ~0u, ~0u, ~0u};
      std::vector<Th> th(Th::T * job.teams);
      const ntt_u2* fwd =
          reinterpret_cast<const ntt_u2*>(tw) + (size_t)p * 2 * Th::N;
      for (int c = 0; c < runs_in; ++c)
        static_for<0, Th::NP>([&](auto e) {
          for (int t = 0; t < Th::T * job.teams; ++t) {
            const int team = t / Th::T;
            const auto peer = [&](int j, auto* ptr) {
              return reinterpret_cast<decltype(ptr)>(
                  reinterpret_cast<uint32_t*>(ptr) + (j - team) * words);
            };
            th[t].template fwd_phase<decltype(e)::value>(
                c, team, t % Th::T, job, g, p, fwd, primes + p,
                base + team * words, peer);
          }
        });
      for (int t = 0; t < Th::T * job.teams; ++t) th[t].finish_forward();
      for (int c = 0; c < runs_out; ++c)
        static_for<0, Th::NP>([&](auto e) {
          for (int t = 0; t < Th::T * job.teams; ++t)
            th[t].template inv_phase<decltype(e)::value>(
                c, t / Th::T, t % Th::T, job, g, p, fwd + Th::N,
                base + (t / Th::T) * words);
        });
    }
}

// the shared memory of two jobs, the passes loaded ahead, and the layout
// check: the element of register k of thread t in the forward's last pass
// and in the inverse's first (the products' layout P) must be one, and
// each element held once
template <int LOGN>
void mul_info(int* out) {
  using Th = MulThread<LOGN>;
  using Fw = typename Th::Fw;
  using Iv = typename Th::Iv;
  constexpr int L = Th::NP - 1;
  out[0] = Th::T;
  out[1] = (int)Th::smem_bytes(3, 3, true);
  out[2] = (int)Th::smem_bytes(3, 2, false);
  out[3] = Fw::kAhead;
  out[4] = Iv::kAhead;
  int differ = 0, twice = 0;
  std::vector<int> seen(Th::N);
  for (uint32_t t = 0; t < (uint32_t)Th::T; ++t)
    static_for<0, Th::R>([&](auto k) {
      constexpr int KK = decltype(k)::value;
      const uint32_t f = Fw::template tid_elem<L>(t) | Fw::Pl::reg_elem(L, KK);
      const uint32_t i = Iv::template tid_elem<0>(t) | Iv::Pl::reg_elem(0, KK);
      differ += f != i;
      twice += seen[f]++ > 0;
      if (KK % 2 == 0)
        differ += Fw::template pair_unit<L, KK / 2>(t) !=
                  Iv::template pair_unit<0, KK / 2>(t);
    });
  out[5] = differ;
  out[6] = twice;
}

template <int L = 1>
int mul_dispatch(int logn, const MulJob& job, int64_t groups,
                 const uint32_t* tw, const NttPrime* pr, int* inf) {
  if constexpr (L > kMaxLogN) {
    return 1;
  } else {
    if (logn != L)
      return mul_dispatch<L + 1>(logn, job, groups, tw, pr, inf);
    if (inf) mul_info<L>(inf);
    else run_mul<L>(job, groups, tw, pr);
    return 0;
  }
}

extern "C" {
// the fused kernel's job from the wrapper's descriptor, run on the host
int sched_mul(const int64_t* desc, int logn) {
  MulJob job;
  int64_t groups;
  if (!parse_job(desc, &job, &groups)) return 2;
  return mul_dispatch(logn, job, groups,
                      reinterpret_cast<const uint32_t*>(job.tw), job.primes,
                      nullptr);
}
int sched_mul_info(int logn, int* out) {
  return mul_dispatch(logn, MulJob{}, 0, nullptr, nullptr, out);
}
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
    lib.sched_mul.argtypes = [P, I]
    lib.sched_mul_info.argtypes = [I, P]
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


# ---------------------------------------------------------------------------
# the fused product: plain version, schedule on the host, wrapper
# ---------------------------------------------------------------------------

ONE = (((0, 1),),)


def _pair_terms(t: int) -> tuple:
    """One output: the sum over s < t of operand s times operand t + s."""
    return (tuple((s, t + s) for s in range(t)),)


def _np_negacyclic(a, b, q):
    """The JAX package's NumPy negacyclic_mul of rows a, b (..., N), row by
    row."""
    n = a.shape[-1]
    rows = [npntt.negacyclic_mul(x, y, q) for x, y in
            zip(a.reshape(-1, n), b.reshape(-1, n))]
    return np.stack(rows).reshape(a.shape)


@pytest.mark.parametrize("q", CHAIN)
def test_fused_plain_matches_pallas_interpret(q):
    """ntt_mul's plain version of one product a row equals the JAX
    package's negacyclic_mul (three Pallas kernels in interpret mode) at
    each chain prime of the benchmark width."""
    rng = np.random.default_rng(q % 991)
    a = _residues(rng, q, (8, 1024))
    b = _residues(rng, q, (8, 1024))
    got = tops.ntt_mul([_t(a), _t(b)], [], ONE, q)
    assert got.shape == (8, 1, 1024)
    assert np.array_equal(_u(got[:, 0]),
                          jops.negacyclic_mul(a, b, q, interpret=True))
    assert np.array_equal(_u(tntt.negacyclic_mul(_t(a), _t(b), q)),
                          _u(got[:, 0]))


@pytest.mark.parametrize("t", [1, 2, 3, 4])
def test_fused_plain_sums_match_numpy(t):
    """T-term sums, stacked primes (the special prime among them) and
    NTT-domain operands: ntt_mul's plain version against the NumPy
    transform of the JAX package, prime by prime."""
    primes = CHAIN + [SPECIAL]
    rng = np.random.default_rng(40 + t)
    a = [np.stack([_residues(rng, q, (3, 1024)) for q in primes], axis=1)
         for _ in range(2 * t)]
    got = tops.ntt_mul([_t(x) for x in a], [], _pair_terms(t), primes)
    assert got.shape == (3, 1, 4, 1024)
    # the same sums with the right operands given in the NTT domain
    fb = [np.stack([npntt.ntt_forward(x[:, j], q)
                    for j, q in enumerate(primes)], axis=1) for x in a[t:]]
    got_ntt = tops.ntt_mul([_t(x) for x in a[:t]], [_t(x) for x in fb],
                           _pair_terms(t), primes)
    for j, q in enumerate(primes):
        want = np.zeros((3, 1024), np.uint64)
        for s in range(t):
            want = (want + _np_negacyclic(a[s][:, j], a[t + s][:, j], q)) \
                % np.uint64(q)
        assert np.array_equal(_u(got[:, 0, j]), want)
        assert np.array_equal(_u(got_ntt[:, 0, j]), want)


def test_fused_plain_special_prime_matches_numpy():
    """P = 1073750017 (above the Pallas guard): one prime, rows (..., N)."""
    rng = np.random.default_rng(6)
    a = _residues(rng, SPECIAL, (2, 3, 1024))
    b = _residues(rng, SPECIAL, (2, 3, 1024))
    got = tntt.negacyclic_mul(_t(a), _t(b), SPECIAL)
    assert np.array_equal(_u(got), _np_negacyclic(a, b, SPECIAL))
    edge = np.full((1, 1024), SPECIAL - 1, np.uint64)
    assert np.array_equal(_u(tntt.negacyclic_mul(_t(edge), _t(edge),
                                                 SPECIAL)),
                          _np_negacyclic(edge, edge, SPECIAL))


def test_fused_plain_views_and_broadcast():
    """Operands as the cipher passes them: views of one stack (its groups
    4 rows of stacks apart) and an NTT-domain stack broadcast over the
    groups; the tensor product's three outputs."""
    primes = tuple(CHAIN)
    rng = np.random.default_rng(8)
    x = np.stack([np.stack([_residues(rng, q, (5, 4)) for q in primes],
                           axis=-1) for _ in range(1024)], axis=-1)
    x = np.moveaxis(x, -1, -1)                       # (5, 4, P, N)
    xt = _t(x)
    terms = (((0, 2),), ((0, 3), (1, 2)), ((1, 3),))
    got = tops.ntt_mul([xt[:, i] for i in range(4)], [], terms, primes)
    assert got.shape == (5, 3, 3, 1024)
    s = np.stack([_residues(rng, q, 1024) for q in primes])   # (P, N)
    got_s = tops.ntt_mul([xt[:, 0]], [_t(s)], ONE, primes)
    for j, q in enumerate(primes):
        a0, a1, b0, b1 = (x[:, i, j] for i in range(4))
        qq = np.uint64(q)
        assert np.array_equal(_u(got[:, 0, j]), _np_negacyclic(a0, b0, q))
        assert np.array_equal(_u(got[:, 1, j]),
                              (_np_negacyclic(a0, b1, q) +
                               _np_negacyclic(a1, b0, q)) % qq)
        assert np.array_equal(_u(got[:, 2, j]), _np_negacyclic(a1, b1, q))
        fa = npntt.ntt_forward(a0, q)
        assert np.array_equal(_u(got_s[:, 0, j]),
                              npntt.ntt_inverse(fa * s[j] % qq, q))


def test_mul_mod_broadcast_stack():
    """mul_mod with b one stack (P, N) that every stack of a takes."""
    primes = tuple(CHAIN)
    rng = np.random.default_rng(9)
    a = np.stack([_residues(rng, q, (4, 64)) for q in primes], axis=1)
    b = np.stack([_residues(rng, q, 64) for q in primes])
    got = tops.mul_mod(_t(a), _t(b), primes)
    for j, q in enumerate(primes):
        assert np.array_equal(_u(got[:, j]), a[:, j] * b[j] % np.uint64(q))


@pytest.mark.parametrize("bad", ["term_index", "no_term", "outputs",
                                 "operands", "no_coef", "smem", "shape",
                                 "dtype", "rows", "groups", "primes_axis",
                                 "not_a_stack"])
def test_ntt_mul_rejects_bad_input(bad):
    q, n = CHAIN[1], 64
    z = functools.partial(torch.zeros, dtype=torch.int64)
    coef, ntt, terms, primes = z((3, 2, n)), None, ONE, q
    if bad == "term_index":
        terms = (((0, 2),),)
    elif bad == "no_term":
        terms = (((0, 1),), ())
    elif bad == "outputs":
        terms = ONE * (tkernel.MUL_MAX_OUT + 1)
    elif bad == "operands":
        coef = z((3, tkernel.MUL_MAX_IN + 1, n))
    elif bad == "no_coef":
        coef = z((3, 0, n))
        ntt = z((3, 2, n))
    elif bad == "smem":     # 6 rows of N = 8192 do not fit a CTA
        coef, primes = z((1, 6, tops.MAX_N)), gen_primes(tops.MAX_N, [29])[0]
    elif bad == "shape":
        ntt = z((3, 1, 2 * n))
    elif bad == "dtype":
        coef = coef.to(torch.int32)
    elif bad == "rows":
        coef = z((3, 2, 2 * n))[..., ::2]
    elif bad == "groups":   # (4, 3) groups 2 and 8 rows apart
        coef, primes = z((3, 4, 2, 1, n)).transpose(0, 1), (q,)
    elif bad == "primes_axis":
        primes = (q, CHAIN[2], CHAIN[0])
    else:
        coef = z(n)
    with pytest.raises((TypeError, ValueError)):
        tops.ntt_mul(coef, ntt, terms, primes)


@pytest.mark.parametrize("bad", ["coef_dtype", "ntt_dtype", "ntt_device"])
def test_ntt_mul_checks_every_call(bad):
    """A call whose operands have the shapes and strides of a call already
    planned, but another dtype or an NTT-domain stack on another device,
    is refused all the same: the plan is kept per dtype and device too."""
    q, n = CHAIN[1], 64
    rng = np.random.default_rng(5)
    coef = _t(_residues(rng, q, (3, 2, n)))
    ntt = _t(_residues(rng, q, (1, n)))
    terms = (((0, 2),), ((1, 2),))
    want = tops.ntt_mul(coef, ntt, terms, q)
    assert torch.equal(tops.ntt_mul(coef, ntt, terms, q), want)
    if bad == "coef_dtype":
        coef = coef.to(torch.int32)
    elif bad == "ntt_dtype":
        ntt = ntt.to(torch.int32)
    else:
        ntt = ntt.to("meta")
    with pytest.raises(ValueError):
        tops.ntt_mul(coef, ntt, terms, q)


def _sched_mul(host_lib, coef, ntt, terms, primes, stage: bool,
               teams: int = 1):
    """The card's fused kernel thread by thread on the host, over the
    wrapper's own tables: operands (G, P, N), returns (G, O, P, N)."""
    c_ = np.ascontiguousarray(np.stack(coef, axis=1).astype(np.int64))
    n_ = np.ascontiguousarray(np.stack(ntt, axis=1).astype(np.int64)) \
        if ntt else np.zeros((1, 1, 1, 2), np.int64)
    g, _, p, n = c_.shape
    t = tops.tables(tuple(primes), n, torch.device("cpu"))
    tw = np.ascontiguousarray(t.tw.numpy())
    c = np.ascontiguousarray(t.consts.numpy())
    ends, flat = [], []
    for out_terms in terms:
        flat += [i for term in out_terms for i in term]
        ends.append(len(flat) // 2)
    out = np.full((g, len(terms), p, n), -1, np.int64)
    half = n // 2
    desc = np.array([len(coef), len(coef) + len(ntt), len(terms), p, g,
                     int(stage), teams,
                     c_.ctypes.data, len(coef) * p * half, p * half,
                     n_.ctypes.data, len(ntt) * p * half, p * half,
                     out.ctypes.data, len(terms) * p * half, p * half,
                     tw.ctypes.data, c.ctypes.data, *ends, *flat],
                    dtype=np.int64)
    assert host_lib.sched_mul(desc.ctypes.data, n.bit_length() - 1) == 0
    return out.astype(np.uint64)


@pytest.mark.parametrize("n", RINGS)
def test_fused_schedule_on_host_every_ring(host_lib, n):
    """ntt_sched.cuh's MulThread (the fused kernel without the card), at
    every ring: a product a row (3 groups of the two primes' stacks), and
    relinearize's shape (two outputs, each a sum over two transformed
    digits against NTT-domain keys, the keys staged in shared memory where
    they fit and read from device memory where not), against the NumPy
    transform and the plain version."""
    p = CkksParams(n_ring=max(n, 64), levels=2)
    primes = [gen_primes(n, [29])[0], p.special_prime] if n < 64 else \
        [p.primes[0], p.special_prime]
    rng = np.random.default_rng(n + 1)

    def rows(k):
        return [np.stack([_residues(rng, q, (3, n)) for q in primes], axis=1)
                for _ in range(k)]
    logn = n.bit_length() - 1
    a, b = rows(2)
    got = _sched_mul(host_lib, [a, b], [], ONE, primes, False, 2)
    for j, q in enumerate(primes):
        assert np.array_equal(got[:, 0, j], _np_negacyclic(a[:, j], b[:, j],
                                                           q))
    assert np.array_equal(got.astype(np.int64), tops.ntt_mul(
        [_t(a), _t(b)], [], ONE, primes).numpy())
    digits, keys = rows(2), rows(4)
    terms = (((0, 2), (1, 3)), ((0, 4), (1, 5)))
    want = tops.ntt_mul([_t(x) for x in digits], [_t(x) for x in keys],
                        terms, primes).numpy()
    for stage, teams in ((False, 1), (True, 2), (True, 3)):
        if stage and tkernel.mul_smem_bytes(logn, 2, 4, True) > \
                tkernel.MUL_MAX_SMEM:
            continue
        got = _sched_mul(host_lib, digits, keys, terms, primes, stage,
                         teams)
        assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("n,n_coef,n_out,teams", [(64, 5, 5, 2),
                                                  (1024, 8, 3, 3),
                                                  (4096, 3, 3, 1),
                                                  (8192, 2, 2, 1)])
def test_fused_schedule_on_host_many_runs(host_lib, n, n_coef, n_out,
                                          teams):
    """More coefficient operands or outputs than a cluster has CTAs: each
    CTA runs several forward and inverse rows through the same exchange
    buffers, each output a sum over all the coefficient operands in its
    own order, read from the CTAs that hold them."""
    q = gen_primes(n, [29])[0]
    rng = np.random.default_rng(n + n_coef)
    xs = [_residues(rng, q, (2, 1, n)) for _ in range(n_coef)]
    terms = tuple(tuple((i, (i + o) % n_coef) for i in range(n_coef))
                  for o in range(n_out))
    got = _sched_mul(host_lib, xs, [], terms, [q], False, teams)
    want = tops.ntt_mul([_t(x) for x in xs], [], terms, (q,)).numpy()
    assert np.array_equal(got.astype(np.int64), want)
    f = [npntt.ntt_forward(x[:, 0], q) for x in xs]
    for o, out_terms in enumerate(terms):
        acc = np.zeros((2, n), np.uint64)
        for i, j in out_terms:
            acc = (acc + f[i] * f[j] % np.uint64(q)) % np.uint64(q)
        assert np.array_equal(got[:, o, 0], npntt.ntt_inverse(acc, q))


@pytest.mark.parametrize("n", RINGS)
def test_fused_layout_forward_last_is_inverse_first(host_lib, n):
    """The forward's last pass and the inverse's first hold the same
    elements in the same registers of the same thread (each element once),
    so the products need no exchange; a CTA's shared memory matches what
    the wrapper checks (kernel.mul_smem_bytes)."""
    got = np.zeros(7, np.int32)
    logn = n.bit_length() - 1
    assert host_lib.sched_mul_info(logn, got.ctypes.data) == 0
    threads, smem_staged, smem, fw_ahead, iv_ahead, differ, twice = \
        (int(x) for x in got)
    assert (differ, twice) == (0, 0)
    assert threads * (16 if n == 8192 else min(n, 8)) == n
    assert smem_staged == tkernel.mul_smem_bytes(logn, 3, 3, True)
    assert smem == tkernel.mul_smem_bytes(logn, 3, 2, False)
    # the forward's twiddles a pass ahead or more, but at N = 8192, where
    # the fused kernel loads each pass's as it starts (registers)
    assert fw_ahead >= 1 or n <= 8 if n < 8192 else fw_ahead == 0
