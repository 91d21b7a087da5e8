// Negacyclic NTT and modular products on Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/ntt/kernel.py:
//   ntt_fwd_kernel  <- _ntt_fwd_kernel   (Cooley-Tukey / Longa-Naehrig stages,
//                                         standard order in, bit-reversed out)
//   ntt_inv_kernel  <- _ntt_inv_kernel   (Gentleman-Sande stages, bit-reversed
//                                         in, standard out, then x N^-1)
//   mul_mod_kernel  <- _pointwise_kernel (a * b mod q, elementwise)
// They compute what repro.protocols.ckks.ntt computes, bit for bit.
//
// Rows.  The kernels read and write the engine's int64 rows directly (no
// conversion launches around them): a row of N coefficients, each a residue
// in [0, q) held in the low 32 bits.  The wrapper passes P primes; row r
// of the (rows, N) operand belongs to prime r % P, which is the layout
// (..., P, N) of every RNS polynomial stack of the cipher layer, so all
// primes of a level (and all components of a ciphertext) go in one launch.
// Per prime the wrapper keeps a (2, N, 2) uint32 twiddle table on the device
// (psi powers, then psi^-1 powers, in bit-reversed order, each beside its
// Shoup quotient) and one NttPrime row of constants (ntt_arith.cuh).  Any q
// below 2^31 works, the special prime P = 1073750017 included (the TPU
// kernel stops at 2^30).
//
// What bounds them on this card.  A transform of a row does N/2 log2 N
// butterflies of about 11 integer operations (ntt_arith.cuh) on 16 bytes per
// coefficient of memory traffic (an int64 read and an int64 write): at
// N = 1024 that is 55 operations per 16 bytes, below the card's ratio of
// integer rate to HBM bandwidth (~5 operations per byte), so a large batch
// is bound by bytes; the product (14 operations per 24 bytes) is bound by
// bytes at any size.  The main path launches 2 to 24 rows of N = 1024 at a
// time, where a launch's time is its latency, not either bound.
//
// The transforms' design (ntt_sched.cuh has the schedule): one CTA per row,
// N / R threads each holding R = 8 coefficients in registers (16 at
// N = 8192).  A thread runs log2 R stages a pass on its registers, and the
// threads exchange the row through shared memory between passes: 4
// barriers at N = 1024, where one stage a barrier took 10.  Every twiddle a
// thread needs is loaded at the start, beside the row, each with its Shoup
// quotient in one 8-byte load, so a launch waits on memory once and not
// once a stage (at N = 8192, where they would not fit in registers, a pass
// ahead).  The inverse folds N^-1 into its last stage (no scaling
// pass).  Rows come in and go out 16 bytes (two coefficients) a thread,
// a warp's lanes on consecutive pairs.  log2 N is the template parameter
// (R and the threads follow from it): N = 2 .. 8192 take the same kernel,
// one instantiation each.
//
// Launch discipline: each entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_arith.cuh"
#include "ntt_sched.cuh"

namespace {

using ntt_sched::NttThread;
using ntt_sched::Plan;

constexpr int kMulThreads = 256;

// One row per CTA, blockIdx.x the row; the phases of NttThread with a
// barrier between them.
template <int LOGN, bool INV>
__device__ __forceinline__ void transform_row(
    const int64_t* __restrict__ in, int64_t* __restrict__ out,
    const uint32_t* __restrict__ tw, const NttPrime* __restrict__ primes,
    int n_primes) {
  using Pl = Plan<LOGN, INV>;
  extern __shared__ uint32_t smem[];
  const unsigned p = blockIdx.x % (unsigned)n_primes;
  const size_t row = (size_t)blockIdx.x << LOGN;
  const ntt_u4* src = reinterpret_cast<const ntt_u4*>(in + row);
  ntt_u4* dst = reinterpret_cast<ntt_u4*>(out + row);
  const ntt_u2* tab =
      reinterpret_cast<const ntt_u2*>(tw) + ((size_t)p * 2 + INV) * Pl::N;
  NttThread<LOGN, INV> th;
  ntt_sched::static_for<0, Pl::NP>([&](auto e) {
    constexpr int E = decltype(e)::value;
    if constexpr (E > 0) __syncthreads();
    th.template phase<E>(threadIdx.x, src, dst, tab, primes + p, smem);
  });
}

template <int LOGN>
__global__ void __launch_bounds__(Plan<LOGN, false>::T)
    ntt_fwd_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ tw,
                   const NttPrime* __restrict__ primes, int n_primes) {
  transform_row<LOGN, false>(in, out, tw, primes, n_primes);
}

template <int LOGN>
__global__ void __launch_bounds__(Plan<LOGN, true>::T)
    ntt_inv_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ tw,
                   const NttPrime* __restrict__ primes, int n_primes) {
  transform_row<LOGN, true>(in, out, tw, primes, n_primes);
}

__global__ void __launch_bounds__(kMulThreads)
    mul_mod_kernel(const int64_t* __restrict__ a,
                   const int64_t* __restrict__ b, int64_t* __restrict__ out,
                   const NttPrime* __restrict__ primes, int n_primes,
                   int logn, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * kMulThreads;
  for (int64_t e = (int64_t)blockIdx.x * kMulThreads + threadIdx.x;
       e < total; e += stride) {
    const int p = (int)((e >> logn) % n_primes);
    out[e] = (int64_t)mul_mod((uint32_t)a[e], (uint32_t)b[e],
                              primes[p]);
  }
}

template <int LOGN, bool INV>
int launch_transform(const void* in, void* out, const void* tw,
                     const void* primes, int n_primes, int64_t rows,
                     cudaStream_t stream) {
  using Pl = Plan<LOGN, INV>;
  auto kernel = INV ? ntt_inv_kernel<LOGN> : ntt_fwd_kernel<LOGN>;
  if (Pl::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Pl::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)rows, Pl::T, Pl::kSmemBytes, stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)tw,
      (const NttPrime*)primes, n_primes);
  return (int)cudaGetLastError();
}

template <bool INV, int LOGN = 1>
int transform(int logn, const void* in, void* out, const void* tw,
              const void* primes, int n_primes, int64_t rows,
              cudaStream_t stream) {
  if constexpr (LOGN > ntt_sched::kMaxLogN) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (logn == LOGN)
      return launch_transform<LOGN, INV>(in, out, tw, primes, n_primes,
                                         rows, stream);
    return transform<INV, LOGN + 1>(logn, in, out, tw, primes, n_primes,
                                    rows, stream);
  }
}

}  // namespace

extern "C" {

// in, out: (rows, 2^logn) int64, 16-byte aligned; tw: (n_primes, 2, 2^logn,
// 2) uint32; primes: n_primes NttPrime rows.  Row r uses prime r % n_primes.
int ntt_forward(const void* in, void* out, const void* tw, const void* primes,
                int n_primes, int logn, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  return transform<false>(logn, in, out, tw, primes, n_primes, rows,
                          (cudaStream_t)stream);
}

int ntt_inverse(const void* in, void* out, const void* tw, const void* primes,
                int n_primes, int logn, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  return transform<true>(logn, in, out, tw, primes, n_primes, rows,
                         (cudaStream_t)stream);
}

// a, b, out: (rows, 2^logn) int64 residues; out = a * b mod q of each row.
int ntt_mul_mod(const void* a, const void* b, void* out, const void* primes,
                int n_primes, int logn, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  const int64_t total = rows << logn;
  int64_t blocks = (total + kMulThreads - 1) / kMulThreads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  mul_mod_kernel<<<(unsigned)blocks, kMulThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (int64_t*)out,
      (const NttPrime*)primes, n_primes, logn, total);
  return (int)cudaGetLastError();
}

const char* ntt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
