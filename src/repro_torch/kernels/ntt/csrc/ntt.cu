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
// Per prime the wrapper keeps a (4, N) uint32 twiddle table on the device
// (psi powers and psi^-1 powers in bit-reversed order, each with its Shoup
// quotients) and one NttPrime row of constants (ntt_arith.cuh).  Any q below
// 2^31 works, the special prime P = 1073750017 included (the TPU kernel
// stops at 2^30).
//
// What bounds them on this card.  A transform of a row does N/2 log2 N
// butterflies of 11 integer operations (ntt_arith.cuh) on 16 bytes per
// coefficient of memory traffic (an int64 read and an int64 write): at
// N = 1024 that is 55 operations per 16 bytes, below the card's ratio of
// integer rate to HBM bandwidth (~5 operations per byte), so a large batch
// is bound by bytes; the product (14 operations per 24 bytes) is bound by
// bytes at any size.  The design keeps the whole row in shared memory
// (N <= 8192: 32 KiB as uint32) for all log2 N stages, one CTA per row and a
// __syncthreads between stages, so each coefficient crosses HBM once each
// way; the twiddles are read through the L1/L2 caches.  The main path
// launches 1 to a few tens of rows of N = 1024 at a time, where a launch's
// time is its latency (log2 N dependent stages), not either bound.
//
// Launch discipline: each entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_arith.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMulThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
    ntt_fwd_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ tw,
                   const NttPrime* __restrict__ primes, int n_primes,
                   int logn) {
  extern __shared__ uint32_t v[];
  const int n = 1 << logn;
  const int p = (int)(blockIdx.x % (unsigned)n_primes);
  const uint32_t q = primes[p].q;
  const uint32_t* psi = tw + (size_t)p * 4 * n;
  const uint32_t* psi_shoup = psi + n;
  const int64_t* src = in + (size_t)blockIdx.x * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) v[k] = (uint32_t)src[k];
  __syncthreads();
  for (int lt = logn - 1, m = 1; lt >= 0; --lt, m <<= 1) {
    for (int b = threadIdx.x; b < n / 2; b += blockDim.x)
      fwd_butterfly(v, lt, m, b, psi, psi_shoup, q);
    __syncthreads();
  }
  int64_t* dst = out + (size_t)blockIdx.x * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = (int64_t)v[k];
}

__global__ void __launch_bounds__(kMaxThreads)
    ntt_inv_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                   const uint32_t* __restrict__ tw,
                   const NttPrime* __restrict__ primes, int n_primes,
                   int logn) {
  extern __shared__ uint32_t v[];
  const int n = 1 << logn;
  const int p = (int)(blockIdx.x % (unsigned)n_primes);
  const NttPrime pr = primes[p];
  const uint32_t* psi = tw + ((size_t)p * 4 + 2) * n;
  const uint32_t* psi_shoup = psi + n;
  const int64_t* src = in + (size_t)blockIdx.x * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) v[k] = (uint32_t)src[k];
  __syncthreads();
  for (int lt = 0, h = n / 2; h >= 1; ++lt, h >>= 1) {
    for (int b = threadIdx.x; b < n / 2; b += blockDim.x)
      inv_butterfly(v, lt, h, b, psi, psi_shoup, pr.q);
    __syncthreads();
  }
  int64_t* dst = out + (size_t)blockIdx.x * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    dst[k] = (int64_t)shoup_mul(v[k], pr.n_inv, pr.n_inv_shoup, pr.q);
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

int ntt_threads(int logn) {
  const int half = 1 << (logn - 1);
  return half < kMaxThreads ? half : kMaxThreads;
}

}  // namespace

extern "C" {

// in, out: (rows, 2^logn) int64; tw: (n_primes, 4, 2^logn) uint32;
// primes: n_primes NttPrime rows.  Row r uses prime r % n_primes.
int ntt_forward(const void* in, void* out, const void* tw, const void* primes,
                int n_primes, int logn, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = sizeof(uint32_t) << logn;
  ntt_fwd_kernel<<<(unsigned)rows, ntt_threads(logn), smem,
                   (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)tw,
      (const NttPrime*)primes, n_primes, logn);
  return (int)cudaGetLastError();
}

int ntt_inverse(const void* in, void* out, const void* tw, const void* primes,
                int n_primes, int logn, int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = sizeof(uint32_t) << logn;
  ntt_inv_kernel<<<(unsigned)rows, ntt_threads(logn), smem,
                   (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)tw,
      (const NttPrime*)primes, n_primes, logn);
  return (int)cudaGetLastError();
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
