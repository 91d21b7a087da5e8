// Negacyclic NTT and modular products on Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/ntt/kernel.py:
//   ntt_fwd_kernel  <- _ntt_fwd_kernel   (Cooley-Tukey / Longa-Naehrig stages,
//                                         standard order in, bit-reversed out)
//   ntt_inv_kernel  <- _ntt_inv_kernel   (Gentleman-Sande stages, bit-reversed
//                                         in, standard out, then x N^-1)
//   mul_mod_kernel  <- _pointwise_kernel (a * b mod q, elementwise)
//   ntt_mul_kernel  <- repro.kernels.ntt.ops.negacyclic_mul (src/repro/
//                      kernels/ntt/ops.py:49): _ntt_fwd_kernel, then
//                      _pointwise_kernel, then _ntt_inv_kernel, in one
//                      launch, for sums of products too
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
// time, where a launch's time is its latency, not either bound: an empty
// kernel takes about half of a transform's.  So the cipher layer makes one
// fused launch of each product of polynomials (forward, product, inverse)
// instead of three, and the standalone product is left to key generation.
// The fused kernel does two forward transforms, a product and an inverse a
// row (some 184 operations a coefficient against 24 bytes of rows), so a
// large batch of it is bound by operations.
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
// The fused kernel's design (ntt_sched.cuh, MulThread): one cluster of
// CTAs for each prime of each group of a job, which computes every output
// of that prime and group from the operand stacks where they lie (base
// pointers and strides in the kernel's parameter, no gathers or copies
// before it).  Each CTA of the cluster is the transform's N / R threads
// and takes one row at a time, so the rows of one operation (the tensor
// product's four) go through their passes on as many SMs side by side,
// each as the transform kernels run it.  After the forward each thread
// stores its values of the row into the shared memory of each CTA whose
// outputs read it (distributed shared memory, stores that do not wait),
// and the NTT-domain operands and the inverse's twiddle table arrive there
// by cp.async while the first pass waits for its row, so after one
// cluster barrier each output's sum of products is formed from local
// shared memory, in registers, in the pair layout that the forward ends
// in and the inverse starts from; then the outputs go through the inverse
// passes and out.  The job (the operands' addresses and strides, the
// terms) is the kernel's parameter, copied into shared memory first: read
// where it is used, each line of it would stall on the constant cache.
//
// Where its time goes: at the CKKS main path's sizes a launch is latency;
// the fused kernel's phases each issue more than the standalone kernels'
// (the copies share the load/store pipe with the exchanges, the products
// read their operands through shared-memory loads), and a cluster barrier
// costs a GPU-wide memory fence.  PERF.md has the SM cycles per phase.
//
// The standalone product reads and writes 16 bytes (two coefficients) a
// thread and finds a unit's prime with one 32-bit % per row, not a 64-bit
// one per coefficient; small launches take one unit a thread in CTAs of
// 128, large ones two in CTAs of 256.
//
// Launch discipline: each entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper raises on a refused launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ntt_arith.cuh"
#include "ntt_sched.cuh"

namespace {

namespace cg = cooperative_groups;


using ntt_sched::MulJob;
using ntt_sched::MulThread;
using ntt_sched::NttThread;
using ntt_sched::Plan;

// the standalone product: from this many 16-byte units a launch takes two
// a thread in CTAs of 256 threads, below one a thread in CTAs of 128
constexpr int64_t kMulBigUnits = 1 << 18;

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

// The standalone product, for products whose result stays in the NTT
// domain (key generation).  Each thread multiplies PAIRS 16-byte units
// (two coefficients each) of a and b, a warp's lanes on consecutive units:
// small launches take one unit a thread in CTAs of 128 threads, so that
// their loads spread over as many SMs as they can; large ones two units a
// thread in CTAs of 256.  A CTA's units lie in one row when a row holds at
// least a CTA's units, so its prime is one 32-bit % a row; else each unit
// is its own row's.  b holds a row per row of a, or (b_rows == n_primes)
// one stack that every stack of a uses.
template <int THREADS, int PAIRS>
__global__ void __launch_bounds__(THREADS)
    mul_mod_kernel(const ntt_u4* __restrict__ a, const ntt_u4* __restrict__ b,
                   ntt_u4* __restrict__ out,
                   const NttPrime* __restrict__ primes, int n_primes,
                   int logn, int b_rows, int64_t units) {
  constexpr int kTile = THREADS * PAIRS;
  constexpr int kLogTile = kTile == 128 ? 7 : kTile == 512 ? 9 : -1;
  static_assert(kLogTile > 0, "a CTA's units: 128 or 512");
  const int64_t u0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  const int half = logn - 1;            // a row: 2^half 16-byte units
  const int64_t mask = ((int64_t)1 << half) - 1;
  const bool one_row = half >= kLogTile;  // the CTA's units in one row
  // every load first, so the thread waits for memory once
  uint32_t p[PAIRS];
  NttPrime pr[PAIRS];
  ntt_u4 x[PAIRS], y[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int64_t u = u0 + i * THREADS;
    p[i] = i && one_row ? p[0] : (uint32_t)(u >> half) % (uint32_t)n_primes;
    if (u < units) {
      const int64_t ub =
          b_rows == n_primes ? ((int64_t)p[i] << half) | (u & mask) : u;
      pr[i] = primes[p[i]];
      x[i] = __ldg(a + u);
      y[i] = __ldg(b + ub);
    }
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int64_t u = u0 + i * THREADS;
    if (u < units)
      out[u] = ntt_u4{mul_mod(x[i].x, y[i].x, pr[i]), 0u,
                      mul_mod(x[i].z, y[i].z, pr[i]), 0u};
  }
}

// The fused negacyclic product: a cluster of job.teams CTAs per (group,
// prime) of the job, blockIdx.x = cluster * teams + rank, running
// MulThread's phases (ntt_sched.cuh) with a barrier between them and a
// cluster barrier after the forward (whose last phase stores each row into
// every CTA's shared memory).  A single team is a plain launch.
template <int LOGN>
__global__ void __launch_bounds__(Plan<LOGN, false>::T)
    ntt_mul_kernel(const __grid_constant__ MulJob param) {
  using Th = MulThread<LOGN>;
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  // The job in shared memory, copied a word a thread: a kernel parameter
  // read where it is used waits for the constant cache, some 800 cycles
  // for each line it touches first; so the kernel waits once, here.
  __shared__ MulJob sjob;
  constexpr int kWords = sizeof(MulJob) / 4;
  for (int w = threadIdx.x; w < kWords; w += blockDim.x)
    reinterpret_cast<uint32_t*>(&sjob)[w] =
        reinterpret_cast<const uint32_t*>(&param)[w];
  __syncthreads();
  const MulJob& job = sjob;
  const bool multi = job.teams > 1;
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t team = multi ? cluster.block_rank() : 0;
  const uint32_t cta = blockIdx.x / (unsigned)job.teams;
  const uint32_t p = cta % (unsigned)job.n_primes;
  const uint32_t g = cta / (unsigned)job.n_primes;
  const ntt_u2* fwd = job.tw + (size_t)p * 2 * Th::N;
  const NttPrime* primes = job.primes;
  const auto peer = [&](int j, auto* ptr) {
    return multi ? cluster.map_shared_rank(ptr, j) : ptr;
  };
  Th th;
  const int runs_in = (job.n_coef + job.teams - 1) / job.teams;
  const int runs_out = (job.n_out + job.teams - 1) / job.teams;
  // Each run takes the thread's index and the tables anew (opaque): else
  // the compiler hoists every pass's twiddle addresses out of the loop,
  // and at 512 threads (N = 4096, 8192) spills them to local memory.
  for (int c = 0; c < runs_in; ++c) {
    const uint32_t tid = ntt_sched::opaque(threadIdx.x);
    const ntt_u2* tab = ntt_sched::opaque(fwd);
    ntt_sched::static_for<0, Th::NP>([&](auto e) {
      constexpr int E = decltype(e)::value;
      if (c || E) __syncthreads();
      th.template fwd_phase<E>(c, team, tid, job, g, p, tab, primes + p,
                               smem, peer);
    });
  }
  th.finish_forward();
  if (multi) cluster.sync(); else __syncthreads();
  for (int c = 0; c < runs_out; ++c) {
    const uint32_t tid = ntt_sched::opaque(threadIdx.x);
    const ntt_u2* tab = ntt_sched::opaque(fwd + Th::N);
    ntt_sched::static_for<0, Th::NP>([&](auto e) {
      constexpr int E = decltype(e)::value;
      if (c || E) __syncthreads();
      th.template inv_phase<E>(c, team, tid, job, g, p, tab, smem);
    });
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

template <int LOGN>
int launch_mul(const MulJob& job, int64_t clusters, cudaStream_t stream) {
  using Th = MulThread<LOGN>;
  const int n_ntt = job.n_in - job.n_coef;
  const int64_t smem = Th::smem_bytes(job.n_coef, n_ntt, job.stage_ntt);
  if (smem > ntt_sched::kMulMaxSmem) return (int)cudaErrorInvalidValue;
  // once per instantiation: the most dynamic shared memory any launch of
  // it may take (above 48 KiB with the kernel's own, a launch needs it)
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_mul_kernel<LOGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ntt_sched::kMulMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * job.teams));
  cfg.blockDim = dim3(Th::T);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)job.teams;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = job.teams > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ntt_mul_kernel<LOGN>, job);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int LOGN = 1>
int mul(int logn, const MulJob& job, int64_t ctas, cudaStream_t stream) {
  if constexpr (LOGN > ntt_sched::kMaxLogN) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (logn == LOGN)
      return launch_mul<LOGN>(job, ctas, stream);
    return mul<LOGN + 1>(logn, job, ctas, stream);
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

// a, out: (rows, 2^logn) int64 residues, b the same or (b_rows ==
// n_primes) one stack of n_primes rows; out = a * b mod q of each row.
// Every operand 16-byte aligned.
int ntt_mul_mod(const void* a, const void* b, void* out, const void* primes,
                int n_primes, int logn, int b_rows, int64_t rows,
                void* stream) {
  if (rows <= 0) return 0;
  const int64_t units = rows << (logn - 1);
  const bool big = units >= kMulBigUnits;
  const int64_t tile = big ? 512 : 128;
  const int64_t ctas = (units + tile - 1) / tile;
  if (ctas >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  auto kernel = big ? mul_mod_kernel<256, 2> : mul_mod_kernel<128, 1>;
  kernel<<<(unsigned)ctas, big ? 256 : 128, 0, (cudaStream_t)stream>>>(
      (const ntt_u4*)a, (const ntt_u4*)b, (ntt_u4*)out,
      (const NttPrime*)primes, n_primes, logn, b_rows, units);
  return (int)cudaGetLastError();
}

// The fused product of the job in desc (ntt_sched.cuh, parse_job: the
// operands, the output, the tables and the terms).
int ntt_mul(const int64_t* desc, int logn, void* stream) {
  MulJob job;
  int64_t groups;
  if (!ntt_sched::parse_job(desc, &job, &groups))
    return (int)cudaErrorInvalidValue;
  const int64_t clusters = groups * job.n_primes;
  if (clusters <= 0) return 0;
  if (clusters * job.teams >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  return mul(logn, job, clusters, (cudaStream_t)stream);
}

const char* ntt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
