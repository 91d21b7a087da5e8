// Half-gates garbling and evaluation on Hopper (sm_90a).
//
// Replaces the TPU kernels `_garble_kernel` and `_eval_kernel` of
// src/repro/kernels/garble/kernel.py: for m AND gates, the garbler hashes
// A0, A0^R, B0 and B0^R with fixed-key AES, H(x, j) = AES_k(2x ^ j) ^ 2x ^ j,
// and writes the output zero-label c and the table [TG | TE]; the evaluator
// hashes its two active labels and applies the table rows under their
// select bits.  The results are those of the NumPy gates
// (src/repro/protocols/garbled/gates.py), including the full 64-bit tweak
// j0 = 2 * (gid0 + i), j1 = j0 + 1 (the TPU path cuts it to 32 bits).
//
// What bounds it on this card: integer ALU work at throughput, one
// thread's latency on the main path.  A garbled gate is four AES-128 passes
// (two for an evaluated gate); bitsliced, a pass needs at least ~360 32-bit
// three-input logic operations per block (the count in kernel.py), against
// 80 bytes of memory traffic per gate (two labels in, a label and a two-row
// table out; an evaluated gate reads two labels and a table and writes a
// label).  Even at that floor the ALU time is 3.6x the memory time for a
// garbled gate and 1.8x for an evaluated one, so the design spends nothing
// on the memory side: each label one 16-byte load or store, the round keys
// a kernel parameter (operands of the logic instructions at fixed offsets
// of the parameter bank, which a launch brings with it, where __constant__
// memory would be fetched on first use), the whole state in registers.
// The main path launches 16 or 32 gates at a time, so a launch's time is
// one warp's latency: the instructions of one thread, issued one after
// another, one logic instruction per two cycles.  So each thread runs
// exactly one fixsliced two-block AES pass (aes_ct.cuh), fully unrolled.  The evaluator's two hashes fill one pass; the garbler's four
// take two, which run on two neighbouring lanes of one warp (lane 0 hashes
// A0 and A0^R, lane 1 B0 and B0^R), and one label exchanged by
// __shfl_xor_sync gives the output label.  Blocks hold at most four warps,
// one for each scheduler of an SM, and a small launch's block only the
// warps it needs, so no warp of a launch waits for another's issue slot.
// SubBytes is lookup-free on purpose (see aes_ct.cuh): no T-tables in
// shared memory, no S-box indexed by state bytes, so execution stays
// oblivious to the labels.
//
// Launch discipline: each entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "aes_ct.cuh"

namespace {

// 11 round keys as 8 bit planes each (see aes_ct.cuh and kernel.py), passed
// by value to every launch; the host keeps the copy gc_set_round_keys gave
struct RoundKeys {
  uint32_t w[88];
};
RoundKeys g_rk;

constexpr int kThreads = 128;

__device__ __forceinline__ Label load_label(const uint4* p) {
  const uint4 v = *p;
  return {(uint64_t)v.x | ((uint64_t)v.y << 32),
          (uint64_t)v.z | ((uint64_t)v.w << 32)};
}

__device__ __forceinline__ void store_label(uint4* p, Label l) {
  *p = make_uint4((uint32_t)l.lo, (uint32_t)(l.lo >> 32), (uint32_t)l.hi,
                  (uint32_t)(l.hi >> 32));
}

// two threads per gate: thread t works on gate t / 2 as lane t % 2
__global__ void __launch_bounds__(kThreads)
    garble_and_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      uint64_t r_lo, uint64_t r_hi, uint64_t gid0,
                      uint4* __restrict__ c, uint4* __restrict__ tab,
                      int64_t m, const RoundKeys rk) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = t >> 1;
  // lanes past the last gate redo it, so that every lane of the warp takes
  // part in the exchange; they store nothing
  const int64_t g = i < m ? i : m - 1;
  const uint32_t lane = (uint32_t)t & 1;
  Label tv, w;
  garble_lane(load_label(a + g), load_label(b + g), Label{r_lo, r_hi},
              gid0 + (uint64_t)g, lane, rk.w, &tv, &w);
  const Label other = {__shfl_xor_sync(0xFFFFFFFFu, w.lo, 1),
                       __shfl_xor_sync(0xFFFFFFFFu, w.hi, 1)};
  if (i < m) {
    store_label(tab + t, tv);              // [TG | TE]: lane 0, then lane 1
    if (lane == 0) store_label(c + i, lxor(w, other));
  }
}

__global__ void __launch_bounds__(kThreads)
    eval_and_kernel(const uint4* __restrict__ wa, const uint4* __restrict__ wb,
                    const uint4* __restrict__ tab, uint64_t gid0,
                    uint4* __restrict__ c, int64_t m, const RoundKeys rk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  store_label(c + i, half_gates_eval(load_label(wa + i), load_label(wb + i),
                                     load_label(tab + 2 * i),
                                     load_label(tab + 2 * i + 1),
                                     gid0 + (uint64_t)i, rk.w));
}

// the launch floor: a kernel that does nothing, timed beside the two
__global__ void empty_kernel() {}

// n threads in blocks of whole warps, at most kThreads each
dim3 block_for(int64_t n) {
  return dim3((unsigned)(n < kThreads ? (n + 31) / 32 * 32 : kThreads));
}
dim3 grid_for(int64_t n) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads));
}

}  // namespace

extern "C" {

// rk: 88 host words, the fixed key's schedule as bit planes (see kernel.py)
int gc_set_round_keys(const uint32_t* rk) {
  for (int i = 0; i < 88; ++i) g_rk.w[i] = rk[i];
  return 0;
}

int gc_garble_and(const void* a, const void* b, uint64_t r_lo, uint64_t r_hi,
                  uint64_t gid0, void* c, void* tab, int64_t m,
                  void* stream) {
  if (m <= 0) return 0;
  garble_and_kernel<<<grid_for(2 * m), block_for(2 * m), 0,
                      (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, r_lo, r_hi, gid0, (uint4*)c,
      (uint4*)tab, m, g_rk);
  return (int)cudaGetLastError();
}

int gc_eval_and(const void* wa, const void* wb, const void* tab,
                uint64_t gid0, void* c, int64_t m, void* stream) {
  if (m <= 0) return 0;
  eval_and_kernel<<<grid_for(m), block_for(m), 0, (cudaStream_t)stream>>>(
      (const uint4*)wa, (const uint4*)wb, (const uint4*)tab, gid0, (uint4*)c,
      m, g_rk);
  return (int)cudaGetLastError();
}

int gc_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* gc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
