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
// What bounds it on this card: integer ALU work.  A garbled gate is four
// AES-128 passes (two for an evaluated gate); bitsliced, a pass needs at
// least ~360 32-bit three-input logic operations per block (the count in
// kernel.py), against 80 bytes of memory traffic per gate (two labels in, a
// label and a two-row table out; an evaluated gate reads two labels and a
// table and writes a label).  Even at that floor the ALU time is 3.6x the
// memory time for a garbled gate and 1.8x for an evaluated one, and the
// kernels' own circuits issue more, so the design spends nothing on the
// memory side: one thread per gate, each label one
// 16-byte load or store, the round keys in __constant__ memory (read at
// uniform addresses, so broadcast), the whole state in registers.  The
// main path launches tens of gates at a time, so a launch's time is one
// thread's latency: bitslicing cuts the S-box from a GF(2^8) inversion per
// byte to one 128-gate circuit for all 32 bytes of two blocks, and the
// garbler's four hashes run as two such passes.  SubBytes is lookup-free
// on purpose (see aes_ct.cuh): no T-tables in shared memory, no S-box
// indexed by state bytes, so execution stays oblivious to the labels.
//
// Launch discipline: each entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// so that the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "aes_ct.cuh"

namespace {

// 11 round keys as 8 bit planes each (16 bits, repeated in both halves)
__constant__ uint32_t c_rk[88];

constexpr int kThreads = 256;

__device__ __forceinline__ Label load_label(const uint4* p) {
  const uint4 v = *p;
  return {(uint64_t)v.x | ((uint64_t)v.y << 32),
          (uint64_t)v.z | ((uint64_t)v.w << 32)};
}

__device__ __forceinline__ void store_label(uint4* p, Label l) {
  *p = make_uint4((uint32_t)l.lo, (uint32_t)(l.lo >> 32), (uint32_t)l.hi,
                  (uint32_t)(l.hi >> 32));
}

__global__ void __launch_bounds__(kThreads)
    garble_and_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      uint64_t r_lo, uint64_t r_hi, uint64_t gid0,
                      uint4* __restrict__ c, uint4* __restrict__ tab,
                      int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  Label out, tg, te;
  half_gates_garble(load_label(a + i), load_label(b + i), Label{r_lo, r_hi},
                    gid0 + (uint64_t)i, c_rk, &out, &tg, &te);
  store_label(c + i, out);
  store_label(tab + 2 * i, tg);
  store_label(tab + 2 * i + 1, te);
}

__global__ void __launch_bounds__(kThreads)
    eval_and_kernel(const uint4* __restrict__ wa, const uint4* __restrict__ wb,
                    const uint4* __restrict__ tab, uint64_t gid0,
                    uint4* __restrict__ c, int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  store_label(c + i, half_gates_eval(load_label(wa + i), load_label(wb + i),
                                     load_label(tab + 2 * i),
                                     load_label(tab + 2 * i + 1),
                                     gid0 + (uint64_t)i, c_rk));
}

unsigned grid_for(int64_t m) { return (unsigned)((m + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// rk: 88 host words, the fixed key's schedule as bit planes (see kernel.py)
int gc_set_round_keys(const uint32_t* rk) {
  return (int)cudaMemcpyToSymbol(c_rk, rk, sizeof(c_rk));
}

int gc_garble_and(const void* a, const void* b, uint64_t r_lo, uint64_t r_hi,
                  uint64_t gid0, void* c, void* tab, int64_t m,
                  void* stream) {
  if (m <= 0) return 0;
  garble_and_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, r_lo, r_hi, gid0, (uint4*)c,
      (uint4*)tab, m);
  return (int)cudaGetLastError();
}

int gc_eval_and(const void* wa, const void* wb, const void* tab,
                uint64_t gid0, void* c, int64_t m, void* stream) {
  if (m <= 0) return 0;
  eval_and_kernel<<<grid_for(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)wa, (const uint4*)wb, (const uint4*)tab, gid0, (uint4*)c,
      m);
  return (int)cudaGetLastError();
}

const char* gc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
