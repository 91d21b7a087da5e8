// Paged decode attention on Hopper (sm_90a): GQA flash-decoding over a
// block table.
//
// Replaces the TPU kernel _kernel of src/repro/kernels/paged_attn/kernel.py
// (paged_decode_attention_pallas): for every sequence b and KV head h, the
// `group` query heads that share h attend over the first seq_lens[b] tokens
// of the KV pages that block_table[b] lists, with an online softmax (running
// max m, running sum l and accumulator acc, all float32), and the output is
// acc / max(l, 1e-30).  Masked scores are -1e30 there; here a masked
// position is not read at all, which gives the same result (its weight
// exp(-1e30 - m) is exactly 0 in float32) and never touches the unallocated
// tail of a block table.
//
// Layout (the reference's): q (batch, kv_heads, group, head_dim) float32;
// k_pages, v_pages (num_pages, page_size, kv_heads, head_dim) float32 or
// bfloat16; block_table (batch, max_pages) int32, entries of -1 past the
// sequence's pages; seq_lens (batch,) int32 in [1, max_pages * page_size];
// out (batch, kv_heads, group, head_dim) float32.
//
// What bounds it on this card.  One launch must read seq_len x kv_heads x
// head_dim x 2 (K and V) x sizeof(T) bytes of cache and does about 4 flops
// per byte of bf16 cache (group 6: two products of 6 rows per key), far
// below the card's ratio of compute to HBM bandwidth: it is bound by bytes.
// The design: one CTA of 128 threads per (sequence, KV head); the Pallas
// grid's page axis, which runs in order on a TPU core, is a loop inside the
// block.  Each page's K and V tiles (page_size x head_dim, 16 KiB each in
// bf16 at 64 x 128) are loaded into shared memory with 16-byte loads, the
// group x page_size scores come from one warp per key row (lanes across
// head_dim, a shuffle reduction per query head), one warp per query head
// updates m and l, and every thread updates its own elements of acc.  The
// block loads its own block-table row and length (the scalar prefetch's
// counterpart) and loops over ceil(seq_len / page_size) pages only.
// This simple design leaves most SMs idle at small batch (batch x kv_heads
// CTAs) and does not overlap a page's load with the previous page's math:
// split-K over pages and cp.async/TMA double-buffering are later work.
//
// Launch discipline: each entry point launches on the stream it is given,
// does not synchronise, allocates nothing, and returns the CUDA error code
// (0 on success) so that the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerLane = 8;          // head_dim <= 256, a multiple of 32
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Rows [0, rows) of head h in page `page` -> a dense (rows, head_dim) tile.
// A row is head_dim * sizeof(T) bytes, a multiple of 16 (the wrapper checks
// head_dim % 32 == 0 and 16-byte aligned bases).
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ pages,
                                          int page, int rows, int page_size,
                                          int kv_heads, int h, int head_dim) {
  const int vec_per_row = head_dim * (int)sizeof(T) / 16;
  const int total = rows * vec_per_row;
  const size_t row_stride = (size_t)kv_heads * head_dim;
  const T* base = pages + (size_t)page * page_size * row_stride +
                  (size_t)h * head_dim;
  for (int c = threadIdx.x; c < total; c += kThreads) {
    const int j = c / vec_per_row;
    const int v = c - j * vec_per_row;
    const uint4* src =
        reinterpret_cast<const uint4*>(base + (size_t)j * row_stride) + v;
    reinterpret_cast<uint4*>(dst + (size_t)j * head_dim)[v] = __ldg(src);
  }
}

size_t smem_bytes(size_t elem, int group, int head_dim, int page_size) {
  return 2 * (size_t)page_size * head_dim * elem      // K and V tiles
         + 2 * (size_t)group * head_dim * 4           // q, acc
         + (size_t)group * page_size * 4              // scores / weights
         + 3 * (size_t)group * 4;                     // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const float* __restrict__ q,
                      const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages,
                      const int32_t* __restrict__ block_table,
                      const int32_t* __restrict__ seq_lens,
                      float* __restrict__ out, int kv_heads, int group,
                      int head_dim, int page_size, int max_pages,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)page_size * head_dim;
  float* q_s = reinterpret_cast<float*>(v_s + (size_t)page_size * head_dim);
  float* acc_s = q_s + group * head_dim;
  float* p_s = acc_s + group * head_dim;
  float* m_s = p_s + group * page_size;
  float* l_s = m_s + group;
  float* a_s = l_s + group;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nd = head_dim / 32;
  const int gd = group * head_dim;
  const int seq_len = seq_lens[b];
  const int n_pages = (seq_len + page_size - 1) / page_size;
  const int32_t* bt = block_table + (size_t)b * max_pages;
  const float* qb = q + ((size_t)b * kv_heads + h) * gd;

  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = qb[i];
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int p = 0; p < n_pages; ++p) {
    const int page = bt[p];
    const int valid = min(page_size, seq_len - p * page_size);
    __syncthreads();   // the previous page's tiles and weights are consumed
    load_tile(k_s, k_pages, page, valid, page_size, kv_heads, h, head_dim);
    load_tile(v_s, v_pages, page, valid, page_size, kv_heads, h, head_dim);
    __syncthreads();

    // scores: one warp per key row, lanes across head_dim
    for (int j = warp; j < valid; j += kWarps) {
      float kr[kMaxDPerLane];
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i)
        kr[i] = i < nd ? to_f32(k_s[j * head_dim + lane + 32 * i]) : 0.f;
      for (int g = 0; g < group; ++g) {
        const float* qg = q_s + g * head_dim + lane;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDPerLane; ++i)
          if (i < nd) s = fmaf(qg[32 * i], kr[i], s);
        s = warp_sum(s);
        if (lane == 0) p_s[g * page_size + j] = s * scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < group; g += kWarps) {
      float* pg = p_s + g * page_size;
      float mx = kNegInf;
      for (int j = lane; j < valid; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < valid; j += 32) {
        const float e = expf(pg[j] - m_new);
        pg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V; each thread owns the same elements on
    // every page, so acc needs no barrier of its own
    for (int i = tid; i < gd; i += kThreads) {
      const int g = i / head_dim;
      const int d = i - g * head_dim;
      const float* pg = p_s + g * page_size;
      float a = acc_s[i] * a_s[g];
      for (int j = 0; j < valid; ++j)
        a = fmaf(pg[j], to_f32(v_s[j * head_dim + d]), a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  float* ob = out + ((size_t)b * kv_heads + h) * gd;
  for (int i = tid; i < gd; i += kThreads)
    ob[i] = acc_s[i] / fmaxf(l_s[i / head_dim], 1e-30f);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* block_table, const void* seq_lens, void* out,
           int batch, int kv_heads, int group, int head_dim, int page_size,
           int max_pages, float scale, void* stream) {
  if (batch <= 0) return 0;
  const size_t smem = smem_bytes(sizeof(T), group, head_dim, page_size);
  if (smem > kDefaultSmem) {
    // above 48 KiB only as opted-in dynamic shared memory; this also
    // refuses a tile larger than the card's per-block limit
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)kv_heads, (unsigned)batch);
  paged_attn_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const T*)k_pages, (const T*)v_pages,
      (const int32_t*)block_table, (const int32_t*)seq_lens, (float*)out,
      kv_heads, group, head_dim, page_size, max_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_attn_f32(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* seq_lens, void* out,
                   int batch, int kv_heads, int group, int head_dim,
                   int page_size, int max_pages, float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_table, seq_lens, out,
                       batch, kv_heads, group, head_dim, page_size,
                       max_pages, scale, stream);
}

int paged_attn_bf16(const void* q, const void* k_pages, const void* v_pages,
                    const void* block_table, const void* seq_lens, void* out,
                    int batch, int kv_heads, int group, int head_dim,
                    int page_size, int max_pages, float scale,
                    void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_table, seq_lens,
                               out, batch, kv_heads, group, head_dim,
                               page_size, max_pages, scale, stream);
}

const char* paged_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
