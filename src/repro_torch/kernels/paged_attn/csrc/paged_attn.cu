// Paged decode attention on Hopper (sm_90a): GQA flash-decoding over a
// block table, split over chunks of pages.
//
// Replaces the TPU kernel _kernel of src/repro/kernels/paged_attn/kernel.py
// (paged_decode_attention_pallas): for every sequence b and KV head h, the
// `group` query heads that share h attend over the first seq_lens[b] tokens
// of the KV pages that block_table[b] lists, with an online softmax (running
// max m, running sum l and accumulator acc, all float32), and the output is
// acc / max(l, 1e-30).  Masked scores are -1e30 there; here a masked
// position is not read at all (its row of the tile is zero-filled and its
// weight set to 0), which gives the same result (its weight exp(-1e30 - m)
// is exactly 0 in float32) and never touches the unallocated tail of a
// block table.
//
// Layout (the reference's): q (batch, kv_heads, group, head_dim) float32 or
// bfloat16 (bf16 is exact in float32, so this is the reference's f32 cast);
// k_pages, v_pages (num_pages, page_size, kv_heads, head_dim) float32 or
// bfloat16; block_table (batch, max_pages) int32, entries of -1 past the
// sequence's pages; seq_lens (batch,) int32 in [1, max_pages * page_size];
// out (batch, kv_heads, group, head_dim) float32.  head_dim is a multiple of
// 16 up to 256 (16-byte rows in both page types, whole mma k-steps), group
// at most 16 (two n-tiles of 8).
//
// The split plan (the host's: ops.prepare_tables).  Sequence b's pages are
// cut into chunks of chunk_pages pages; work item i is one chunk, items[i]
// = (its sequence, its first token, its end token, 1 if it is the
// sequence's only chunk), and sequence b owns items chunk_start[b] ..
// chunk_start[b+1] - 1.  The host picks chunk_pages from the lengths so
// that the grid of (items x kv_heads) CTAs fills the card: one page a CTA
// at a few pages, chunks of about 11 pages at the 32k-token batch.
//
// What bounds it on this card.  One launch must read seq_len x kv_heads x
// head_dim x 2 (K and V) x sizeof(T) bytes of cache and does about 4 flops
// per byte of bf16 cache (group 6: two products of 6 rows per key), far
// below the card's ratio of compute to HBM bandwidth (about 295 for bf16
// tensor cores): it is bound by bytes, and what matters is keeping enough
// bytes in flight on every SM.  The design:
//
// * Split-K over pages.  paged_attn_split_kernel runs one CTA per (work
//   item, KV head) and leaves a partial (m, l, acc) of group x (head_dim +
//   2) floats in a workspace; where a sequence has one chunk it writes the
//   output itself.  paged_attn_combine_kernel, one CTA per (query head, KV
//   head, sequence) and a thread per dim, merges a sequence's partials (m =
//   max m_i, l = sum l_i e^{m_i - m}, acc = sum acc_i e^{m_i - m}) and
//   writes acc / max(l, 1e-30).  The combine is a second kernel rather than the last CTA of a
//   sequence through an atomic ticket: the ticket needs counters that are
//   zero at entry (a memset launch per call, or a buffer kept across calls
//   and shared by every stream), and a second launch on the same stream
//   orders the partials with no fence and sums them in a fixed order.
// * Asynchronous page tiles.  A CTA has 1-4 warps; each warp owns 16 rows
//   (tokens) of every 16 x warps-token tile of its chunk, and runs its own
//   ring of kStages stages in dynamic shared memory: its K and V rows go
//   through cp.async (16 bytes a lane, .cg: L2 only), rows past the chunk
//   zero-filled, so tile t + 1 loads while tile t is computed.  Warps share
//   no tile, so the loop needs no block barrier, only __syncwarp.  The block
//   reads its own plan entry (one 16-byte load) and block-table entries
//   (lane r those of row r, one tile ahead of their loads); its q rows go
//   to shared memory while the first tiles load.  Shared rows are padded by
//   16 bytes, so the 8 rows an ldmatrix phase reads fall in 8 different
//   bank groups.
// * Tensor-core products for bf16 pages: mma.sync.m16n8k16 (bf16 in, f32
//   accumulate) with the long dimension on M: S^T = K q^T (16 keys x 8
//   query heads) and O^T = V^T P^T (16 dims x 8 query heads), so a group of
//   6 pads to N = 8.  K comes from shared memory through ldmatrix, V through
//   ldmatrix.trans.  q and P are float32 in the reference; rounding them to
//   bf16 alone would miss the float32 tolerance, so each is split into a
//   bf16 high and low part (x = hi + lo, 16 bits of mantissa) and every
//   product is two mma's, one per part.  K and V are exact in bf16.  P goes
//   from the score fragment (keys on rows) to the B fragment (keys on k)
//   with movmatrix.trans, in registers.
// * f32 pages (the parity runs) keep CUDA-core FMA, in the same fragment
//   layout, split and pipeline: no TF32 rounding.
// * The softmax runs on the score fragments: per tile, one three-step
//   shuffle max per query head over a warp's 16 keys; the running sums stay
//   per lane and are reduced once per chunk.  The warps' states merge in
//   shared memory at the end of the chunk.
//
// Launch discipline: each entry point launches on the stream it is given,
// does not synchronise, allocates nothing (the wrapper allocates the output
// and the workspace), and returns the CUDA error code (0 on success) so
// that the Python wrapper raises on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kRows = 16;              // tokens per warp per tile: mma's M
constexpr int kStages = 2;             // cp.async ring depth per warp
constexpr int kMaxMT = 16;             // head_dim / 16 <= 16
constexpr int kMaxCombineThreads = 256;  // a thread per dim
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

// Byte offsets of the split kernel's dynamic shared memory; host and device
// compute them alike.  [0, region): every warp's stages, reused at the end
// of the chunk for the warps' (acc, m, l); then q (bf16: hi rows, then lo
// rows).
struct Layout {
  int rs;        // bytes per K/V row in shared memory (padded)
  int qrs;       // bytes per q row
  int warp_stage;
  int q_off;
  int total;
  __host__ __device__ Layout(int elem, bool bf16, int nt, int nw, int hd) {
    rs = hd * elem + 16;
    warp_stage = 2 * kRows * rs;
    const int stages = kStages * nw * warp_stage;
    const int epi = nw * nt * 8 * (hd + 2) * 4;
    q_off = ((stages > epi ? stages : epi) + 15) / 16 * 16;
    qrs = bf16 ? hd * 2 + 16 : hd * 4 + 16;
    total = q_off + (bf16 ? 2 : 1) * nt * 8 * qrs;
  }
};

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int4* items;           // per chunk: sequence, first token, end, one
  const int32_t* chunk_start;  // (batch + 1,)
  const int32_t* block_table;  // (batch, max_pages)
  float* out;
  float* ws;
  int kv_heads, group, head_dim, page_size, max_pages, q_bf16;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-fills when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// An 8 x 8 bf16 matrix held as mma fragments (lane t: row t/4, columns
// 2(t%4), +1), transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> the bf16 pairs hi = bf16(x), lo = bf16(x - hi), element 0 in
// the low half (the fragment's lower column)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Fragment coordinates (lane = 4 gid + tig), for the score tile S^T (16
// keys x 8 query heads) and each 16-dim tile of O^T (16 dims x 8 heads):
// element e of a lane is row gid + 8 (e >> 1), column 2 tig + (e & 1).
template <typename T, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    paged_attn_split_kernel(const Params p) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int hd = p.head_dim;
  const int G = p.group;
  const int ps = p.page_size;
  const int MT = hd / 16;
  const Layout L((int)sizeof(T), kBf16, NT, nw, hd);

  const int item = blockIdx.x;
  const int h = blockIdx.y;
  const int4 it = p.items[item];   // one load: the chunk's whole plan
  const int b = it.x;
  const int t0 = it.y;
  const int t1 = it.z;
  const bool single = it.w != 0;
  const int32_t* bt = p.block_table + (size_t)b * p.max_pages;

  const int TK = nw * kRows;
  const int n_tiles = (t1 - t0 + TK - 1) / TK;
  const size_t tok_stride = (size_t)p.kv_heads * hd;   // elements per token
  const T* kbase = static_cast<const T*>(p.k_pages) + (size_t)h * hd;
  const T* vbase = static_cast<const T*>(p.v_pages) + (size_t)h * hd;
  const int cpr = hd * (int)sizeof(T) / 16;   // 16-byte pieces per row, even
  const int warp_off = warp * kStages * L.warp_stage;
  const uint32_t warp_u32 = smem_u32(smem) + warp_off;

  // lane r < 16: the element offset of row r of this warp's slice of tile
  // `tile` (its block-table entry read here), -1 past t1
  auto row_off = [&](int tile) -> long long {
    const int pos = t0 + tile * TK + warp * kRows + lane;
    if (lane >= kRows || tile >= n_tiles || pos >= t1) return -1;
    const int pi = pos / ps;
    return ((long long)bt[pi] * ps + (pos - pi * ps)) * (long long)tok_stride;
  };
  // this warp's rows of tile `tile` -> stage tile % kStages
  auto issue = [&](int tile, long long off) {
    const uint32_t kdst = warp_u32 + (tile % kStages) * L.warp_stage;
    const uint32_t vdst = kdst + kRows * L.rs;
    int r = lane / cpr;
    int col = lane - r * cpr;
    for (int c = lane; c < kRows * cpr; c += 32) {   // uniform trip count
      const long long o = __shfl_sync(kFull, off, r);
      const bool valid = o >= 0;
      const size_t e = valid ? (size_t)o + col * (16 / sizeof(T)) : 0;
      const uint32_t so = r * L.rs + col * 16;
      cp_async16(kdst + so, kbase + e, valid);
      cp_async16(vdst + so, vbase + e, valid);
      col += 32;
      while (col >= cpr) {
        col -= cpr;
        ++r;
      }
    }
  };

  // the first tiles' loads go out before q is read, so q's latency hides
  // behind them; the next tile's table entries are read one tile ahead
  long long next = row_off(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) issue(s, next);
    cp_async_commit();
    next = row_off(s + 1);
  }

  // q rows (zero rows up to 8 NT), four elements a thread at a time
  const size_t q0 = ((size_t)b * p.kv_heads + h) * G * hd;
  for (int i = threadIdx.x * 4; i < NT * 8 * hd; i += blockDim.x * 4) {
    const int g = i / hd;
    const int d = i - g * hd;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (g < G) {
      if (p.q_bf16) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(p.q) + q0 + i);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x[0] = a.x;
        x[1] = a.y;
        x[2] = c.x;
        x[3] = c.y;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(
            static_cast<const float*>(p.q) + q0 + i);
        x[0] = f.x;
        x[1] = f.y;
        x[2] = f.z;
        x[3] = f.w;
      }
    }
    if constexpr (kBf16) {
      uint32_t hi[2], lo[2];
      split_pair(x[0], x[1], hi[0], lo[0]);
      split_pair(x[2], x[3], hi[1], lo[1]);
      *reinterpret_cast<uint2*>(smem + L.q_off + g * L.qrs + d * 2) =
          make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(smem + L.q_off + (NT * 8 + g) * L.qrs +
                                d * 2) = make_uint2(lo[0], lo[1]);
    } else {
      *reinterpret_cast<float4*>(smem + L.q_off + g * L.qrs + d * 4) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
  __syncthreads();

  float m[NT][2], l[NT][2], acc[kMaxMT][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[nt][c] = kNegInf;
      l[nt][c] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1, next);
    cp_async_commit();
    next = row_off(t + kStages);
    cp_async_wait<kStages - 1>();   // tile t has landed (this lane's part)
    __syncwarp();                   // ... and every lane's
    const int st_off = warp_off + (t % kStages) * L.warp_stage;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

    // ---- scores S^T = K q^T (16 keys x 8 NT heads) ----
    if constexpr (kBf16) {
      const uint32_t a_addr =
          smem_u32(smem) + st_off + (lane & 15) * L.rs + (lane >> 4) * 16;
      const uint32_t b_addr =
          smem_u32(smem) + L.q_off +
          ((lane >> 4) * NT * 8 + (lane & 7)) * L.qrs + ((lane >> 3) & 1) * 16;
#pragma unroll 4
      for (int kk = 0; kk < MT; ++kk) {
        uint32_t a[4];
        ldsm_x4(a_addr + kk * 32, a);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bq[4];   // hi (k 0-7, 8-15), lo (k 0-7, 8-15)
          ldsm_x4(b_addr + nt * 8 * L.qrs + kk * 32, bq);
          mma_bf16(s[nt], a, bq[0], bq[1]);
          mma_bf16(s[nt], a, bq[2], bq[3]);
        }
      }
    } else {
      const float* k0 =
          reinterpret_cast<const float*>(smem + st_off + gid * L.rs);
      const float* k1 =
          reinterpret_cast<const float*>(smem + st_off + (gid + 8) * L.rs);
#pragma unroll 2
      for (int d = 0; d < hd; d += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(k0 + d);
        const float4 kb = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const unsigned char* qr = smem + L.q_off + (nt * 8 + 2 * tig) * L.qrs;
          const float4 qa = *reinterpret_cast<const float4*>(qr + d * 4);
          const float4 qb =
              *reinterpret_cast<const float4*>(qr + L.qrs + d * 4);
          s[nt][0] = dot4(ka, qa, s[nt][0]);
          s[nt][1] = dot4(ka, qb, s[nt][1]);
          s[nt][2] = dot4(kb, qa, s[nt][2]);
          s[nt][3] = dot4(kb, qb, s[nt][3]);
        }
      }
    }

    // ---- online softmax over the warp's 16 keys; s becomes P ----
    const int key = t0 + t * TK + warp * kRows + gid;
    const bool v0 = key < t1;
    const bool v1 = key + 8 < t1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x0 = s[nt][c] * p.scale;
        const float x1 = s[nt][2 + c] * p.scale;
        float mx = fmaxf(v0 ? x0 : kNegInf, v1 ? x1 : kNegInf);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
        const float mn = fmaxf(m[nt][c], mx);
        const float alpha = expf(m[nt][c] - mn);
        const float p0 = v0 ? expf(x0 - mn) : 0.f;
        const float p1 = v1 ? expf(x1 - mn) : 0.f;
        l[nt][c] = l[nt][c] * alpha + p0 + p1;
        m[nt][c] = mn;
        s[nt][c] = p0;
        s[nt][2 + c] = p1;
#pragma unroll
        for (int mt = 0; mt < kMaxMT; ++mt) {
          if (mt < MT) {
            acc[mt][nt][c] *= alpha;
            acc[mt][nt][2 + c] *= alpha;
          }
        }
      }
    }

    // ---- O^T += V^T P^T (16 dims x 8 NT heads per dim tile) ----
    if constexpr (kBf16) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t h01, l01, h23, l23;
        split_pair(s[nt][0], s[nt][1], h01, l01);   // keys gid
        split_pair(s[nt][2], s[nt][3], h23, l23);   // keys gid + 8
        bh[nt][0] = movmatrix_trans(h01);
        bh[nt][1] = movmatrix_trans(h23);
        bl[nt][0] = movmatrix_trans(l01);
        bl[nt][1] = movmatrix_trans(l23);
      }
      const uint32_t v_addr = smem_u32(smem) + st_off + kRows * L.rs +
                              ((lane & 7) + (lane >> 4) * 8) * L.rs +
                              ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int mt = 0; mt < kMaxMT; ++mt) {
        if (mt < MT) {
          uint32_t a[4];
          ldsm_x4_trans(v_addr + mt * 32, a);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(acc[mt][nt], a, bh[nt][0], bh[nt][1]);
            mma_bf16(acc[mt][nt], a, bl[nt][0], bl[nt][1]);
          }
        }
      }
    } else {
      const unsigned char* vt = smem + st_off + kRows * L.rs;
#pragma unroll 2
      for (int j = 0; j < kRows; ++j) {
        float pa[NT], pb[NT];   // P[key j][heads 2 tig, 2 tig + 1]
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          pa[nt] = __shfl_sync(kFull, j < 8 ? s[nt][0] : s[nt][2],
                               (j & 7) * 4 + tig);
          pb[nt] = __shfl_sync(kFull, j < 8 ? s[nt][1] : s[nt][3],
                               (j & 7) * 4 + tig);
        }
        const float* vr = reinterpret_cast<const float*>(vt + j * L.rs);
#pragma unroll
        for (int mt = 0; mt < kMaxMT; ++mt) {
          if (mt < MT) {
            const float va = vr[mt * 16 + gid];
            const float vb = vr[mt * 16 + gid + 8];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              acc[mt][nt][0] = fmaf(va, pa[nt], acc[mt][nt][0]);
              acc[mt][nt][1] = fmaf(va, pb[nt], acc[mt][nt][1]);
              acc[mt][nt][2] = fmaf(vb, pa[nt], acc[mt][nt][2]);
              acc[mt][nt][3] = fmaf(vb, pb[nt], acc[mt][nt][3]);
            }
          }
        }
      }
    }
    __syncwarp();   // the stage is read before the next issue refills it
  }
  cp_async_wait<0>();

  // ---- merge the warps' states; write the output or the partial ----
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x = l[nt][c];
      x += __shfl_xor_sync(kFull, x, 4);
      x += __shfl_xor_sync(kFull, x, 8);
      x += __shfl_xor_sync(kFull, x, 16);
      l[nt][c] = x;
    }
  }
  __syncthreads();   // every warp is done with its stages: reuse them
  const int GP = NT * 8;
  float* e_acc = reinterpret_cast<float*>(smem);   // (nw, GP, hd)
  float* e_m = e_acc + nw * GP * hd;               // (nw, GP)
  float* e_l = e_m + nw * GP;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int g = nt * 8 + 2 * tig;
    float* w0 = e_acc + (warp * GP + g) * hd;
#pragma unroll
    for (int mt = 0; mt < kMaxMT; ++mt) {
      if (mt < MT) {
        const int d = mt * 16 + gid;
        w0[d] = acc[mt][nt][0];
        w0[hd + d] = acc[mt][nt][1];
        w0[d + 8] = acc[mt][nt][2];
        w0[hd + d + 8] = acc[mt][nt][3];
      }
    }
    if (gid == 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        e_m[warp * GP + g + c] = m[nt][c];
        e_l[warp * GP + g + c] = l[nt][c];
      }
    }
  }
  __syncthreads();
  const int gd = G * hd;
  float* dst = single ? p.out + ((size_t)b * p.kv_heads + h) * gd
                      : p.ws + ((size_t)item * p.kv_heads + h) * (gd + 2 * G);
  for (int i = threadIdx.x; i < gd; i += blockDim.x) {
    const int g = i / hd;
    const int d = i - g * hd;
    float mx = kNegInf;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, e_m[w * GP + g]);
    float sum = 0.f, a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float f = expf(e_m[w * GP + g] - mx);
      sum = fmaf(e_l[w * GP + g], f, sum);
      a = fmaf(e_acc[(w * GP + g) * hd + d], f, a);
    }
    if (single) {
      dst[i] = a / fmaxf(sum, 1e-30f);
    } else {
      dst[i] = a;
      if (d == 0) {
        dst[gd + g] = mx;
        dst[gd + G + g] = sum;
      }
    }
  }
}

// Sum (or max) over the block; every thread gets the result.  `red` holds
// one float per warp.
__device__ __forceinline__ float block_reduce(float x, float* red,
                                              bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();   // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// One CTA per (query head, KV head, sequence), a thread per dim: merge the
// sequence's chunk partials (per chunk and KV head: acc (group, head_dim),
// then m (group), then l (group)) in chunk order.  Sequences of one chunk
// were written by the split kernel.
__global__ void __launch_bounds__(kMaxCombineThreads)
    paged_attn_combine_kernel(const Params p) {
  extern __shared__ float w_s[];   // per chunk: e^{m_i - m}
  __shared__ float red[kMaxCombineThreads / 32];
  const int g = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int first = p.chunk_start[b];
  const int n = p.chunk_start[b + 1] - first;
  if (n <= 1) return;
  const int G = p.group;
  const int hd = p.head_dim;
  const int gd = G * hd;
  const size_t stride = (size_t)p.kv_heads * (gd + 2 * G);   // next chunk
  const float* base = p.ws + (size_t)first * stride + (size_t)h * (gd + 2 * G);
  float mx = kNegInf;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float mc = base[c * stride + gd + g];
    w_s[c] = mc;
    mx = fmaxf(mx, mc);
  }
  mx = block_reduce(mx, red, true);
  float sum = 0.f;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const float f = expf(w_s[c] - mx);
    w_s[c] = f;
    sum = fmaf(base[c * stride + gd + G + g], f, sum);
  }
  sum = block_reduce(sum, red, false);   // its barriers publish w_s
  float* o = p.out + (((size_t)b * p.kv_heads + h) * G + g) * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    const float* pc = base + g * hd + d;
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < n; ++c) a = fmaf(pc[c * stride], w_s[c], a);
    o[d] = a / fmaxf(sum, 1e-30f);
  }
}

int optin_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

// Dynamic shared memory above 48 KiB is opted into per kernel; `opted`
// keeps the most a process has asked for (raised, never lowered; a race
// sets it twice).
template <typename K>
int opt_in(K kernel, int bytes, int& opted) {
  if (bytes <= opted) return 0;
  if (bytes > optin_smem()) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  opted = bytes;
  return 0;
}

template <typename T, int NT>
int launch_split(const Params& p, int n_items, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  // the most warps whose stages fit the card's per-block shared memory
  const int limit = optin_smem();
  int nw = kMaxWarps;
  while (nw > 1 &&
         Layout((int)sizeof(T), kBf16, NT, nw, p.head_dim).total > limit)
    nw /= 2;
  const int smem = Layout((int)sizeof(T), kBf16, NT, nw, p.head_dim).total;
  static int opted = 48 * 1024;
  const int err = opt_in(paged_attn_split_kernel<T, NT>, smem, opted);
  if (err != 0) return err;
  const dim3 grid((unsigned)n_items, (unsigned)p.kv_heads);
  paged_attn_split_kernel<T, NT><<<grid, nw * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* items, const void* chunk_start,
           const void* block_table, void* out, void* ws, int batch,
           int kv_heads, int group, int head_dim, int page_size,
           int max_pages, int n_items, int max_chunks, int q_bf16,
           float scale, void* stream) {
  if (batch <= 0 || n_items <= 0) return 0;
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.items = static_cast<const int4*>(items);
  p.chunk_start = static_cast<const int32_t*>(chunk_start);
  p.block_table = static_cast<const int32_t*>(block_table);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<float*>(ws);
  p.kv_heads = kv_heads;
  p.group = group;
  p.head_dim = head_dim;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.q_bf16 = q_bf16;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = group <= 8 ? launch_split<T, 1>(p, n_items, st)
                       : launch_split<T, 2>(p, n_items, st);
  if (err != 0 || max_chunks <= 1) return err;
  const int smem = max_chunks * (int)sizeof(float);
  static int opted = 48 * 1024;
  err = opt_in(paged_attn_combine_kernel, smem, opted);
  if (err != 0) return err;
  const int threads = (head_dim + 31) / 32 * 32;
  paged_attn_combine_kernel<<<dim3((unsigned)group, (unsigned)kv_heads,
                                   (unsigned)batch),
                              threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// items: (n_items, 4) int32 (sequence, first token, end token, 1 if the
// sequence has one chunk); chunk_start (batch + 1,) int32; ws: n_items x
// kv_heads x group x (head_dim + 2) floats where max_chunks > 1.
int paged_attn_f32(const void* q, const void* k_pages, const void* v_pages,
                   const void* items, const void* chunk_start,
                   const void* block_table, void* out, void* ws, int batch,
                   int kv_heads, int group, int head_dim, int page_size,
                   int max_pages, int n_items, int max_chunks, int q_bf16,
                   float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, items, chunk_start, block_table,
                       out, ws, batch, kv_heads, group, head_dim, page_size,
                       max_pages, n_items, max_chunks, q_bf16, scale, stream);
}

int paged_attn_bf16(const void* q, const void* k_pages, const void* v_pages,
                    const void* items, const void* chunk_start,
                    const void* block_table, void* out, void* ws, int batch,
                    int kv_heads, int group, int head_dim, int page_size,
                    int max_pages, int n_items, int max_chunks, int q_bf16,
                    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, items, chunk_start,
                               block_table, out, ws, batch, kv_heads, group,
                               head_dim, page_size, max_pages, n_items,
                               max_chunks, q_bf16, scale, stream);
}

const char* paged_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
