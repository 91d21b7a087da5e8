// The per-thread schedule of the NTT kernels in ntt.cu: which coefficients
// a thread holds in each pass, which twiddles it loads, and the exchanges
// between passes.
//
// A CTA transforms one row of N = 2^LOGN coefficients with T = N / R
// threads, each holding R = 2^LOGR coefficients in registers.  There is one
// butterfly stage per element bit b (it pairs j and j + 2^b): the forward
// (Cooley-Tukey) runs bits LOGN-1 .. 0, the inverse (Gentleman-Sande) bits
// 0 .. LOGN-1.  The stages are grouped into passes.  In a pass a thread
// holds the R coefficients whose indices differ only in the pass's register
// bits, so it runs the pass's stages on its own registers with no barrier;
// between passes the threads exchange the row through shared memory, one
// barrier each.
//
// Layouts.  A pass's layout is the list of element bits its register bits
// hold, ascending; thread tid's bits fill the other element bits in
// ascending order.  The first and the last pass use the pair layout P:
// element bit 0 and the top LOGR-1 bits in registers, so registers 2c and
// 2c+1 are neighbours in memory (one 16-byte access of two int64
// coefficients) and a warp's lanes take consecutive pairs.  The forward runs
// the top LOGR-1 stages in P, the middle bits LOGN-LOGR .. 1 in chunks of
// LOGR (a short chunk first, padded with the lowest free bits), then stage 0
// in P again; the inverse runs the same passes in the opposite order.  At
// N = 1024 (LOGR 3, 128 threads) the forward is
//   P {0,8,9}: 9 8 | {0,1,7}: 7 | {4,5,6}: 6 5 4 | {1,2,3}: 3 2 1 | P: 0
// four barriers where a stage a barrier takes ten.
//
// Twiddles.  Stage b of element j (bit b clear) uses table entry
// (N | j) >> (b + 1).  Its bits above b come from the thread id and from the
// register bits above b, so a thread needs 2^(register bits above b)
// twiddles in that stage, at addresses it knows from tid alone.  It loads
// them (each with its Shoup quotient, one 8-byte load) at the start, beside
// the row, so a launch waits for memory once; in the forward's first pass
// (the inverse's last) every thread loads the same ones.  Where they would
// not fit in registers (N = 8192) each pass's are loaded one pass ahead.
// The inverse's last stage (b = LOGN-1) loads none: its twiddle is in the
// prime's constants with N^-1 folded in (ntt_arith.cuh, gs_last).
//
// Exchanges.  Exchange e writes pass e's registers to shared buffer e % 2
// and pass e+1 reads them back in its own layout (two buffers, so one
// barrier per exchange suffices).  Addresses are XOR-swizzled: element bit
// h >= 5 flips the bank bits by a column chosen so that every warp access,
// written and read, hits 32 different banks.
//
// The schedule is computed at compile time (constexpr); the per-thread code
// is plain C++ on uint32, so a host compiler runs the same code thread by
// thread (tests/test_torch_ntt.py builds it with g++).
#pragma once

#include <stdint.h>

#include "ntt_arith.cuh"

#if defined(__CUDACC__)
#include <vector_types.h>
typedef uint4 ntt_u4;
typedef uint2 ntt_u2;
#define NTT_TD __device__ __forceinline__
#else
struct alignas(16) ntt_u4 { uint32_t x, y, z, w; };
struct alignas(8) ntt_u2 { uint32_t x, y; };
#define NTT_TD inline
#endif

namespace ntt_sched {

constexpr int kMaxLogN = 13;
constexpr int kMaxLogR = 4;
constexpr int kMaxPasses = 6;

// log2 of the coefficients a thread holds: every coefficient of a row of up
// to 8; else 8, and 16 at N = 8192 (512 threads; 1024 could keep 64
// registers each)
NTT_HD constexpr int log_regs(int logn) {
  return logn <= 3 ? logn : logn == kMaxLogN ? 4 : 3;
}

struct Sched {
  int logr, n_passes;
  int reg_bit[kMaxPasses][kMaxLogR];    // element bit of register bit i
  int n_stages[kMaxPasses];
  int stage_bit[kMaxPasses][kMaxLogR];  // the pass's stages, in order
  uint32_t swz[kMaxPasses][kMaxLogN];   // exchange e: bank column of bit h
};

NTT_HD constexpr bool held(const Sched& s, int p, int b) {
  for (int i = 0; i < s.logr; ++i)
    if (s.reg_bit[p][i] == b) return true;
  return false;
}

// {x ^ v : x in span} added to span, a set of 5-bit vectors as a mask
NTT_HD constexpr uint32_t span_with(uint32_t span, uint32_t v) {
  uint32_t out = span;
  for (uint32_t x = 0; x < 32; ++x)
    if (span >> x & 1u) out |= 1u << (x ^ v);
  return out;
}

// the element bits a warp's lanes run over in pass p: the lowest five
// bits the registers do not hold
NTT_HD constexpr uint32_t lane_bits(const Sched& s, int logn, int p) {
  uint32_t m = 0;
  for (int b = 0, n = 0; b < logn && n < 5; ++b)
    if (!held(s, p, b)) {
      m |= 1u << b;
      ++n;
    }
  return m;
}

NTT_HD constexpr Sched make_sched(int logn, bool inverse, bool swizzle) {
  Sched s{};
  const int rb = log_regs(logn), tb = logn - rb;
  s.logr = rb;
  // the forward order first; pass 0: P, its top stages (all when tb == 0)
  for (int i = 0; i < rb; ++i) s.reg_bit[0][i] = i ? logn - rb + i : 0;
  for (int b = logn - 1; b >= (tb ? logn - rb + 1 : 0); --b)
    s.stage_bit[0][s.n_stages[0]++] = b;
  int np = 1;
  if (tb) {
    for (int hi = tb, size = tb % rb ? tb % rb : rb; hi >= 1;
         hi -= size, size = rb) {
      const int lo = hi - size + 1;
      uint32_t mask = 0;
      for (int b = lo; b <= hi; ++b) mask |= 1u << b;
      for (int b = 0, pad = rb - size; b < logn && pad; ++b)
        if (!(mask >> b & 1u)) {
          mask |= 1u << b;
          --pad;
        }
      for (int b = 0, i = 0; b < logn; ++b)
        if (mask >> b & 1u) s.reg_bit[np][i++] = b;
      for (int b = hi; b >= lo; --b) s.stage_bit[np][s.n_stages[np]++] = b;
      ++np;
    }
    for (int i = 0; i < rb; ++i) s.reg_bit[np][i] = s.reg_bit[0][i];
    s.stage_bit[np][s.n_stages[np]++] = 0;
    ++np;
  }
  s.n_passes = np;
  if (inverse) {
    for (int p = 0; p < np / 2; ++p) {
      const int o = np - 1 - p;
      for (int i = 0; i < kMaxLogR; ++i) {
        const int r = s.reg_bit[p][i], t = s.stage_bit[p][i];
        s.reg_bit[p][i] = s.reg_bit[o][i];
        s.reg_bit[o][i] = r;
        s.stage_bit[p][i] = s.stage_bit[o][i];
        s.stage_bit[o][i] = t;
      }
      const int n = s.n_stages[p];
      s.n_stages[p] = s.n_stages[o];
      s.n_stages[o] = n;
    }
    for (int p = 0; p < np; ++p)
      for (int i = 0, j = s.n_stages[p] - 1; i < j; ++i, --j) {
        const int t = s.stage_bit[p][i];
        s.stage_bit[p][i] = s.stage_bit[p][j];
        s.stage_bit[p][j] = t;
      }
  }
  // bank columns: greedily, for each high lane bit of either side, the
  // smallest vector outside the span the side's lanes already reach (it
  // exists: each span has at most 16 of the 32 vectors before its fifth)
  for (int e = 0; swizzle && e + 1 < np; ++e) {
    const uint32_t lx = lane_bits(s, logn, e), ly = lane_bits(s, logn, e + 1);
    uint32_t vx = 1, vy = 1;
    for (int b = 0; b < 5; ++b) {
      if (lx >> b & 1u) vx = span_with(vx, 1u << b);
      if (ly >> b & 1u) vy = span_with(vy, 1u << b);
    }
    for (int h = 5; h < logn; ++h) {
      const bool in_x = lx >> h & 1u, in_y = ly >> h & 1u;
      if (!in_x && !in_y) continue;
      uint32_t v = 1;
      while ((in_x && (vx >> v & 1u)) || (in_y && (vy >> v & 1u))) ++v;
      s.swz[e][h] = v;
      if (in_x) vx = span_with(vx, v);
      if (in_y) vy = span_with(vy, v);
    }
  }
  return s;
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// f(Int<B>{}), ..., f(Int<E-1>{}): loops whose index must be a constant
template <int B, int E, typename F>
NTT_TD void static_for(F&& f) {
  if constexpr (B < E) {
    f(Int<B>{});
    static_for<B + 1, E>(f);
  }
}

// Queries on a schedule, each reading one Sched value.
NTT_HD constexpr uint32_t reg_elem(const Sched& s, int p, int k) {
  uint32_t j = 0;
  for (int i = 0; i < s.logr; ++i)
    j |= (uint32_t)(k >> i & 1) << s.reg_bit[p][i];
  return j;
}

NTT_HD constexpr int reg_of(const Sched& s, int p, int b) {
  for (int i = 0; i < s.logr; ++i)
    if (s.reg_bit[p][i] == b) return i;
  return -1;
}

// register bits holding element bits above stage t's
NTT_HD constexpr int above(const Sched& s, int p, int t) {
  int m = 0;
  for (int i = 0; i < s.logr; ++i)
    if (s.reg_bit[p][i] > s.stage_bit[p][t]) m |= 1 << i;
  return m;
}

// twiddles stage t loads: one per value of the register bits above it, and
// none in the inverse's last stage (folded, no table entry)
NTT_HD constexpr int n_slots(const Sched& s, int logn, bool inv, int p,
                             int t) {
  int c = 0;
  for (int m = above(s, p, t); m; m &= m - 1) ++c;
  return inv && s.stage_bit[p][t] == logn - 1 ? 0 : 1 << c;
}

NTT_HD constexpr int slot_base(const Sched& s, int logn, bool inv, int p,
                               int t) {
  int n = 0;
  for (int u = 0; u < t; ++u) n += n_slots(s, logn, inv, p, u);
  return n;
}

// twiddles of a pass: the most (at least 1) or the sum over the passes
NTT_HD constexpr int slots(int logn, bool inv, bool total) {
  const Sched s = make_sched(logn, inv, false);
  int most = 1, sum = 0;
  for (int p = 0; p < s.n_passes; ++p) {
    const int n = slot_base(s, logn, inv, p, s.n_stages[p]);
    most = n > most ? n : most;
    sum += n;
  }
  return total ? sum : most;
}

// The schedule of one transform, as constants.  Every query rebuilds it at
// compile time, so device code reads no host table.
template <int LOGN, bool INV>
struct Plan {
  NTT_HD static constexpr Sched sched() { return make_sched(LOGN, INV, false); }

  static constexpr int N = 1 << LOGN;
  static constexpr int LOGR = log_regs(LOGN);
  static constexpr int R = 1 << LOGR;
  static constexpr int T = N >> LOGR;
  static constexpr int NP = make_sched(LOGN, INV, false).n_passes;

  NTT_HD static constexpr int n_stages(int p) { return sched().n_stages[p]; }
  NTT_HD static constexpr int stage_bit(int p, int t) {
    return sched().stage_bit[p][t];
  }
  NTT_HD static constexpr int reg_bit(int p, int i) {
    return sched().reg_bit[p][i];
  }
  // the element bits of register k in pass p
  NTT_HD static constexpr uint32_t reg_elem(int p, int k) {
    return ntt_sched::reg_elem(sched(), p, k);
  }
  NTT_HD static constexpr int reg_of(int p, int b) {
    return ntt_sched::reg_of(sched(), p, b);
  }
  NTT_HD static constexpr bool folded(int p, int t) {
    return INV && stage_bit(p, t) == LOGN - 1;
  }
  NTT_HD static constexpr int n_slots(int p, int t) {
    return ntt_sched::n_slots(sched(), LOGN, INV, p, t);
  }
  NTT_HD static constexpr int slot_base(int p, int t) {
    return ntt_sched::slot_base(sched(), LOGN, INV, p, t);
  }
  // the twiddle slot of the butterfly whose low register is k: the stage's
  // first slot plus k's bits above the stage, packed
  NTT_HD static constexpr int slot_of(int p, int t, int k) {
    const Sched s = sched();
    const int m = ntt_sched::above(s, p, t);
    int c = 0, o = 0;
    for (int i = 0; i < LOGR; ++i)
      if (m >> i & 1) c |= (k >> i & 1) << o++;
    return ntt_sched::slot_base(s, LOGN, INV, p, t) + c;
  }
  // a register of slot c's butterflies: c's bits spread over those bits
  NTT_HD static constexpr int slot_reg(int p, int t, int c) {
    const int m = ntt_sched::above(sched(), p, t);
    int k = 0, o = 0;
    for (int i = 0; i < LOGR; ++i)
      if (m >> i & 1) k |= (c >> o++ & 1) << i;
    return k;
  }
  static constexpr int kSlots = slots(LOGN, INV, false);
  // passes whose twiddles are loaded ahead of time: all of them, unless
  // their registers (two a twiddle, beside the R coefficients and some 32
  // of addresses) would not leave 65536 / T registers a thread
  static constexpr int kAhead =
      T * (2 * slots(LOGN, INV, true) + R + 32) <= 65536 ? NP - 1 : 1;
  // bank column of element bit h in exchange e, and the swizzle of a
  // constant element index
  NTT_HD static constexpr uint32_t swz(int e, int h) {
    return make_sched(LOGN, INV, true).swz[e][h];
  }
  NTT_HD static constexpr uint32_t swizzle(int e, uint32_t j) {
    const Sched s = make_sched(LOGN, INV, true);
    uint32_t a = j;
    for (int h = 5; h < LOGN; ++h)
      if (j >> h & 1u) a ^= s.swz[e][h];
    return a;
  }
  // shared memory of the exchanges: two row buffers
  static constexpr int kSmemBytes = NP > 1 ? 2 * N * 4 : 0;
};

NTT_TD ntt_u4 load16(const ntt_u4* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// x as a value the compiler cannot see through, new where this is
// called: what a loop computes from it is not hoisted out of the loop and
// held across it (in registers, or spilled to local memory).
template <typename T>
NTT_TD T opaque(T x) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(T) == 8)
    asm volatile("" : "+l"(x));
  else
    asm volatile("" : "+r"(x));
#endif
  return x;
}

// A twiddle and its quotient.  On the card a plain (coherent) load in
// inline PTX: the compiler may not sink it past the next __syncthreads,
// as it may a read-only (__ldg) load to save registers, which would put a
// memory round trip back into every pass.
NTT_TD ntt_u2 load8(const ntt_u2* p) {
#if defined(__CUDA_ARCH__)
  ntt_u2 r;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p));
  return r;
#else
  return *p;
#endif
}

// One thread's part of a row transform, split at the barriers: phase<E>
// runs pass E, after reading exchange E-1 (E > 0); the kernel puts a
// __syncthreads between phases, the host harness runs each phase for every
// thread before the next.  phase() is the transform kernels' whole step;
// the fused product (MulThread below) composes the same pieces.  AHEAD is
// how many passes ahead the twiddles are loaded: the plan's, unless the
// fused product asks for fewer.
template <int LOGN, bool INV, int AHEAD = Plan<LOGN, INV>::kAhead>
struct NttThread {
  using Pl = Plan<LOGN, INV>;
  static constexpr int N = Pl::N, R = Pl::R, NP = Pl::NP, T = Pl::T;
  static constexpr int kAhead = AHEAD;
  // the twiddles that phase 0 loads: passes 0 .. kAhead
  static constexpr int kFirst = kAhead < NP ? kAhead + 1 : NP;

  uint32_t v[R];
  ntt_u2 tw[NP][Pl::kSlots];
  NttPrime pr;

  // thread tid's element bits in pass P's layout: tid's bits with a zero
  // put in at each register bit (ascending)
  template <int P>
  NTT_TD static uint32_t tid_elem(uint32_t tid) {
    uint32_t j = tid;
    static_for<0, Pl::LOGR>([&](auto i) {
      constexpr int b = Pl::reg_bit(P, decltype(i)::value);
      j = (j >> b << (b + 1)) | (j & ((1u << b) - 1));
    });
    return j;
  }

  // the shared-memory word of register K in pass P for exchange E
  template <int E, int P, int K>
  NTT_TD static uint32_t smem_index(uint32_t tid) {
    const uint32_t jt = tid_elem<P>(tid);
    uint32_t a = jt;
    static_for<5, LOGN>([&](auto h) {
      constexpr int H = decltype(h)::value;
      constexpr uint32_t col = Pl::swz(E, H);
      if constexpr (col != 0) a ^= (0u - (jt >> H & 1u)) & col;
    });
    constexpr uint32_t c = Pl::swizzle(E, Pl::reg_elem(P, K));
    return a ^ c;
  }

  // the 16-byte unit of a row that holds registers 2c, 2c+1 in pass P (the
  // first and the last pass: the pair layout)
  template <int P, int C>
  NTT_TD static uint32_t pair_unit(uint32_t tid) {
    return (tid_elem<P>(tid) | Pl::reg_elem(P, 2 * C)) >> 1;
  }

  template <int P>
  NTT_TD static void load_row(uint32_t (&r)[R], uint32_t tid,
                              const ntt_u4* in) {
    static_for<0, R / 2>([&](auto c) {
      constexpr int C = decltype(c)::value;
      const ntt_u4 x = load16(in + pair_unit<P, C>(tid));
      r[2 * C] = x.x;
      r[2 * C + 1] = x.z;
    });
  }

  template <int P>
  NTT_TD static void store_row(const uint32_t (&r)[R], uint32_t tid,
                               ntt_u4* out) {
    static_for<0, R / 2>([&](auto c) {
      constexpr int C = decltype(c)::value;
      out[pair_unit<P, C>(tid)] = ntt_u4{r[2 * C], 0u, r[2 * C + 1], 0u};
    });
  }

  // pass P's twiddles from the table `tab` (device memory, or with SMEM a
  // copy of it in shared memory)
  template <int P, bool SMEM = false>
  NTT_TD void load_twiddles(uint32_t tid, const ntt_u2* tab) {
    const uint32_t jt = tid_elem<P>(tid);
    static_for<0, Pl::n_stages(P)>([&](auto t) {
      constexpr int S = decltype(t)::value;
      constexpr int b = Pl::stage_bit(P, S);
      const uint32_t base = (N | jt) >> (b + 1);
      static_for<0, Pl::n_slots(P, S)>([&](auto c) {
        constexpr int C = decltype(c)::value;
        constexpr uint32_t off = Pl::reg_elem(P, Pl::slot_reg(P, S, C)) >>
                                 (b + 1);
        constexpr int slot = Pl::slot_base(P, S) + C;
        if constexpr (SMEM)
          tw[P][slot] = tab[base | off];
        else
          tw[P][slot] = load8(tab + (base | off));
      });
    });
  }

  // the twiddles of passes 0 .. kAhead, which phase 0 loads
  template <bool SMEM = false>
  NTT_TD void load_first_twiddles(uint32_t tid, const ntt_u2* tab) {
    static_for<0, kFirst>([&](auto p) {
      load_twiddles<decltype(p)::value, SMEM>(tid, tab);
    });
  }

  template <int P>
  NTT_TD void run_pass() {
    static_for<0, Pl::n_stages(P)>([&](auto t) {
      constexpr int S = decltype(t)::value;
      constexpr int ib = Pl::reg_of(P, Pl::stage_bit(P, S));
      static_for<0, R / 2>([&](auto h) {
        constexpr int H = decltype(h)::value;
        constexpr int k0 = (H >> ib << (ib + 1)) | (H & ((1 << ib) - 1));
        constexpr int k1 = k0 | 1 << ib;
        if constexpr (Pl::folded(P, S)) {
          gs_last(v[k0], v[k1], pr);
        } else {
          constexpr int slot = Pl::slot_of(P, S, k0);
          const ntt_u2 w = tw[P][slot];
          if constexpr (INV)
            gs_butterfly(v[k0], v[k1], w.x, w.y, pr.q);
          else
            ct_butterfly(v[k0], v[k1], w.x, w.y, pr.q);
        }
      });
    });
  }

  // exchange E: pass E writes its registers to buffer E % 2, pass E+1
  // reads them back in its own layout
  template <int E>
  NTT_TD void exchange_out(uint32_t tid, uint32_t* smem) {
    uint32_t* buf = smem + (E & 1) * N;
    static_for<0, R>([&](auto k) {
      constexpr int K = decltype(k)::value;
      buf[smem_index<E, E, K>(tid)] = v[K];
    });
  }

  template <int E>
  NTT_TD void exchange_in(uint32_t tid, const uint32_t* smem) {
    const uint32_t* buf = smem + ((E - 1) & 1) * N;
    static_for<0, R>([&](auto k) {
      constexpr int K = decltype(k)::value;
      v[K] = buf[smem_index<E - 1, E, K>(tid)];
    });
  }

  // the transform kernels' step: row `in` to row `out`
  template <int E>
  NTT_TD void phase(uint32_t tid, const ntt_u4* in, ntt_u4* out,
                    const ntt_u2* tab, const NttPrime* prime,
                    uint32_t* smem) {
    if constexpr (E == 0) {
      pr = *prime;
      load_row<0>(v, tid, in);
      load_first_twiddles(tid, tab);
    } else {
      exchange_in<E>(tid, smem);
      if constexpr (E + kAhead < NP) load_twiddles<E + kAhead>(tid, tab);
    }
    run_pass<E>();
    if constexpr (E + 1 < NP)
      exchange_out<E>(tid, smem);
    else
      store_row<E>(v, tid, out);
  }
};


// A 16-byte copy from global to shared memory that does not pass through
// registers (cp.async, L2 only), and the wait for this thread's copies;
// the barrier after the wait makes them visible to the other threads.
NTT_TD void copy16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
#else
  *static_cast<ntt_u4*>(dst) = *static_cast<const ntt_u4*>(src);
#endif
}

NTT_TD void copy16_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// ---------------------------------------------------------------------------
// The fused negacyclic product (ntt_mul_kernel in ntt.cu).
//
// For one prime p of one group g of a launch's job it computes each output
//   out[g, o, p] = INV( sum over the terms (i, j) of o of X_i * X_j mod q )
// where X_i = FWD(operand i) for the first n_coef operands (coefficient
// rows) and X_i = operand i itself for the others (rows already in the NTT
// domain).  The forward's last pass and the inverse's first pass hold the
// same elements in the same registers of the same thread (the pair layout
// P), so a row goes forward, is multiplied and goes back with no trip
// through device memory between.
//
// A (g, p) is a cluster of `teams` CTAs (one CTA, no cluster, for a
// single team), each of the transform's T threads and one row at a time,
// so the rows of one operation (the tensor product's four) go through
// their passes on as many SMs at once.  Steps:
//   1. the coefficient operands go forward, operand i on team i % teams,
//      as the transform kernels run them (the row and every twiddle loaded
//      at the start); behind those loads each CTA copies the NTT-domain
//      operands its outputs read and the inverse's twiddle table into its
//      shared memory with cp.async, each thread its own units, so the
//      copies overlap the first pass's wait for the row;
//   2. after the last pass each thread stores its R values of the row
//      into the shared memory of each CTA of the cluster whose outputs
//      read it ([i][c][tid], 8-byte pairs; remote stores, which do not
//      wait);
//   3. a cluster barrier; then output o on team o % teams: each thread
//      forms its R values of the output's sum of products from its own
//      CTA's shared memory (mul_mod, add_mod: exact), and the row goes
//      through the inverse passes, each pass's twiddles read from the
//      shared copy of the table, and out.  Nothing reads another CTA's
//      shared memory after the barrier, so a CTA may leave when done.
// Operand i < n_coef at (g, p) starts at coef + g coef_gs + i coef_s +
// p N/2 (16-byte units), an NTT-domain one at ntt + g ntt_gs + (i - n_coef)
// ntt_s + p N/2, output o at out + g out_gs + o out_os + p N/2: the
// operands of a kind are one stack, as the cipher layer keeps them.
// ---------------------------------------------------------------------------

constexpr int kMulMaxIn = 16, kMulMaxTerms = 32, kMulMaxOut = 16;
// CTAs a cluster may have without opting in to larger ones
constexpr int kMulMaxTeams = 8;
// the dynamic shared memory a CTA may take (H100: 227 KiB, less 1 KiB for
// the kernel's own: the job)
constexpr int kMulMaxSmem = 232448 - 1024;

// The job of one fused launch, the kernel's parameter (by value).
struct alignas(16) MulJob {
  const ntt_u4* coef;            // coefficient operand 0 at group 0, prime 0
  int64_t coef_gs, coef_s;       // group and operand strides, 16-byte units
  const ntt_u4* ntt;             // the NTT-domain operands, the same way
  int64_t ntt_gs, ntt_s;
  ntt_u4* out;
  int64_t out_gs, out_os;
  const ntt_u2* tw;              // (n_primes, 2, N) twiddle tables
  const NttPrime* primes;        // n_primes constant rows
  int n_coef, n_in, n_out, n_primes, stage_ntt, teams;
  uint8_t term_end[kMulMaxOut];  // output o: terms term_end[o-1] ..
  uint8_t lhs[kMulMaxTerms];     //   term_end[o] - 1 (from 0 for o = 0)
  uint8_t rhs[kMulMaxTerms];
  // from the terms: the NTT-domain operands team j's outputs read, and the
  // teams whose outputs read coefficient row i, a bit each
  uint16_t ntt_need[kMulMaxTeams];
  uint8_t coef_dest[kMulMaxIn];
};

// A job from the wrapper's descriptor, int64 words: n_coef, n_in, n_out,
// n_primes, groups, stage_ntt, teams, coef, coef_gs, coef_s, ntt, ntt_gs,
// ntt_s, out, out_gs, out_os (strides in 16-byte units), the twiddle
// tables, the primes' constants, then n_out term ends and each term's two
// operand indices.  Returns false for a job
// beyond the limits; the launch has groups * n_primes clusters.
NTT_HD bool parse_job(const int64_t* desc, MulJob* job, int64_t* groups) {
  *job = MulJob{};
  job->n_coef = (int)desc[0];
  job->n_in = (int)desc[1];
  job->n_out = (int)desc[2];
  job->n_primes = (int)desc[3];
  *groups = desc[4];
  job->stage_ntt = (int)desc[5];
  job->teams = (int)desc[6];
  job->coef = (const ntt_u4*)desc[7];
  job->coef_gs = desc[8];
  job->coef_s = desc[9];
  job->ntt = (const ntt_u4*)desc[10];
  job->ntt_gs = desc[11];
  job->ntt_s = desc[12];
  job->out = (ntt_u4*)desc[13];
  job->out_gs = desc[14];
  job->out_os = desc[15];
  job->tw = (const ntt_u2*)desc[16];
  job->primes = (const NttPrime*)desc[17];
  if (job->n_in > kMulMaxIn || job->n_out > kMulMaxOut || job->n_out < 1 ||
      job->n_coef < 1 || job->n_coef > job->n_in || job->n_primes < 1 ||
      job->teams < 1 || job->teams > kMulMaxTeams)
    return false;
  const int64_t* d = desc + 18;
  for (int o = 0; o < job->n_out; ++o) job->term_end[o] = (uint8_t)d[o];
  const int64_t n_terms = d[job->n_out - 1];
  d += job->n_out;
  if (n_terms > kMulMaxTerms) return false;
  for (int t = 0; t < n_terms; ++t) {
    job->lhs[t] = (uint8_t)d[2 * t];
    job->rhs[t] = (uint8_t)d[2 * t + 1];
  }
  for (int o = 0, t = 0; o < job->n_out; ++o) {
    const int team = o % job->teams;
    for (; t < job->term_end[o]; ++t)
      for (int side = 0; side < 2; ++side) {
        const int x = side ? job->rhs[t] : job->lhs[t];
        if (x >= job->n_in) return false;
        if (x < job->n_coef)
          job->coef_dest[x] |= (uint8_t)(1u << team);
        else
          job->ntt_need[team] |= (uint16_t)(1u << (x - job->n_coef));
      }
  }
  return true;
}

template <int LOGN>
struct MulThread {
  // the forward's twiddles as the transform kernels load them, but at
  // N = 8192 each pass's as it starts, not a pass ahead: at 512 threads of
  // 16 values the 30 pairs of a pass ahead spill beside the fused kernel's
  // own state (52 bytes, ptxas)
  using Fw =
      NttThread<LOGN, false, LOGN == 13 ? 0 : Plan<LOGN, false>::kAhead>;
  using Iv = NttThread<LOGN, true>;
  static constexpr int N = Fw::N, R = Fw::R, NP = Fw::NP, T = Fw::T;
  static constexpr int NH = N / 2;   // 16-byte units a row

  // the inverse's twiddles from a copy of its table in shared memory, a
  // pass's as the pass starts (up to N = 4096, 32 KiB); at N = 8192 from
  // device memory a pass ahead, as the transform kernels load them
  static constexpr bool kTwSmem = LOGN <= 12;

  // A CTA's shared memory, in 32-bit words: the exchange buffers (2 N),
  // the inverse's twiddle table (2 N), the NTT-domain operands if staged
  // (2 N a row: 16-byte units [m][c][tid]), every transformed coefficient
  // row (N a row: 8-byte pairs [i][c][tid]).
  static constexpr int kExchange = NP > 1 ? 2 * N : 0;
  static constexpr int kTw = kTwSmem ? 2 * N : 0;
  NTT_HD static constexpr int64_t smem_bytes(int n_coef, int n_ntt,
                                             bool stage) {
    return 4 * ((int64_t)kExchange + kTw +
                (stage ? (int64_t)n_ntt * 2 * N : 0) + (int64_t)n_coef * N);
  }
  NTT_TD static ntt_u2* tw_stage(uint32_t* smem) {
    return reinterpret_cast<ntt_u2*>(smem + kExchange);
  }
  NTT_TD static ntt_u4* ntt_stage(uint32_t* smem) {
    return reinterpret_cast<ntt_u4*>(smem + kExchange + kTw);
  }
  NTT_TD static ntt_u2* coef_stage(const MulJob& job, uint32_t* smem) {
    return reinterpret_cast<ntt_u2*>(
        smem + kExchange + kTw +
        (job.stage_ntt ? (job.n_in - job.n_coef) * 2 * N : 0));
  }

  Fw f;
  Iv iv;

  NTT_TD static const ntt_u4* operand(const MulJob& job, int i, uint32_t g,
                                      uint32_t p) {
    return i < job.n_coef
               ? job.coef + (int64_t)g * job.coef_gs +
                     (int64_t)i * job.coef_s + (int64_t)p * NH
               : job.ntt + (int64_t)g * job.ntt_gs +
                     (int64_t)(i - job.n_coef) * job.ntt_s + (int64_t)p * NH;
  }

  // this thread's 16-byte units of the NTT-domain operands its team's
  // outputs read, by cp.async
  NTT_TD static void stage_ntt(uint32_t team, uint32_t tid,
                               const MulJob& job, uint32_t g, uint32_t p,
                               uint32_t* smem) {
    ntt_u4* st = ntt_stage(smem);
    for (int m = 0; m < job.n_in - job.n_coef; ++m) {
      if (!(job.ntt_need[team] >> m & 1)) continue;
      const ntt_u4* src = operand(job, job.n_coef + m, g, p);
      static_for<0, R / 2>([&](auto c) {
        constexpr int C = decltype(c)::value;
        copy16(st + ((int64_t)m * (R / 2) + C) * T + tid,
               src + Iv::template pair_unit<0, C>(tid));
      });
    }
  }

  // step 1: pass E of forward run `run` (this team's row: run teams +
  // team); peer(j, ptr) is the same address in team j's shared memory
  template <int E, class Peer>
  NTT_TD void fwd_phase(int run, uint32_t team, uint32_t tid,
                        const MulJob& job, uint32_t g, uint32_t p,
                        const ntt_u2* tab, const NttPrime* prime,
                        uint32_t* smem, Peer peer) {
    const int i = run * job.teams + (int)team;
    const bool on = i < job.n_coef;
    if constexpr (E == 0) {
      if (run == 0) f.pr = *prime;
      if (on) {
        const ntt_u4* row = operand(job, i, g, p);
        Fw::template load_row<0>(f.v, tid, row);
        if (run == 0 || Fw::kAhead < NP - 1) f.load_first_twiddles(tid, tab);
      }
    } else if (on) {
      f.template exchange_in<E>(tid, smem);
      if constexpr (E + Fw::kAhead < NP)
        f.template load_twiddles<E + Fw::kAhead>(tid, tab);
    }
    // the NTT-domain operands and the inverse's table, behind the row's
    // and the twiddles' loads: the load/store unit copies them while the
    // first pass waits for the row
    if constexpr (E == 0) {
      if (run == 0) {
        if (job.stage_ntt) stage_ntt(team, tid, job, g, p, smem);
        if constexpr (kTwSmem) {
          ntt_u4* st = reinterpret_cast<ntt_u4*>(tw_stage(smem));
          const ntt_u4* src = reinterpret_cast<const ntt_u4*>(tab + N);
          static_for<0, R / 2>([&](auto c) {   // N / 2 units, R / 2 each
            constexpr int C = decltype(c)::value;
            copy16(st + C * T + tid, src + C * T + tid);
          });
        }
      }
    }
    if (on) f.template run_pass<E>();
    if constexpr (E + 1 < NP) {
      if (on) f.template exchange_out<E>(tid, smem);
    } else if (on) {
      const int64_t at = (int64_t)i * (R / 2) * T + tid;
      for (int j = 0; j < job.teams; ++j) {
        if (!(job.coef_dest[i] >> j & 1)) continue;
        ntt_u2* st = peer(j, coef_stage(job, smem)) + at;
        static_for<0, R / 2>([&](auto c) {
          constexpr int C = decltype(c)::value;
          st[C * T] = ntt_u2{f.v[2 * C], f.v[2 * C + 1]};
        });
      }
    }
  }

  // step 2's end, after the last forward run and before the cluster
  // barrier: the copies waited for
  NTT_TD void finish_forward() {
    copy16_wait();
    iv.pr = f.pr;
  }

  // this thread's R values of operand i in layout P from its CTA's shared
  // memory (or, where the NTT-domain operands are not staged, from device
  // memory): the branch once a row, then every load of the row at once
  NTT_TD static void fetch(uint32_t (&x)[R], int i, uint32_t tid,
                           const MulJob& job, uint32_t g, uint32_t p,
                           uint32_t* smem) {
    if (i < job.n_coef) {
      const ntt_u2* st = coef_stage(job, smem) + (int64_t)i * (R / 2) * T;
      static_for<0, R / 2>([&](auto c) {
        constexpr int C = decltype(c)::value;
        const ntt_u2 y = st[C * T + tid];
        x[2 * C] = y.x;
        x[2 * C + 1] = y.y;
      });
    } else if (job.stage_ntt) {
      const ntt_u4* st =
          ntt_stage(smem) + (int64_t)(i - job.n_coef) * (R / 2) * T;
      static_for<0, R / 2>([&](auto c) {
        constexpr int C = decltype(c)::value;
        const ntt_u4 y = st[C * T + tid];
        x[2 * C] = y.x;
        x[2 * C + 1] = y.z;
      });
    } else {
      Iv::template load_row<0>(x, tid, operand(job, i, g, p));
    }
  }

  // output o's sum of products, this thread's R values, into iv.v
  NTT_TD void products(int o, uint32_t tid, const MulJob& job, uint32_t g,
                       uint32_t p, uint32_t* smem) {
    static_for<0, R>([&](auto k) { iv.v[decltype(k)::value] = 0; });
    const int t1 = job.term_end[o];
    for (int t = o ? job.term_end[o - 1] : 0; t < t1; ++t) {
      uint32_t x[R], y[R];
      fetch(x, job.lhs[t], tid, job, g, p, smem);
      fetch(y, job.rhs[t], tid, job, g, p, smem);
      static_for<0, R>([&](auto k) {
        constexpr int K = decltype(k)::value;
        iv.v[K] = add_mod(iv.v[K], mul_mod(x[K], y[K], iv.pr), iv.pr.q);
      });
    }
  }

  // step 3: pass E of inverse run `run` (this team's output: run teams +
  // team), its twiddles from the shared copy of the table, or (N = 8192)
  // from `tab` in device memory a pass ahead, after the products
  template <int E>
  NTT_TD void inv_phase(int run, uint32_t team, uint32_t tid,
                        const MulJob& job, uint32_t g, uint32_t p,
                        const ntt_u2* tab, uint32_t* smem) {
    const int o = run * job.teams + (int)team;
    if (o >= job.n_out) return;
    if constexpr (E == 0) {
      if constexpr (kTwSmem)
        iv.template load_twiddles<0, true>(tid, tw_stage(smem));
      products(o, tid, job, g, p, smem);
      if constexpr (!kTwSmem) iv.load_first_twiddles(tid, tab);
    } else {
      iv.template exchange_in<E>(tid, smem);
      if constexpr (kTwSmem)
        iv.template load_twiddles<E, true>(tid, tw_stage(smem));
      else if constexpr (E + Iv::kAhead < NP)
        iv.template load_twiddles<E + Iv::kAhead>(tid, tab);
    }
    iv.template run_pass<E>();
    if constexpr (E + 1 < NP)
      iv.template exchange_out<E>(tid, smem);
    else
      Iv::template store_row<E>(
          iv.v, tid,
          job.out + (int64_t)g * job.out_gs + (int64_t)o * job.out_os +
              (int64_t)p * NH);
  }
};

}  // namespace ntt_sched
