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
// thread before the next.
template <int LOGN, bool INV>
struct NttThread {
  using Pl = Plan<LOGN, INV>;
  static constexpr int N = Pl::N, R = Pl::R, NP = Pl::NP;

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

  template <int P>
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
        tw[P][slot] = load8(tab + (base | off));
      });
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

  template <int E>
  NTT_TD void phase(uint32_t tid, const ntt_u4* in, ntt_u4* out,
                    const ntt_u2* tab, const NttPrime* prime,
                    uint32_t* smem) {
    if constexpr (E == 0) {
      pr = *prime;
      const uint32_t jt = tid_elem<0>(tid);
      static_for<0, R / 2>([&](auto c) {
        constexpr int k = 2 * decltype(c)::value;
        constexpr uint32_t jr = Pl::reg_elem(0, k);
        const ntt_u4 x = load16(in + ((jt | jr) >> 1));
        v[k] = x.x;
        v[k + 1] = x.z;
      });
      static_for<0, (Pl::kAhead < NP ? Pl::kAhead + 1 : NP)>(
          [&](auto p) { load_twiddles<decltype(p)::value>(tid, tab); });
    } else {
      const uint32_t* buf = smem + ((E - 1) & 1) * N;
      static_for<0, R>([&](auto k) {
        constexpr int K = decltype(k)::value;
        v[K] = buf[smem_index<E - 1, E, K>(tid)];
      });
      if constexpr (E + Pl::kAhead < NP)
        load_twiddles<E + Pl::kAhead>(tid, tab);
    }
    run_pass<E>();
    if constexpr (E + 1 < NP) {
      uint32_t* buf = smem + (E & 1) * N;
      static_for<0, R>([&](auto k) {
        constexpr int K = decltype(k)::value;
        buf[smem_index<E, E, K>(tid)] = v[K];
      });
    } else {
      const uint32_t jt = tid_elem<E>(tid);
      static_for<0, R / 2>([&](auto c) {
        constexpr int k = 2 * decltype(c)::value;
        constexpr uint32_t jr = Pl::reg_elem(E, k);
        out[(jt | jr) >> 1] = ntt_u4{v[k], 0u, v[k + 1], 0u};
      });
    }
  }
};

}  // namespace ntt_sched
