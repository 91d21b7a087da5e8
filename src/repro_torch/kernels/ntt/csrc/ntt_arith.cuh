// Modular arithmetic and butterflies of the negacyclic NTT, shared by the
// kernels in ntt.cu.
//
// Every modulus q is an odd prime below 2^31 and every residue lies in
// [0, q), so a sum of two residues fits 32 bits and a product of two fits 62
// bits: the card's 32x32->64 multiply (mul.wide.u32, and mul.hi.u32 for the
// high half) does every product, with no 16-bit limbs.  A multiply by a
// twiddle uses Shoup's method with the twiddle's precomputed quotient
// w' = floor(w * 2^32 / q): one high and two low multiplies and one
// conditional subtract.  A product of two variable residues uses Barrett
// reduction with k = bitlen(q), mu = floor(2^2k / q).
//
// The functions are plain C++ on uint32/uint64 and host+device, so that a
// host compiler can build the same arithmetic for the CPU tests; on the
// card (uint64)a * b compiles to mul.wide.u32 and its >> 32 to mul.hi.u32.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define NTT_HD __host__ __device__ __forceinline__
#else
#define NTT_HD inline
#endif

// Per-prime constants, one row of the wrapper's (P, 8) uint32 table.
struct NttPrime {
  uint32_t q;
  uint32_t n_inv;        // N^-1 mod q
  uint32_t n_inv_shoup;  // floor(n_inv * 2^32 / q)
  uint32_t mu;           // Barrett: floor(2^2k / q)
  uint32_t k;            // Barrett: bitlen(q)
  uint32_t pad[3];
};

NTT_HD uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return s >= q ? s - q : s;
}

NTT_HD uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// a * w mod q for a < 2^32, w < q, ws = floor(w * 2^32 / q).
NTT_HD uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t qhat = (uint32_t)(((uint64_t)a * ws) >> 32);
  const uint32_t r = a * w - qhat * q;  // exact mod 2^32, and < 2q
  return r >= q ? r - q : r;
}

// a * b mod q for a, b < q < 2^31 (Barrett, HAC 14.42 with base 2).
NTT_HD uint32_t mul_mod(uint32_t a, uint32_t b, NttPrime p) {
  const uint64_t x = (uint64_t)a * b;                   // < 2^2k
  const uint32_t t = (uint32_t)(x >> (p.k - 1));        // < 2^(k+1)
  const uint32_t qest = (uint32_t)(((uint64_t)t * p.mu) >> (p.k + 1));
  uint64_t r = x - (uint64_t)qest * p.q;                // < 3q
  r = r >= p.q ? r - p.q : r;
  r = r >= p.q ? r - p.q : r;
  return (uint32_t)r;
}

// Butterfly b (0 <= b < N/2) of the forward stage with m groups of
// half-width t = 2^lt: Cooley-Tukey, u + w*x and u - w*x with w = psi[m + i].
// This is one step of repro.protocols.ckks.ntt.ntt_forward's stage loop.
NTT_HD void fwd_butterfly(uint32_t* v, int lt, int m, int b,
                          const uint32_t* psi, const uint32_t* psi_shoup,
                          uint32_t q) {
  const int i = b >> lt;
  const int j0 = (i << (lt + 1)) + (b & ((1 << lt) - 1));
  const int j1 = j0 + (1 << lt);
  const uint32_t u = v[j0];
  const uint32_t x = shoup_mul(v[j1], psi[m + i], psi_shoup[m + i], q);
  v[j0] = add_mod(u, x, q);
  v[j1] = sub_mod(u, x, q);
}

// Butterfly b of the inverse stage with h groups of half-width 2^lt:
// Gentleman-Sande, u + x and (u - x) * w with w = psi_inv[h + i].
NTT_HD void inv_butterfly(uint32_t* v, int lt, int h, int b,
                          const uint32_t* psi, const uint32_t* psi_shoup,
                          uint32_t q) {
  const int i = b >> lt;
  const int j0 = (i << (lt + 1)) + (b & ((1 << lt) - 1));
  const int j1 = j0 + (1 << lt);
  const uint32_t u = v[j0];
  const uint32_t x = v[j1];
  v[j0] = add_mod(u, x, q);
  v[j1] = shoup_mul(sub_mod(u, x, q), psi[h + i], psi_shoup[h + i], q);
}

// 32-bit integer operations per butterfly and per product, as the functions
// above issue them (a multiply, add, subtract, shift or compare-and-select
// is one each; a 64-bit add or subtract two): they feed the bound that
// chip_smoke.py reports (kernel.py).
//   shoup_mul 5: mul.hi, mul.lo, mad.lo, compare, select
//   add_mod 3, sub_mod 3: add or subtract, the corrected value, select
//   fwd/inv butterfly: 11
//   mul_mod 14: mul.wide (2), shift, mul.wide, shift, mul.wide (2),
//               64-bit subtract (2), two 64-bit conditional subtracts (2 x 2)
