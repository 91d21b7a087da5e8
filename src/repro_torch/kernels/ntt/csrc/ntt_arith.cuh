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

// Per-prime constants, one row of the wrapper's (P, 8) uint32 table (16-byte
// aligned, so a kernel reads a row in two 16-byte loads).
struct alignas(16) NttPrime {
  uint32_t q;
  uint32_t n_inv;        // N^-1 mod q
  uint32_t n_inv_shoup;  // floor(n_inv * 2^32 / q)
  uint32_t mu;           // Barrett: floor(2^2k / q)
  uint32_t k;            // Barrett: bitlen(q)
  uint32_t w1_n_inv;     // psi^-1[1] * N^-1 mod q: the inverse's last
  uint32_t w1_n_inv_shoup;  // twiddle with N^-1 folded in, and its quotient
  uint32_t pad;
};

// The corrections below are unsigned minima: for q < 2^31 a value that
// wrapped below 0 is at least 2^32 - q > 2^31, above any residue.
NTT_HD uint32_t min_u32(uint32_t a, uint32_t b) { return a < b ? a : b; }

NTT_HD uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;
  return min_u32(s, s - q);
}

NTT_HD uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t d = a - b;
  return min_u32(d, d + q);
}

// a * w mod q for a < 2^32, w < q, ws = floor(w * 2^32 / q).
NTT_HD uint32_t shoup_mul(uint32_t a, uint32_t w, uint32_t ws, uint32_t q) {
  const uint32_t qhat = (uint32_t)(((uint64_t)a * ws) >> 32);
  const uint32_t r = a * w - qhat * q;  // exact mod 2^32, and < 2q
  return min_u32(r, r - q);
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

// Cooley-Tukey: (u, x) -> (u + w x, u - w x).
NTT_HD void ct_butterfly(uint32_t& u, uint32_t& x, uint32_t w, uint32_t ws,
                         uint32_t q) {
  const uint32_t t = shoup_mul(x, w, ws, q);
  x = sub_mod(u, t, q);
  u = add_mod(u, t, q);
}

// Gentleman-Sande: (u, x) -> (u + x, (u - x) w).  u + q - x < 2q < 2^32
// goes into Shoup's product unreduced, whose result is reduced.
NTT_HD void gs_butterfly(uint32_t& u, uint32_t& x, uint32_t w, uint32_t ws,
                         uint32_t q) {
  const uint32_t d = u + q - x;
  u = add_mod(u, x, q);
  x = shoup_mul(d, w, ws, q);
}

// The inverse's last stage (one group, twiddle psi^-1[1]) with the final
// x N^-1 folded in: ((u + x) N^-1, (u - x) psi^-1[1] N^-1), both exact
// residues, so the row needs no separate scaling pass.
NTT_HD void gs_last(uint32_t& u, uint32_t& x, const NttPrime& p) {
  const uint32_t d = u + p.q - x;
  u = shoup_mul(u + x, p.n_inv, p.n_inv_shoup, p.q);
  x = shoup_mul(d, p.w1_n_inv, p.w1_n_inv_shoup, p.q);
}

// 32-bit integer operations per butterfly and per product (a multiply, add,
// subtract, shift or minimum is one each; a 64-bit add or subtract two):
// they feed the bound that chip_smoke.py reports (kernel.py).
//   shoup_mul 5: mul.hi, mul.lo, mad.lo, subtract, minimum
//   add_mod 3, sub_mod 3: add or subtract, the corrected value, minimum
//   ct_butterfly 11; gs_butterfly 9 (its difference goes into Shoup's
//   product unreduced).  The bound keeps 11 for both and a separate N^-1
//   pass (kernel.transform_ops), the counts of the first kernels, so that
//   its share compares across versions.
//   mul_mod 14: mul.wide (2), shift, mul.wide, shift, mul.wide (2),
//               64-bit subtract (2), two 64-bit conditional subtracts (2 x 2)
