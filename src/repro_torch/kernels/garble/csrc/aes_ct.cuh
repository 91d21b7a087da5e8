// Constant-time fixed-key AES-128 and the half-gates hash, shared by the two
// kernels in garble.cu.
//
// The AES state of TWO blocks is bitsliced into eight 32-bit planes: plane b
// holds bit b of state byte i (i = 4*column + row, the AES byte order) at
// bit i for the first block and at bit 16 + i for the second.  SubBytes is
// the Boyar-Peralta circuit (128 XOR/AND/XNOR gates) on the planes, so all
// 32 bytes go through the S-box in one pass; ShiftRows and MixColumns are
// rotations inside each 16-bit half and inside each 4-bit column.  Nothing
// is looked up by secret data and nothing branches on it, so the
// instruction stream and the memory addresses do not depend on the labels,
// the property the TPU kernel keeps with its lookup-free S-box
// (src/repro/kernels/garble/kernel.py).
//
// The functions are host+device so that the arithmetic can also be built by
// a host compiler; the kernels are the only callers in the package.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define GC_HD __host__ __device__ __forceinline__
#define GC_UNROLL _Pragma("unroll")
#else
#define GC_HD inline
#define GC_UNROLL
#endif

// One 128-bit wire label: the (lo, hi) uint64 pair of the protocol layer.
struct Label {
  uint64_t lo, hi;
};

GC_HD Label lxor(Label a, Label b) { return {a.lo ^ b.lo, a.hi ^ b.hi}; }

// bit ? x : 0, without a branch (bit is 0 or 1)
GC_HD Label lmask(uint64_t bit, Label x) {
  const uint64_t m = 0ull - bit;
  return {x.lo & m, x.hi & m};
}

// ---------------------------------------------------------------------------
// bit planes <-> column words (byte r of word c = state byte 4c + r)
// ---------------------------------------------------------------------------

// the four bits b of a column word's bytes, as a nibble (row r -> bit r)
GC_HD uint32_t column_bits(uint32_t w, int b) {
  return (((w >> b) & 0x01010101u) * 0x01020408u) >> 24;
}

// inverse: a nibble (row r -> bit r) spread to bit 0 of each byte
GC_HD uint32_t column_spread(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

GC_HD void to_planes(const uint32_t a[4], const uint32_t b[4], uint32_t p[8]) {
  GC_UNROLL
  for (int k = 0; k < 8; ++k) {
    uint32_t x = 0;
    GC_UNROLL
    for (int c = 0; c < 4; ++c)
      x |= (column_bits(a[c], k) << (4 * c)) |
           (column_bits(b[c], k) << (16 + 4 * c));
    p[k] = x;
  }
}

GC_HD void from_planes(const uint32_t p[8], uint32_t a[4], uint32_t b[4]) {
  GC_UNROLL
  for (int c = 0; c < 4; ++c) a[c] = b[c] = 0;
  GC_UNROLL
  for (int k = 0; k < 8; ++k) {
    GC_UNROLL
    for (int c = 0; c < 4; ++c) {
      a[c] |= column_spread((p[k] >> (4 * c)) & 0xFu) << k;
      b[c] |= column_spread((p[k] >> (16 + 4 * c)) & 0xFu) << k;
    }
  }
}

// ---------------------------------------------------------------------------
// the AES layers on planes
// ---------------------------------------------------------------------------

// SubBytes: Boyar & Peralta's depth-16 circuit; U0 is the most significant
// bit, S0 the most significant output bit
GC_HD void sub_bytes(uint32_t p[8]) {
  const uint32_t U0 = p[7], U1 = p[6], U2 = p[5], U3 = p[4], U4 = p[3],
                 U5 = p[2], U6 = p[1], U7 = p[0];
  // top linear layer
  const uint32_t T1 = U0 ^ U3, T2 = U0 ^ U5, T3 = U0 ^ U6, T4 = U3 ^ U5,
                 T5 = U4 ^ U6, T6 = T1 ^ T5, T7 = U1 ^ U2, T8 = U7 ^ T6,
                 T9 = U7 ^ T7, T10 = T6 ^ T7, T11 = U1 ^ U5, T12 = U2 ^ U5,
                 T13 = T3 ^ T4, T14 = T6 ^ T11, T15 = T5 ^ T11,
                 T16 = T5 ^ T12, T17 = T9 ^ T16, T18 = U3 ^ U7,
                 T19 = T7 ^ T18, T20 = T1 ^ T19, T21 = U6 ^ U7,
                 T22 = T7 ^ T21, T23 = T2 ^ T22, T24 = T2 ^ T10,
                 T25 = T20 ^ T17, T26 = T3 ^ T16, T27 = T1 ^ T12;
  // shared nonlinear middle (the GF(2^8) inversion)
  const uint32_t M1 = T13 & T6, M2 = T23 & T8, M3 = T14 ^ M1, M4 = T19 & U7,
                 M5 = M4 ^ M1, M6 = T3 & T16, M7 = T22 & T9, M8 = T26 ^ M6,
                 M9 = T20 & T17, M10 = M9 ^ M6, M11 = T1 & T15,
                 M12 = T4 & T27, M13 = M12 ^ M11, M14 = T2 & T10,
                 M15 = M14 ^ M11, M16 = M3 ^ M2, M17 = M5 ^ T24,
                 M18 = M8 ^ M7, M19 = M10 ^ M15, M20 = M16 ^ M13,
                 M21 = M17 ^ M15, M22 = M18 ^ M13, M23 = M19 ^ T25,
                 M24 = M22 ^ M23, M25 = M22 & M20, M26 = M21 ^ M25,
                 M27 = M20 ^ M21, M28 = M23 ^ M25, M29 = M28 & M27,
                 M30 = M26 & M24, M31 = M20 & M23, M32 = M27 & M31,
                 M33 = M27 ^ M25, M34 = M21 & M22, M35 = M24 & M34,
                 M36 = M24 ^ M25, M37 = M21 ^ M29, M38 = M32 ^ M33,
                 M39 = M23 ^ M30, M40 = M35 ^ M36, M41 = M38 ^ M40,
                 M42 = M37 ^ M39, M43 = M37 ^ M38, M44 = M39 ^ M40,
                 M45 = M42 ^ M41, M46 = M44 & T6, M47 = M40 & T8,
                 M48 = M39 & U7, M49 = M43 & T16, M50 = M38 & T9,
                 M51 = M37 & T17, M52 = M42 & T15, M53 = M45 & T27,
                 M54 = M41 & T10, M55 = M44 & T13, M56 = M40 & T23,
                 M57 = M39 & T19, M58 = M43 & T3, M59 = M38 & T22,
                 M60 = M37 & T20, M61 = M42 & T1, M62 = M45 & T4,
                 M63 = M41 & T2;
  // bottom linear layer (with the affine constant 0x63 as XNORs)
  const uint32_t L0 = M61 ^ M62, L1 = M50 ^ M56, L2 = M46 ^ M48,
                 L3 = M47 ^ M55, L4 = M54 ^ M58, L5 = M49 ^ M61,
                 L6 = M62 ^ L5, L7 = M46 ^ L3, L8 = M51 ^ M59,
                 L9 = M52 ^ M53, L10 = M53 ^ L4, L11 = M60 ^ L2,
                 L12 = M48 ^ M51, L13 = M50 ^ L0, L14 = M52 ^ M61,
                 L15 = M55 ^ L1, L16 = M56 ^ L0, L17 = M57 ^ L1,
                 L18 = M58 ^ L8, L19 = M63 ^ L4, L20 = L0 ^ L1,
                 L21 = L1 ^ L7, L22 = L3 ^ L12, L23 = L18 ^ L2,
                 L24 = L15 ^ L9, L25 = L6 ^ L10, L26 = L7 ^ L9,
                 L27 = L8 ^ L10, L28 = L11 ^ L14, L29 = L11 ^ L17;
  p[7] = L6 ^ L24;
  p[6] = ~(L16 ^ L26);
  p[5] = ~(L19 ^ L28);
  p[4] = L6 ^ L21;
  p[3] = L20 ^ L22;
  p[2] = L25 ^ L29;
  p[1] = ~(L13 ^ L27);
  p[0] = ~(L6 ^ L23);
}

// rotate each 16-bit half right by k: bit i <- bit (i + k) mod 16
GC_HD uint32_t ror16x2(uint32_t x, int k) {
  const uint32_t lo = (0xFFFFu >> k) * 0x00010001u;
  return ((x >> k) & lo) | ((x << (16 - k)) & ~lo);
}

// ShiftRows: row r (bits 4c + r) moves down r columns, i.e. 4r bits
GC_HD void shift_rows(uint32_t p[8]) {
  GC_UNROLL
  for (int k = 0; k < 8; ++k) {
    const uint32_t x = p[k];
    p[k] = (x & 0x11111111u) | (ror16x2(x, 4) & 0x22222222u) |
           (ror16x2(x, 8) & 0x44444444u) | (ror16x2(x, 12) & 0x88888888u);
  }
}

// rotate the rows inside every column: bit 4c + r <- bit 4c + (r + k) % 4
GC_HD uint32_t rot_rows1(uint32_t x) {
  return ((x >> 1) & 0x77777777u) | ((x << 3) & 0x88888888u);
}
GC_HD uint32_t rot_rows2(uint32_t x) {
  return ((x >> 2) & 0x33333333u) | ((x << 2) & 0xCCCCCCCCu);
}

// MixColumns: out[r] = 2 (v[r] ^ v[r+1]) ^ v[r+1] ^ v[r+2] ^ v[r+3]
GC_HD void mix_columns(uint32_t p[8]) {
  uint32_t t[8], s[8];
  GC_UNROLL
  for (int k = 0; k < 8; ++k) {
    const uint32_t r2 = rot_rows2(p[k]);
    t[k] = p[k] ^ rot_rows1(p[k]);            // v ^ v[r+1]
    s[k] = rot_rows1(p[k] ^ r2) ^ r2;         // v[r+1] ^ v[r+3] ^ v[r+2]
  }
  // doubling in GF(2^8) on planes: x^8 = x^4 + x^3 + x + 1
  p[0] = t[7] ^ s[0];
  p[1] = t[0] ^ t[7] ^ s[1];
  p[2] = t[1] ^ s[2];
  p[3] = t[2] ^ t[7] ^ s[3];
  p[4] = t[3] ^ t[7] ^ s[4];
  p[5] = t[4] ^ s[5];
  p[6] = t[5] ^ s[6];
  p[7] = t[6] ^ s[7];
}

// two blocks at once; rk holds the 11 round keys as 8 planes each, every
// plane's 16 bits repeated in both halves
GC_HD void aes128_encrypt2(uint32_t a[4], uint32_t b[4], const uint32_t* rk) {
  uint32_t p[8];
  to_planes(a, b, p);
  GC_UNROLL
  for (int k = 0; k < 8; ++k) p[k] ^= rk[k];
  for (int r = 1; r <= 10; ++r) {
    sub_bytes(p);
    shift_rows(p);
    if (r < 10) mix_columns(p);
    GC_UNROLL
    for (int k = 0; k < 8; ++k) p[k] ^= rk[8 * r + k];
  }
  from_planes(p, a, b);
}

// 2x in GF(2^128) (x^128 + x^7 + x^2 + x + 1), then the 64-bit tweak j
// XORed into the low word
GC_HD Label double_tweak(Label x, uint64_t j) {
  return {((x.lo << 1) ^ ((x.hi >> 63) * 0x87ull)) ^ j,
          (x.hi << 1) | (x.lo >> 63)};
}

// H(x, j) = AES_k(2x ^ j) ^ 2x ^ j for two labels at once
GC_HD void gc_hash2(Label x0, uint64_t j0, Label x1, uint64_t j1,
                    const uint32_t* rk, Label* h0, Label* h1) {
  const Label y0 = double_tweak(x0, j0), y1 = double_tweak(x1, j1);
  uint32_t a[4] = {(uint32_t)y0.lo, (uint32_t)(y0.lo >> 32), (uint32_t)y0.hi,
                   (uint32_t)(y0.hi >> 32)};
  uint32_t b[4] = {(uint32_t)y1.lo, (uint32_t)(y1.lo >> 32), (uint32_t)y1.hi,
                   (uint32_t)(y1.hi >> 32)};
  aes128_encrypt2(a, b, rk);
  *h0 = lxor({(uint64_t)a[0] | ((uint64_t)a[1] << 32),
              (uint64_t)a[2] | ((uint64_t)a[3] << 32)}, y0);
  *h1 = lxor({(uint64_t)b[0] | ((uint64_t)b[1] << 32),
              (uint64_t)b[2] | ((uint64_t)b[3] << 32)}, y1);
}

// ---------------------------------------------------------------------------
// half gates (ZRE15); gid is the gate's index in the party's gate stream
// ---------------------------------------------------------------------------

GC_HD void half_gates_garble(Label a, Label b, Label R, uint64_t gid,
                             const uint32_t* rk, Label* c, Label* tg,
                             Label* te) {
  const uint64_t j0 = 2 * gid, j1 = j0 + 1;
  Label ha0, ha1, hb0, hb1;
  gc_hash2(a, j0, lxor(a, R), j0, rk, &ha0, &ha1);
  gc_hash2(b, j1, lxor(b, R), j1, rk, &hb0, &hb1);
  const uint64_t pa = a.lo & 1, pb = b.lo & 1;
  const Label TG = lxor(lxor(ha0, ha1), lmask(pb, R));
  const Label WG = lxor(ha0, lmask(pa, TG));
  const Label TE = lxor(lxor(hb0, hb1), a);
  const Label WE = lxor(hb0, lmask(pb, lxor(TE, a)));
  *c = lxor(WG, WE);
  *tg = TG;
  *te = TE;
}

GC_HD Label half_gates_eval(Label wa, Label wb, Label tg, Label te,
                            uint64_t gid, const uint32_t* rk) {
  const uint64_t j0 = 2 * gid, j1 = j0 + 1;
  Label hwa, hwb;
  gc_hash2(wa, j0, wb, j1, rk, &hwa, &hwb);
  const Label WG = lxor(hwa, lmask(wa.lo & 1, tg));
  const Label WE = lxor(hwb, lmask(wb.lo & 1, lxor(te, wa)));
  return lxor(WG, WE);
}
