// Constant-time fixed-key AES-128 and the half-gates hash, shared by the two
// kernels in garble.cu.
//
// The AES state of TWO blocks is bitsliced into eight 32-bit planes: plane k
// holds bit k of the byte at (row r, column c) of block blk at bit
// 8*r + 4*blk + c.  That layout is what an 8x8 bit transpose of the eight
// column words (four per block, byte r of word c = state byte 4c + r) gives
// (SWAPMOVE, 12 of them; the transpose is its own inverse, so it also
// leaves the planes).  Row r+1 of the same column then lies 8 bits up, so
// the row rotations of MixColumns are 32-bit rotations.
//
// ShiftRows is never applied (fixslicing, Adomnicai & Peyrin, TCHES 2021):
// after round i the planes hold the state with row r rotated right by i*r
// columns.  SubBytes and AddRoundKey act byte by byte, so they do not care;
// MixColumns of round i then mixes row r+d with the column i*d further on:
// per plane and row distance one rotation or, where i*d is not a multiple
// of 4, a select between two.  The round keys are stored in the same
// rotated order (kernel.py builds them), and after the last round one byte
// select per output word (rows 1 and 3 two columns on) undoes the rotation
// the ten rounds left, i*r = 10r = 2r mod 4.
//
// SubBytes is the Boyar-Peralta circuit as 82 three-input gates (LOP3) on
// the planes, so all 32 bytes go through the S-box in one pass.  Nothing is
// looked up by secret data and nothing branches on it, so the instruction
// stream and the memory addresses do not depend on the labels, the
// property the TPU kernel keeps with its lookup-free S-box
// (src/repro/kernels/garble/kernel.py).  With the rounds unrolled, every
// rotation amount, mask and round-key address is a compile-time constant.
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

// sel ? y : x, without a branch (sel is all zeros or all ones)
GC_HD Label lsel(uint64_t sel, Label y, Label x) {
  return {(y.lo & sel) | (x.lo & ~sel), (y.hi & sel) | (x.hi & ~sel)};
}

// rotate right: bit i <- bit (i + k) mod 32
GC_HD uint32_t ror32(uint32_t x, int k) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_r(x, x, k);
#else
  k &= 31;
  return k ? (x >> k) | (x << (32 - k)) : x;
#endif
}

// any boolean function of three words, bit by bit, in one instruction:
// bit 4a + 2b + c of kLut is the result for the input bits (a, b, c)
template <int kLut>
GC_HD uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
#else
  uint32_t d = 0;
  for (int i = 0; i < 8; ++i)
    if ((kLut >> i) & 1)
      d |= ((i & 4) ? a : ~a) & ((i & 2) ? b : ~b) & ((i & 1) ? c : ~c);
  return d;
#endif
}

// ---------------------------------------------------------------------------
// column words <-> bit planes
// ---------------------------------------------------------------------------

// swap the bits of b under mask with the bits of a under mask << n
GC_HD void swapmove(uint32_t& a, uint32_t& b, uint32_t mask, int n) {
  const uint32_t t = ((a >> n) ^ b) & mask;
  b ^= t;
  a ^= t << n;
}

// in every byte position, the 8x8 bit matrix (word w, bit k) is transposed:
// afterwards word k bit 8r + w is what word w bit 8r + k was
GC_HD void transpose8(uint32_t p[8]) {
  GC_UNROLL
  for (int i = 0; i < 8; i += 2) swapmove(p[i], p[i + 1], 0x55555555u, 1);
  swapmove(p[0], p[2], 0x33333333u, 2);
  swapmove(p[1], p[3], 0x33333333u, 2);
  swapmove(p[4], p[6], 0x33333333u, 2);
  swapmove(p[5], p[7], 0x33333333u, 2);
  GC_UNROLL
  for (int i = 0; i < 4; ++i) swapmove(p[i], p[i + 4], 0x0F0F0F0Fu, 4);
}

// a[c], b[c]: the column words of the two blocks -> the eight planes
GC_HD void to_planes(const uint32_t a[4], const uint32_t b[4], uint32_t p[8]) {
  GC_UNROLL
  for (int c = 0; c < 4; ++c) {
    p[c] = a[c];
    p[4 + c] = b[c];
  }
  transpose8(p);
}

GC_HD void from_planes(const uint32_t p[8], uint32_t a[4], uint32_t b[4]) {
  uint32_t w[8];
  GC_UNROLL
  for (int k = 0; k < 8; ++k) w[k] = p[k];
  transpose8(w);
  GC_UNROLL
  for (int c = 0; c < 4; ++c) {
    a[c] = w[c];
    b[c] = w[4 + c];
  }
}

// ---------------------------------------------------------------------------
// the AES layers on planes
// ---------------------------------------------------------------------------

// SubBytes without its affine constant 0x63, which the round keys carry
// (MixColumns maps a state of equal bytes to itself): Boyar & Peralta's
// depth-16 circuit of 128 gates, covered by the fewest three-input gates,
// 82 (tools/sbox_lut3.py prints this body).  Each gate keeps its name in
// the circuit; U0 is the most significant input bit, S0 = p[7] the most
// significant output bit.
GC_HD void sub_bytes(uint32_t p[8]) {
  const uint32_t U0 = p[7], U1 = p[6], U2 = p[5], U3 = p[4], U4 = p[3],
                 U5 = p[2], U6 = p[1], U7 = p[0];
  const uint32_t T1 = U0 ^ U3;
  const uint32_t T2 = U0 ^ U5;
  const uint32_t T3 = U0 ^ U6;
  const uint32_t T4 = U3 ^ U5;
  const uint32_t T5 = U4 ^ U6;
  const uint32_t T6 = T1 ^ T5;
  const uint32_t T7 = U1 ^ U2;
  const uint32_t T8 = lop3<0x96>(T1, T5, U7);
  const uint32_t T9 = lop3<0x96>(U1, U2, U7);
  const uint32_t T10 = T6 ^ T7;
  const uint32_t T11 = U1 ^ U5;
  const uint32_t T16 = lop3<0x96>(T5, U2, U5);
  const uint32_t T19 = lop3<0x96>(T7, U3, U7);
  const uint32_t T20 = T1 ^ T19;
  const uint32_t T22 = lop3<0x96>(T7, U6, U7);
  const uint32_t T24 = T2 ^ T10;
  const uint32_t T25 = lop3<0x96>(T9, T16, T20);
  const uint32_t T27 = lop3<0x96>(T1, U2, U5);
  const uint32_t M1 = lop3<0x28>(T3, T4, T6);
  const uint32_t M2 = lop3<0x48>(T2, T8, T22);
  const uint32_t M3 = lop3<0x96>(T6, T11, M1);
  const uint32_t M5 = lop3<0x6C>(T19, M1, U7);
  const uint32_t M8 = lop3<0xF6>(T16, U0, U6);
  const uint32_t M9 = lop3<0x28>(T9, T16, T20);
  const uint32_t M10 = lop3<0x6A>(T3, T16, M9);
  const uint32_t M11 = lop3<0x60>(T1, T5, T11);
  const uint32_t M13 = lop3<0x6A>(T4, T27, M11);
  const uint32_t M15 = lop3<0x6A>(T2, T10, M11);
  const uint32_t M16 = M2 ^ M3;
  const uint32_t M18 = lop3<0x6A>(T9, T22, M8);
  const uint32_t M21 = lop3<0x96>(T24, M5, M15);
  const uint32_t M23 = lop3<0x96>(T25, M10, M15);
  const uint32_t M24 = lop3<0x96>(M13, M18, M23);
  const uint32_t M25 = lop3<0x18>(M13, M16, M18);
  const uint32_t M27 = lop3<0x96>(M13, M16, M21);
  const uint32_t M29 = lop3<0x28>(M23, M25, M27);
  const uint32_t M30 = lop3<0x48>(M21, M24, M25);
  const uint32_t M31 = lop3<0x28>(M13, M16, M23);
  const uint32_t M34 = lop3<0x28>(M13, M18, M21);
  const uint32_t M37 = M21 ^ M29;
  const uint32_t M38 = lop3<0xB4>(M25, M27, M31);
  const uint32_t M40 = lop3<0x9C>(M24, M25, M34);
  const uint32_t M42 = lop3<0x96>(M23, M30, M37);
  const uint32_t M43 = lop3<0x96>(M21, M29, M38);
  const uint32_t M44 = lop3<0x96>(M23, M30, M40);
  const uint32_t M45 = lop3<0x96>(M38, M40, M42);
  const uint32_t M48 = lop3<0x28>(M23, M30, U7);
  const uint32_t M51 = lop3<0x28>(T9, T16, M37);
  const uint32_t M52 = lop3<0x28>(T5, T11, M42);
  const uint32_t M54 = lop3<0x60>(T10, M38, M40);
  const uint32_t M55 = lop3<0x28>(T3, T4, M44);
  const uint32_t M56 = lop3<0x28>(T2, T22, M40);
  const uint32_t M57 = lop3<0x60>(T19, M23, M30);
  const uint32_t M61 = lop3<0x60>(M42, U0, U3);
  const uint32_t M63 = lop3<0x60>(T2, M38, M40);
  const uint32_t L0 = lop3<0x6A>(T4, M45, M61);
  const uint32_t L1 = lop3<0x6A>(T9, M38, M56);
  const uint32_t L2 = lop3<0x6A>(T6, M44, M48);
  const uint32_t L3 = lop3<0x6A>(T8, M40, M55);
  const uint32_t L4 = lop3<0x6A>(T3, M43, M54);
  const uint32_t L5 = lop3<0x6A>(T16, M43, M61);
  const uint32_t L6 = lop3<0x6A>(T4, M45, L5);
  const uint32_t L7 = lop3<0x6A>(T6, M44, L3);
  const uint32_t L8 = lop3<0x6A>(T22, M38, M51);
  const uint32_t L9 = lop3<0x6A>(T27, M45, M52);
  const uint32_t L10 = lop3<0x6A>(T27, M45, L4);
  const uint32_t L11 = lop3<0x6A>(T20, M37, L2);
  const uint32_t L13 = lop3<0x6A>(T9, M38, L0);
  const uint32_t L15 = M55 ^ L1;
  const uint32_t L16 = M56 ^ L0;
  const uint32_t L18 = lop3<0x6A>(T3, M43, L8);
  const uint32_t L22 = lop3<0x96>(M48, M51, L3);
  const uint32_t L28 = lop3<0x96>(M52, M61, L11);
  const uint32_t L29 = lop3<0x96>(M57, L1, L11);
  p[7] = lop3<0x96>(L6, L9, L15);
  p[6] = lop3<0x96>(L7, L9, L16);
  p[5] = lop3<0x96>(M63, L4, L28);
  p[4] = lop3<0x96>(L1, L6, L7);
  p[3] = lop3<0x96>(L0, L1, L22);
  p[2] = lop3<0x96>(L6, L10, L29);
  p[1] = lop3<0x96>(L8, L10, L13);
  p[0] = lop3<0x96>(L2, L6, L18);
}

// the plane of the bytes d rows down and s columns on (both mod 4):
// bit 8r + 4blk + c <- bit 8(r + d) + 4blk + (c + s) mod 4
GC_HD uint32_t rot_rows_cols(uint32_t x, int d, int s) {
  if (s == 0) return ror32(x, 8 * d);
  const uint32_t stay = (0xFu >> s) * 0x11111111u;   // columns c + s < 4
  return (ror32(x, 8 * d + s) & stay) | (ror32(x, 8 * d + s - 4) & ~stay);
}

// MixColumns of round j's fixsliced state, then AddRoundKey (rk: the
// round's 8 key planes).  With v' the byte one row down and j columns on
// (v'' two rows down, 2j on): out = 2 (v ^ v') ^ v' ^ v'' ^ v''' = 2 t ^ v'
// ^ t'' for t = v ^ v', so two rotations (or selects of two) per plane,
// and three three-input XORs with the key
GC_HD void mix_columns(uint32_t p[8], int j, const uint32_t* rk) {
  uint32_t t[8], u[8];
  GC_UNROLL
  for (int k = 0; k < 8; ++k) {
    const uint32_t r1 = rot_rows_cols(p[k], 1, j & 3);
    t[k] = p[k] ^ r1;
    u[k] = lop3<0x96>(r1, rot_rows_cols(t[k], 2, (2 * j) & 3), rk[k]);
  }
  // doubling in GF(2^8) on planes: x^8 = x^4 + x^3 + x + 1
  p[0] = t[7] ^ u[0];
  p[1] = lop3<0x96>(t[0], t[7], u[1]);
  p[2] = t[1] ^ u[2];
  p[3] = lop3<0x96>(t[2], t[7], u[3]);
  p[4] = lop3<0x96>(t[3], t[7], u[4]);
  p[5] = t[4] ^ u[5];
  p[6] = t[5] ^ u[6];
  p[7] = t[6] ^ u[7];
}

// ShiftRows twice on column words: rows 1 and 3 take column c + 2
GC_HD void double_shift_rows(uint32_t w[4]) {
  const uint32_t w0 = w[0], w1 = w[1];
  w[0] = (w0 & 0x00FF00FFu) | (w[2] & 0xFF00FF00u);
  w[1] = (w1 & 0x00FF00FFu) | (w[3] & 0xFF00FF00u);
  w[2] = (w[2] & 0x00FF00FFu) | (w0 & 0xFF00FF00u);
  w[3] = (w[3] & 0x00FF00FFu) | (w1 & 0xFF00FF00u);
}

// two blocks at once; rk holds the 11 round keys as 8 planes each, round i's
// rotated as the state is after round i and, from round 1 on, XORed with
// the S-box's constant 0x63 (both halves the same; kernel.py)
GC_HD void aes128_encrypt2(uint32_t a[4], uint32_t b[4], const uint32_t* rk) {
  uint32_t p[8];
  to_planes(a, b, p);
  GC_UNROLL
  for (int k = 0; k < 8; ++k) p[k] ^= rk[k];
  GC_UNROLL
  for (int r = 1; r < 10; ++r) {
    sub_bytes(p);
    mix_columns(p, r, rk + 8 * r);
  }
  sub_bytes(p);
  GC_UNROLL
  for (int k = 0; k < 8; ++k) p[k] ^= rk[80 + k];
  from_planes(p, a, b);
  double_shift_rows(a);
  double_shift_rows(b);
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

// One of the garbler's two lanes of a gate.  Lane 0 hashes A0 and A0^R under
// j0 = 2 gid and returns TG and WG; lane 1 hashes B0 and B0^R under j0 + 1
// and returns TE and WE.  The gate's output zero-label is WG ^ WE and its
// table [TG | TE].  Both lanes run the same instructions: the lane picks
// operands through masks, never through a branch.
GC_HD void garble_lane(Label a, Label b, Label R, uint64_t gid, uint32_t lane,
                       const uint32_t* rk, Label* t, Label* w) {
  const uint64_t on1 = 0ull - (uint64_t)lane;       // all ones on lane 1
  const uint64_t j = 2 * gid + lane;
  const Label x = lsel(on1, b, a);
  Label h0, h1;
  gc_hash2(x, j, lxor(x, R), j, rk, &h0, &h1);
  const uint64_t pa = a.lo & 1, pb = b.lo & 1;
  // TG = H(A0) ^ H(A1) ^ pb R;  TE = H(B0) ^ H(B1) ^ A0
  *t = lxor(lxor(h0, h1), lsel(on1, a, lmask(pb, R)));
  // WG = H(A0) ^ pa TG;  WE = H(B0) ^ pb (TE ^ A0)
  *w = lxor(h0, lmask((pa & ~on1) | (pb & on1), lsel(on1, lxor(*t, a), *t)));
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
