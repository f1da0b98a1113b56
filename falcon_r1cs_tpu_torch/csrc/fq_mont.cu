// BLS12-381 Fq Montgomery arithmetic and G1 point additions for Hopper
// (sm_90a), plain C entry points loaded with ctypes by
// falcon_r1cs_tpu_torch/ops/_build.py and wrapped by ops/fq.py.
//
// The kernels replace the Pallas TPU kernels of
//   falcon_r1cs_tpu/ops/pallas_fq.py:
//   mont_mul_kernel       <- _build_mul_cached's kernel (K4): x <- x*b, depth times
//   point_add_kernel      <- _point_add_kernel (K5): complete Jacobian add
//   point_add_aff_kernel  <- _point_add_aff_kernel (K6): affine + affine -> Jacobian
//
// Layout of every kernel's inputs and outputs: limb-major, (35, m) int32
// relaxed signed 12-bit limbs per coordinate in the R = 2^408 Montgomery
// domain (ops/fq_mont.py), and (m,) bool flags; one thread per point.
// Limb l of point i sits at l * m + i, so the threads of a warp load and
// store neighbouring addresses.
//
// One arithmetic: 12 words of 32 bits with exact carries, in the
// Montgomery domain R' = 2^384 (PTX add-with-carry chains where the TPU
// had none):
// - entry: each relaxed coordinate v (value x 2^408 mod q) becomes the
//   words of v 2^-24 mod q = x 2^384 mod q, in [0, 2q), by one 24-bit
//   Montgomery step (`from_limbs`), exact for |v| < 2^23 q (relaxed
//   values stay below ~2^13 q, ops/fq_mont.py);
// - body: CIOS Montgomery products over 12 words (q' = -q^-1 mod 2^32),
//   lazy in [0, 2q) (4q < 2^384), and add, subtract and double on words
//   with one conditional correction by 2q; the chord, the dbl-2007-bl
//   tangent and the infinity / P + (-P) selection are those of the plain
//   versions; the equality tests compare words reduced to [0, q);
// - exit: each output coordinate times 2^24 (a product by 2^408 mod q),
//   reduced to [0, q) and written as canonical 12-bit limbs (limb 34 is
//   0, every limb in [0, 2^12)), a valid relaxed representation, so the
//   kernels' outputs feed each other and the MSM's merge tree.  Rows with
//   an infinite operand copy the other operand as given (K6: with Z the
//   canonical limbs of one, 2^408 mod q).
// So no kernel is limb-equal to its plain version (ops/fq_mont.py
// mont_mul_chain, ops/fq.py point_add and point_add_aff, which keep the
// TPU's 35-limb arithmetic bit-equal to the JAX package): each output
// coordinate is congruent mod q to the plain version's and the flags are
// exactly equal.  Where the plain versions' relaxed equality test calls
// equal values unequal (ROADMAP Queue 3), the exact word compares here
// are right.  One product is 2 x 144 32x32->64 multiply-adds plus their
// carry adds.
//
// What bounds them on an H100, counted as chip_smoke.py counts (588 int32
// multiplies a product, 456 a square; bytes in 35-limb form):
// - K4 (mont_mul_kernel): bytes.  It reads 2 and writes 1 coordinate of
//   35 int32 limbs a point (420 B) for depth + 1 products and two 24-bit
//   entry steps;
// - K5 (point_add_kernel): integer multiplies.  Its 16 (chord) or 15
//   (tangent) products and 3 exits against 1,263 B a point;
// - K6 (point_add_aff_kernel): bytes by the count (980 B a point), with
//   the 6 products of either path and 3 exits close behind.
//
// What the design does about it:
// - one thread per point, every value in registers: fixed-size word
//   arrays indexed only by constants, every helper inlined, an input
//   converted only when it is first needed, the product's word loop kept
//   rolled and its carries run as PTX carry chains (below); ptxas lines
//   and SM residency of all three are printed by chip_smoke.py;
// - K5 and K6 branch on the infinity flags and on the equality tests and
//   compute only the path they select (the plain versions compute both
//   and select); K6 drops every product by Z = one: U = X, S = Y, the
//   tangent's Z is 2 Y and the chord's 2 H;
// - the 35-limb form stays only at the kernels' edges, where it triples
//   the bytes a coordinate moves against 12 words: keeping the points in
//   words end to end is the next step (ROADMAP);
// - every constant (q's words, 2q's words, 2^408 mod q's words, q') is a
//   compile-time constant in this source; nothing is uploaded at run time.
//
// The arithmetic is unsigned throughout, but for the entry's carry pass
// over signed limbs, which wraps mod 2^32 through unsigned adds, and
// asr(), the arithmetic shift right of a signed int (nvcc shifts signed
// values arithmetically; C++20 defines it so).

#include <cstdint>

#include <cuda_runtime.h>

#include "carry_chain.cuh"  // the PTX carry-chain steps

namespace {

constexpr int kLimb = 12;
constexpr int kMask = (1 << kLimb) - 1;
constexpr int kNsig = 34;
constexpr int kNl = 35;
constexpr int kThreads = 128;

// two's-complement wrapping add (mod 2^32) of signed limbs
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
// arithmetic shift right of a signed value (jnp/torch `>>` on int32)
__device__ __forceinline__ int asr(int x, int s) { return x >> s; }

constexpr int kW = 12;
using u64 = uint64_t;

// q = 0x1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624
//       1eabfffeb153ffffb9feffffffffaaab, its 32-bit words, least first
__constant__ u32 c_qw[kW] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
// 2q, the correction of the lazy add and subtract (2q < 2^382)
__constant__ u32 c_2qw[kW] = {
    0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u, 0xce61a541u,
    0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
// 2^408 mod q: a product by it multiplies a value of the R' domain by 2^24
// (w 2^408 2^-384), the exit from R' = 2^384 back to R = 2^408; split into
// 12-bit limbs, it is one of the R domain (fq_mont.ONE_MONT_LIMBS)
__constant__ u32 c_exitw[kW] = {
    0x0ea898bau, 0xa1d20348u, 0x27c9288fu, 0x47c6b37cu, 0x0c52aee5u, 0xdddb86ecu,
    0x23d53606u, 0x7ec46095u, 0xb8dea933u, 0xbf713fa0u, 0x5b838ba6u, 0x18c3ccefu};
// q' = -q^-1 mod 2^32 (q' q = -1 mod 2^32); its low 24 bits are -q^-1 mod
// 2^24, the entry's Montgomery factor
constexpr u32 kQInv = 0xfffcfffdu;
constexpr u32 kLow24 = 0xffffffu;

struct Fw {
  u32 w[kW];
};

// o = a b 2^-384 mod q, lazy: a, b < 2q -> o < 2q.  CIOS: per word b_i,
// t += a b_i, then t = (t + m q) / 2^32 with m = t_0 q' mod 2^32; t stays
// below a + q < 3q < 2^383 between the steps, so 13 words t[0..12] hold
// it.  o may alias a or b.  One step is four carry chains: t += lo(a b_i),
// t += hi(a b_i) one word up, t += lo(m q), then t = (t + hi(m q) one word
// up) / 2^32 with the shift folded into the destinations: 51 PTX
// instructions a step.  The word loop stays a loop (one copy of its body a
// call site): the 16 inlined products of K5 fully unrolled outgrow the
// instruction caches.
__device__ __forceinline__ void mont(Fw& o, const Fw& a, const Fw& b) {
  u32 t[kW + 1];
#pragma unroll
  for (int k = 0; k < kW + 1; ++k) t[k] = 0;
  // b's words rotate down so every index is a constant (runtime indices
  // would put them in local memory)
  u32 bw[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) bw[k] = b.w[k];
#pragma unroll 1
  for (int i = 0; i < kW; ++i) {
    const u32 bi = bw[0];
#pragma unroll
    for (int k = 0; k < kW - 1; ++k) bw[k] = bw[k + 1];
    // t < 2^383 here, so t + a b_i < 2^415 and t + m q < 2^416: 13 words,
    // no carry out of t[12]
    mad_lo_cc(t[0], a.w[0], bi);
#pragma unroll
    for (int j = 1; j < kW; ++j) madc_lo_cc(t[j], a.w[j], bi);
    addc_zero(t[kW]);
    mad_hi_cc(t[1], a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < kW - 1; ++j) madc_hi_cc(t[j + 1], a.w[j], bi, t[j + 1]);
    madc_hi(t[kW], a.w[kW - 1], bi, t[kW]);
    const u32 mq = t[0] * kQInv;
    mad_lo_cc(t[0], mq, c_qw[0]);  // t[0] becomes 0
#pragma unroll
    for (int j = 1; j < kW; ++j) madc_lo_cc(t[j], mq, c_qw[j]);
    addc_zero(t[kW]);
    mad_hi_cc(t[0], mq, c_qw[0], t[1]);  // word j - 1 <- word j: the shift
#pragma unroll
    for (int j = 1; j < kW - 1; ++j) madc_hi_cc(t[j], mq, c_qw[j], t[j + 1]);
    madc_hi(t[kW - 1], mq, c_qw[kW - 1], t[kW]);
    t[kW] = 0;
  }
#pragma unroll
  for (int k = 0; k < kW; ++k) o.w[k] = t[k];  // t[12] == 0: t < 2q
}

// d = a - b over 12 words; returns the borrow out (1 when a < b)
__device__ __forceinline__ u32 sub_words(u32 (&d)[kW], const u32 (&a)[kW], const u32 (&b)[kW]) {
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const u64 p = static_cast<u64>(a[j]) - b[j] - borrow;
    d[j] = static_cast<u32>(p);
    borrow = static_cast<u32>(p >> 32) & 1u;
  }
  return borrow;
}

// o = a + b, then - 2q unless that borrows: a, b < 2q -> o < 2q.  The sum
// is below 4q < 2^384, so it carries nothing out of 12 words.
__device__ __forceinline__ void addw(Fw& o, const Fw& a, const Fw& b) {
  u32 s[kW], d[kW];
  u32 c = 0;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const u64 p = static_cast<u64>(a.w[j]) + b.w[j] + c;
    s[j] = static_cast<u32>(p);
    c = static_cast<u32>(p >> 32);
  }
  const u32 borrow = sub_words(d, s, c_2qw);
#pragma unroll
  for (int j = 0; j < kW; ++j) o.w[j] = borrow ? s[j] : d[j];
}

// o = a - b, then + 2q if that borrowed: a, b < 2q -> o < 2q
__device__ __forceinline__ void subw(Fw& o, const Fw& a, const Fw& b) {
  u32 d[kW];
  const u32 borrow = sub_words(d, a.w, b.w);
  const u32 mask = 0u - borrow;
  u32 c = 0;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const u64 p = static_cast<u64>(d[j]) + (c_2qw[j] & mask) + c;
    o.w[j] = static_cast<u32>(p);
    c = static_cast<u32>(p >> 32);
  }
}

// o = 2 a, `times` times
__device__ __forceinline__ void dblw(Fw& o, const Fw& a, int times = 1) {
  addw(o, a, a);
#pragma unroll
  for (int r = 1; r < times; ++r) addw(o, o, o);
}

// a < 2q -> a mod q in [0, q)
__device__ __forceinline__ void reduce(Fw& o, const Fw& a) {
  u32 d[kW];
  const u32 borrow = sub_words(d, a.w, c_qw);
#pragma unroll
  for (int j = 0; j < kW; ++j) o.w[j] = borrow ? a.w[j] : d[j];
}

// a == b mod q, for a, b < 2q
__device__ __forceinline__ bool eqw(const Fw& a, const Fw& b) {
  Fw ra, rb;
  reduce(ra, a);
  reduce(rb, b);
  u32 diff = 0;
#pragma unroll
  for (int j = 0; j < kW; ++j) diff |= ra.w[j] ^ rb.w[j];
  return diff == 0;
}

// Entry: the 35 relaxed limbs of point i (value v = x 2^408 mod q, signed,
// |v| < 2^23 q) -> the words of v 2^-24 mod q = x 2^384 mod q, in [0, 2q).
// 1. one sequential carry pass makes limbs 0..33 digits in [0, 2^12) and
//    leaves the sign in the top, and the digits and the top's low 8 bits
//    are the two's-complement words of v mod 2^416 (|v| < 2^415);
// 2. s = v + m0 q with m0 = v q' mod 2^24 is a multiple of 2^24 and
//    |s| < 2^23 q + 2^24 q, so u = s / 2^24 (an arithmetic shift) has
//    |u| < 1.5 q;
// 3. u < 0 takes + 2q: u lands in [0, 2q).
__device__ __forceinline__ void from_limbs(Fw& o, const int* __restrict__ src, size_t i,
                                           size_t m) {
  u32 v[kW + 1];
#pragma unroll
  for (int k = 0; k <= kW; ++k) v[k] = 0;
  int carry = 0;
#pragma unroll
  for (int l = 0; l < kNsig; ++l) {
    const int t = wadd(src[l * m + i], carry);
    const u32 d = static_cast<u32>(t) & kMask;
    carry = asr(t, kLimb);
    const int bit = kLimb * l, word = bit >> 5, off = bit & 31;
    v[word] |= d << off;
    if (off > 32 - kLimb) v[word + 1] |= d >> (32 - off);
  }
  const int top = wadd(src[kNsig * m + i], carry);  // bits 408.. (the sign)
  v[kW] |= static_cast<u32>(top) << 24;
  const u32 m0 = (v[0] * kQInv) & kLow24;
  u32 c = 0;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const u64 p = static_cast<u64>(m0) * c_qw[j] + v[j] + c;
    v[j] = static_cast<u32>(p);
    c = static_cast<u32>(p >> 32);
  }
  v[kW] += c;  // mod 2^32: the 416-bit two's complement of s
  const u32 mask = 0u - (v[kW] >> 31);  // all ones when s < 0
#pragma unroll
  for (int j = 0; j < kW; ++j) v[j] = (v[j] >> 24) | (v[j + 1] << 8);  // u mod 2^384
  c = 0;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const u64 p = static_cast<u64>(v[j]) + (c_2qw[j] & mask) + c;
    o.w[j] = static_cast<u32>(p);
    c = static_cast<u32>(p >> 32);
  }
}

// x < 2^384 as 35 12-bit limbs of point i (limbs 32..34 are 0)
__device__ __forceinline__ void store_limbs(int* __restrict__ dst, const Fw& x, size_t i,
                                            size_t m) {
#pragma unroll
  for (int l = 0; l < kNl; ++l) {
    const int bit = kLimb * l, word = bit >> 5, off = bit & 31;
    u32 d = 0;
    if (word < kW) {
      d = x.w[word] >> off;
      if (off > 32 - kLimb && word + 1 < kW) d |= x.w[word + 1] << (32 - off);
    }
    dst[l * m + i] = static_cast<int>(d & kMask);
  }
}

__device__ __forceinline__ void load_exitw(Fw& x) {
#pragma unroll
  for (int j = 0; j < kW; ++j) x.w[j] = c_exitw[j];
}

// Exit: a < 2q in the R' domain -> a 2^24 mod q in [0, q), written as 35
// canonical 12-bit limbs of point i (limbs 32..34 are 0: q < 2^381).
__device__ __forceinline__ void to_limbs(int* __restrict__ dst, const Fw& a, size_t i,
                                         size_t m) {
  Fw x;
  load_exitw(x);
  mont(x, a, x);
  reduce(x, x);
  store_limbs(dst, x, i, m);
}

// ---------------------------------------------------------------------------
// K4: the Montgomery product chain
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                int m, int depth) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  // limbs of value v and the entry's words v 2^-24 stand for one field
  // element (v 2^-408 = v 2^-24 2^-384), mont multiplies elements and the
  // exit keeps the element: in value, the limb chain's a b^depth
  // 2^(-408 depth) mod q
  Fw x, y;
  from_limbs(x, a, i, m);
  from_limbs(y, b, i, m);
  for (int d = 0; d < depth; ++d) mont(x, x, y);
  to_limbs(out, x, i, m);
}

// ---------------------------------------------------------------------------
// K5, K6: the point adds
// ---------------------------------------------------------------------------

// dbl-2007-bl on (X, Y, Z): the tangent path of tpu_msm.point_double; Xd
// and Yd do not depend on Z, the caller forms Zd = 2 Y Z
__device__ __forceinline__ void point_double_w(Fw& X3, Fw& Y3, const Fw& X, const Fw& Y) {
  Fw A, B, C, t, D, E;
  mont(A, X, X);
  mont(B, Y, Y);
  mont(C, B, B);
  addw(t, X, B);
  mont(t, t, t);
  subw(t, t, A);
  subw(t, t, C);
  dblw(D, t);
  dblw(E, A);
  addw(E, E, A);
  mont(t, E, E);  // F
  dblw(B, D);
  subw(X3, t, B);  // Xd = F - 2D
  subw(t, D, X3);
  mont(t, E, t);
  dblw(B, C, 3);
  subw(Y3, t, B);  // Yd = E (D - Xd) - 8C
}

// the chord path of tpu_msm.point_add from U1, U2, S1, S2; H = U2 - U1
// comes out for the caller's Z3 = 2 Z1 Z2 H
__device__ __forceinline__ void point_chord_w(Fw& X3, Fw& Y3, Fw& H, const Fw& U1,
                                              const Fw& U2, const Fw& S1, const Fw& S2) {
  Fw I, J, rr, V, t;
  subw(H, U2, U1);
  dblw(t, H);
  mont(I, t, t);
  mont(J, H, I);
  subw(t, S2, S1);
  dblw(rr, t);
  mont(V, U1, I);
  mont(t, rr, rr);
  subw(t, t, J);
  dblw(X3, V);
  subw(X3, t, X3);  // X3 = rr^2 - J - 2V
  subw(t, V, X3);
  mont(t, rr, t);
  mont(V, S1, J);
  dblw(V, V);
  subw(Y3, t, V);  // Y3 = rr (V - X3) - 2 S1 J
}

__global__ void __launch_bounds__(kThreads, 1)
point_add_kernel(const int* __restrict__ x1, const int* __restrict__ y1,
                 const int* __restrict__ z1, const bool* __restrict__ i1,
                 const int* __restrict__ x2, const int* __restrict__ y2,
                 const int* __restrict__ z2, const bool* __restrict__ i2,
                 int* __restrict__ x3, int* __restrict__ y3, int* __restrict__ z3,
                 bool* __restrict__ i3, int m) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  const bool inf1 = i1[i], inf2 = i2[i];
  if (inf1 || inf2) {  // the other operand (or infinity, kept as given)
    const int* xs = inf1 ? x2 : x1;
    const int* ys = inf1 ? y2 : y1;
    const int* zs = inf1 ? z2 : z1;
#pragma unroll
    for (int l = 0; l < kNl; ++l) {
      x3[l * m + i] = xs[l * m + i];
      y3[l * m + i] = ys[l * m + i];
      z3[l * m + i] = zs[l * m + i];
    }
    i3[i] = inf1 && inf2;
    return;
  }
  // Z1 and Z2 die in ZZ = Z1 Z2 before the tests; the tangent path
  // reloads the operand it needs
  Fw ZZ, Zsq, U1, U2, S1, S2;
  {
    Fw Z1, Z2;
    from_limbs(Z1, z1, i, m);
    from_limbs(Z2, z2, i, m);
    mont(Zsq, Z2, Z2);
    from_limbs(U1, x1, i, m);
    mont(U1, U1, Zsq);  // X1 Z2^2
    from_limbs(S1, y1, i, m);
    mont(S1, S1, Z2);
    mont(S1, S1, Zsq);  // Y1 Z2^3
    mont(Zsq, Z1, Z1);
    from_limbs(U2, x2, i, m);
    mont(U2, U2, Zsq);  // X2 Z1^2
    from_limbs(S2, y2, i, m);
    mont(S2, S2, Z1);
    mont(S2, S2, Zsq);  // Y2 Z1^3
    mont(ZZ, Z1, Z2);
  }
  const bool same_x = eqw(U1, U2);
  const bool same_y = eqw(S1, S2);
  Fw X3, Y3, Z3;
  if (same_x && same_y) {
    Fw X1, Y1, Z1;
    from_limbs(X1, x1, i, m);
    from_limbs(Y1, y1, i, m);
    from_limbs(Z1, z1, i, m);
    point_double_w(X3, Y3, X1, Y1);
    mont(Z3, Y1, Z1);
    dblw(Z3, Z3);  // Zd = 2 Y Z
  } else {
    point_chord_w(X3, Y3, Z3, U1, U2, S1, S2);
    mont(Z3, ZZ, Z3);
    dblw(Z3, Z3);  // Z3 = 2 Z1 Z2 H
  }
  to_limbs(x3, X3, i, m);
  to_limbs(y3, Y3, i, m);
  to_limbs(z3, Z3, i, m);
  i3[i] = same_x && !same_y;
}

// affine + affine: Z1 = Z2 = one, so U = X, S = Y, and no product by Z
__global__ void __launch_bounds__(kThreads)
point_add_aff_kernel(const int* __restrict__ x1, const int* __restrict__ y1,
                     const bool* __restrict__ i1, const int* __restrict__ x2,
                     const int* __restrict__ y2, const bool* __restrict__ i2,
                     int* __restrict__ x3, int* __restrict__ y3, int* __restrict__ z3,
                     bool* __restrict__ i3, int m) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  const bool inf1 = i1[i], inf2 = i2[i];
  if (inf1 || inf2) {  // the other operand as given, with Z = one
    const int* xs = inf1 ? x2 : x1;
    const int* ys = inf1 ? y2 : y1;
#pragma unroll
    for (int l = 0; l < kNl; ++l) {
      x3[l * m + i] = xs[l * m + i];
      y3[l * m + i] = ys[l * m + i];
    }
    Fw one;
    load_exitw(one);
    store_limbs(z3, one, i, m);
    i3[i] = inf1 && inf2;
    return;
  }
  Fw X1, Y1, X2, Y2;
  from_limbs(X1, x1, i, m);
  from_limbs(X2, x2, i, m);
  from_limbs(Y1, y1, i, m);
  from_limbs(Y2, y2, i, m);
  const bool same_x = eqw(X1, X2);
  const bool same_y = eqw(Y1, Y2);
  Fw X3, Y3, Z3;
  if (same_x && same_y) {
    point_double_w(X3, Y3, X1, Y1);
    dblw(Z3, Y1);  // Zd = 2 Y
  } else {
    point_chord_w(X3, Y3, Z3, X1, X2, Y1, Y2);
    dblw(Z3, Z3);  // Z3 = 2 H
  }
  to_limbs(x3, X3, i, m);
  to_limbs(y3, Y3, i, m);
  to_limbs(z3, Z3, i, m);
  i3[i] = same_x && !same_y;
}

unsigned blocks_for(int m, int threads) {
  return static_cast<unsigned>((m + threads - 1) / threads);
}

}  // namespace

extern "C" {

// Each launcher runs on the given stream and returns cudaGetLastError().
int mont_mul_launch(const int* a, const int* b, int* out, int m, int depth, void* stream) {
  if (m <= 0 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  mont_mul_kernel<<<blocks_for(m, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, m, depth);
  return static_cast<int>(cudaGetLastError());
}

int point_add_launch(const int* x1, const int* y1, const int* z1, const bool* i1,
                     const int* x2, const int* y2, const int* z2, const bool* i2, int* x3,
                     int* y3, int* z3, bool* i3, int m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  point_add_kernel<<<blocks_for(m, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x1, y1, z1, i1, x2, y2, z2, i2, x3,
                                                          y3, z3, i3, m);
  return static_cast<int>(cudaGetLastError());
}

int point_add_aff_launch(const int* x1, const int* y1, const bool* i1, const int* x2,
                         const int* y2, const bool* i2, int* x3, int* y3, int* z3, bool* i3,
                         int m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  point_add_aff_kernel<<<blocks_for(m, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x1, y1, i1, x2, y2, i2, x3, y3,
                                                              z3, i3, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
