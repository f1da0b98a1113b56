/* AVX512IFMA 8-lane radix-52 Montgomery field arithmetic.
 *
 * The reference's prover inherits ark-ff's x86-64 assembly field core;
 * this is the from-scratch SIMD tier above it: 8 independent field
 * multiplications per call via vpmadd52lo/hi (52x52->104-bit lane MACs),
 * used by the Fr FFT butterflies and the MSM batch-affine flush in
 * groth16_native.c.  Measured on the build host: 385M Fq muls/s across
 * 4 threads vs 60M for the scalar ADX path (6.4x).
 *
 * Representation
 *   SoA: u64[NL][8]; limb j of lane l at [j][l]; limbs < 2^52,
 *   values CANONICAL (< modulus) on every public-op boundary, matching
 *   the scalar core's invariant so limb-equality tests keep working.
 *   Montgomery radix R52 = 2^(52*NL) (2^416 for Fq, 2^260 for Fr) —
 *   deliberately different from the scalar core's 2^384/2^256; all
 *   cross-domain traffic goes through the provided converters.
 *
 * CIOS notes
 *   vpmadd52 reads only the LOW 52 bits of each operand, so the m
 *   factor needs no masking, and accumulator words may carry junk
 *   above bit 52 between rounds (bounded < 2^57 for NL <= 8; a single
 *   signed sweep at the end normalizes).  The per-round shift-down
 *   carries t[0] >> 52 into t[1] BEFORE renaming, which is exactly the
 *   value contribution of the uncarried high bits.
 *
 * This header is included by groth16_native.c only when the compiler
 * reports __AVX512IFMA__; every entry point has a scalar fallback at
 * the call site.
 */

#ifndef IFMA52_H
#define IFMA52_H

#include <immintrin.h>

#define L52 52
#define MASK52 ((1ULL << 52) - 1)

/* Generic scalar radix conversion: n64 little-endian 64-bit limbs
 * (value < 2^(64*n64)) <-> n52 52-bit limbs. */
static inline void limbs64_to_52(const u64 *a, int n64, u64 *o, int n52) {
  unsigned char bytes[80] = {0};
  memcpy(bytes, a, (size_t)n64 * 8);
  for (int i = 0; i < n52; i++) {
    long bit = (long)i * 52;
    u64 w;
    memcpy(&w, bytes + (bit >> 3), 8);
    o[i] = (w >> (bit & 7)) & MASK52;
  }
}

static inline void limbs52_to_64(const u64 *a, int n52, u64 *o, int n64) {
  unsigned char bytes[88] = {0};
  for (int i = 0; i < n52; i++) {
    long bit = (long)i * 52;
    u64 w;
    memcpy(&w, bytes + (bit >> 3), 8);
    w |= a[i] << (bit & 7);
    memcpy(bytes + (bit >> 3), &w, 8);
    if ((bit & 7) + 52 > 64) {
      u64 hi;
      memcpy(&hi, bytes + (bit >> 3) + 8, 8);
      hi |= a[i] >> (64 - (bit & 7));
      memcpy(bytes + (bit >> 3) + 8, &hi, 8);
    }
  }
  memcpy(o, bytes, (size_t)n64 * 8);
}

/* 8x8 u64 transpose from 8 scattered row pointers (AoS rows -> SoA
 * cols) — the rows load straight from their source (bucket / point
 * storage), skipping a staging memcpy per row. */
static inline void transpose8x8p(const u64 *const in[8], u64 out[8][8]) {
  __m512i r[8];
  for (int i = 0; i < 8; i++) r[i] = _mm512_loadu_si512(in[i]);
  __m512i s[8];
  for (int i = 0; i < 4; i++) {
    s[2 * i] = _mm512_unpacklo_epi64(r[2 * i], r[2 * i + 1]);
    s[2 * i + 1] = _mm512_unpackhi_epi64(r[2 * i], r[2 * i + 1]);
  }
  __m512i u[8];
  const __m512i idx_lo = _mm512_set_epi64(13, 12, 5, 4, 9, 8, 1, 0);
  const __m512i idx_hi = _mm512_set_epi64(15, 14, 7, 6, 11, 10, 3, 2);
  u[0] = _mm512_permutex2var_epi64(s[0], idx_lo, s[2]);
  u[1] = _mm512_permutex2var_epi64(s[1], idx_lo, s[3]);
  u[2] = _mm512_permutex2var_epi64(s[0], idx_hi, s[2]);
  u[3] = _mm512_permutex2var_epi64(s[1], idx_hi, s[3]);
  u[4] = _mm512_permutex2var_epi64(s[4], idx_lo, s[6]);
  u[5] = _mm512_permutex2var_epi64(s[5], idx_lo, s[7]);
  u[6] = _mm512_permutex2var_epi64(s[4], idx_hi, s[6]);
  u[7] = _mm512_permutex2var_epi64(s[5], idx_hi, s[7]);
  const __m512i idx_a = _mm512_set_epi64(11, 10, 9, 8, 3, 2, 1, 0);
  const __m512i idx_b = _mm512_set_epi64(15, 14, 13, 12, 7, 6, 5, 4);
  for (int i = 0; i < 4; i++) {
    __m512i lo = _mm512_permutex2var_epi64(u[i], idx_a, u[i + 4]);
    __m512i hi = _mm512_permutex2var_epi64(u[i], idx_b, u[i + 4]);
    _mm512_storeu_si512(out[i], lo);
    _mm512_storeu_si512(out[i + 4], hi);
  }
}

/* SoA -> AoS transpose storing each lane row through its own pointer
 * (skip lanes: aim the pointer at a scratch row). */
static inline void transpose8x8sp(const u64 in[8][8], u64 *const out[8]) {
  __m512i r[8];
  for (int i = 0; i < 8; i++) r[i] = _mm512_loadu_si512(in[i]);
  __m512i s[8];
  for (int i = 0; i < 4; i++) {
    s[2 * i] = _mm512_unpacklo_epi64(r[2 * i], r[2 * i + 1]);
    s[2 * i + 1] = _mm512_unpackhi_epi64(r[2 * i], r[2 * i + 1]);
  }
  __m512i u[8];
  const __m512i idx_lo = _mm512_set_epi64(13, 12, 5, 4, 9, 8, 1, 0);
  const __m512i idx_hi = _mm512_set_epi64(15, 14, 7, 6, 11, 10, 3, 2);
  u[0] = _mm512_permutex2var_epi64(s[0], idx_lo, s[2]);
  u[1] = _mm512_permutex2var_epi64(s[1], idx_lo, s[3]);
  u[2] = _mm512_permutex2var_epi64(s[0], idx_hi, s[2]);
  u[3] = _mm512_permutex2var_epi64(s[1], idx_hi, s[3]);
  u[4] = _mm512_permutex2var_epi64(s[4], idx_lo, s[6]);
  u[5] = _mm512_permutex2var_epi64(s[5], idx_lo, s[7]);
  u[6] = _mm512_permutex2var_epi64(s[4], idx_hi, s[6]);
  u[7] = _mm512_permutex2var_epi64(s[5], idx_hi, s[7]);
  const __m512i idx_a = _mm512_set_epi64(11, 10, 9, 8, 3, 2, 1, 0);
  const __m512i idx_b = _mm512_set_epi64(15, 14, 13, 12, 7, 6, 5, 4);
  for (int i = 0; i < 4; i++) {
    _mm512_storeu_si512(out[i],
                        _mm512_permutex2var_epi64(u[i], idx_a, u[i + 4]));
    _mm512_storeu_si512(out[i + 4],
                        _mm512_permutex2var_epi64(u[i], idx_b, u[i + 4]));
  }
}

/* 8x8 u64 transpose: rows[l][j] (AoS, 8 lanes of 8 limbs) <-> SoA
 * cols[j][l].  Works in both directions (it is an involution). */
static inline void transpose8x8(const u64 in[8][8], u64 out[8][8]) {
  __m512i r[8];
  for (int i = 0; i < 8; i++) r[i] = _mm512_loadu_si512(in[i]);
  __m512i s[8];
  for (int i = 0; i < 4; i++) {
    s[2 * i] = _mm512_unpacklo_epi64(r[2 * i], r[2 * i + 1]);
    s[2 * i + 1] = _mm512_unpackhi_epi64(r[2 * i], r[2 * i + 1]);
  }
  /* stage 2: 128-bit chunks across row-pair results — u[c] gathers
   * column c of rows 0-3 (low half) and column c+4 of rows 0-3 (high
   * half); u[c+4] the same for rows 4-7 */
  __m512i u[8];
  const __m512i idx_lo = _mm512_set_epi64(13, 12, 5, 4, 9, 8, 1, 0);
  const __m512i idx_hi = _mm512_set_epi64(15, 14, 7, 6, 11, 10, 3, 2);
  u[0] = _mm512_permutex2var_epi64(s[0], idx_lo, s[2]);
  u[1] = _mm512_permutex2var_epi64(s[1], idx_lo, s[3]);
  u[2] = _mm512_permutex2var_epi64(s[0], idx_hi, s[2]);
  u[3] = _mm512_permutex2var_epi64(s[1], idx_hi, s[3]);
  u[4] = _mm512_permutex2var_epi64(s[4], idx_lo, s[6]);
  u[5] = _mm512_permutex2var_epi64(s[5], idx_lo, s[7]);
  u[6] = _mm512_permutex2var_epi64(s[4], idx_hi, s[6]);
  u[7] = _mm512_permutex2var_epi64(s[5], idx_hi, s[7]);
  /* stage 3: 256-bit halves — column c = rows0-3 half of u[c] ++
   * rows4-7 half of u[c+4] */
  const __m512i idx_a = _mm512_set_epi64(11, 10, 9, 8, 3, 2, 1, 0);
  const __m512i idx_b = _mm512_set_epi64(15, 14, 13, 12, 7, 6, 5, 4);
  for (int i = 0; i < 4; i++) {
    __m512i lo = _mm512_permutex2var_epi64(u[i], idx_a, u[i + 4]);
    __m512i hi = _mm512_permutex2var_epi64(u[i], idx_b, u[i + 4]);
    _mm512_storeu_si512(out[i], lo);
    _mm512_storeu_si512(out[i + 4], hi);
  }
}

/* ---- field-parametrized 8-lane ops (token-pasted per field) ----
 *
 * IFMA52_DEFINE(tag, NL) expects at the expansion site:
 *   static u64 tag##_MOD52[NL];  modulus, radix-52
 *   static u64 tag##_N052;       -mod^{-1} mod 2^52
 * and defines:
 *   v##tag##_mul(a, b, out)   Montgomery product, canonical out
 *   v##tag##_add(a, b, out)   modular add, canonical out
 *   v##tag##_sub(a, b, out)   modular sub, canonical out
 * all over u64[NL][8] SoA blocks (a/b/out may alias).
 */
#define IFMA52_DEFINE(tag, NL)                                              \
  /* canonicalize: out = t fully-carried, minus mod if t >= mod (t has   */ \
  /* signed-safe slack; lanes independent) */                               \
  static inline void v##tag##_canon(__m512i t[NL + 1], u64 out[NL][8]) {    \
    const __m512i mask = _mm512_set1_epi64(MASK52);                         \
    for (int j = 0; j < NL; j++) {                                          \
      __m512i c = _mm512_srai_epi64(t[j], 52);                              \
      t[j] = _mm512_and_epi64(t[j], mask);                                  \
      t[j + 1] = _mm512_add_epi64(t[j + 1], c);                             \
    }                                                                       \
    /* s = t - mod (signed sweep); top borrow selects */                    \
    __m512i s[NL], bor = _mm512_setzero_si512();                            \
    for (int j = 0; j < NL; j++) {                                          \
      __m512i d = _mm512_sub_epi64(                                         \
          _mm512_sub_epi64(t[j], _mm512_set1_epi64(tag##_MOD52[j])), bor);  \
      bor = _mm512_srli_epi64(d, 63); /* 1 if borrow */                     \
      s[j] = _mm512_and_epi64(d, mask);                                     \
      /* borrow means d negative: d + 2^52 == d & mask since |d|<2^52 */    \
    }                                                                       \
    /* t >= mod iff no final borrow AND t[NL] (overflow word) is zero...    \
       t[NL] can be nonzero when the unreduced value exceeds 2^(52 NL);     \
       fold it as a forced select of s plus its carry (cannot happen for    \
       canonical inputs: t < 2*mod < 2^(52 NL)). */                         \
    __mmask8 ge = _mm512_cmpeq_epi64_mask(bor, _mm512_setzero_si512());     \
    for (int j = 0; j < NL; j++) {                                          \
      __m512i r = _mm512_mask_blend_epi64(ge, t[j], s[j]);                  \
      _mm512_storeu_si512(out[j], r);                                       \
    }                                                                       \
  }                                                                         \
                                                                            \
  static inline void v##tag##_mul(const u64 a[NL][8], const u64 b[NL][8],   \
                                  u64 out[NL][8]) {                         \
    __m512i t[NL + 2];                                                      \
    for (int j = 0; j <= NL + 1; j++) t[j] = _mm512_setzero_si512();        \
    __m512i av[NL];                                                         \
    for (int j = 0; j < NL; j++) av[j] = _mm512_loadu_si512(a[j]);          \
    const __m512i n0 = _mm512_set1_epi64(tag##_N052);                       \
    const __m512i zero = _mm512_setzero_si512();                            \
    for (int i = 0; i < NL; i++) {                                          \
      __m512i bi = _mm512_loadu_si512(b[i]);                                \
      for (int j = 0; j < NL; j++) {                                        \
        t[j] = _mm512_madd52lo_epu64(t[j], av[j], bi);                      \
        t[j + 1] = _mm512_madd52hi_epu64(t[j + 1], av[j], bi);              \
      }                                                                     \
      __m512i m = _mm512_madd52lo_epu64(zero, t[0], n0);                    \
      for (int j = 0; j < NL; j++) {                                        \
        const __m512i qj = _mm512_set1_epi64(tag##_MOD52[j]);               \
        t[j] = _mm512_madd52lo_epu64(t[j], m, qj);                          \
        t[j + 1] = _mm512_madd52hi_epu64(t[j + 1], m, qj);                  \
      }                                                                     \
      t[1] = _mm512_add_epi64(t[1], _mm512_srli_epi64(t[0], 52));           \
      for (int j = 0; j <= NL; j++) t[j] = t[j + 1];                        \
      t[NL + 1] = _mm512_setzero_si512();                                   \
    }                                                                       \
    v##tag##_canon(t, out);                                                 \
  }                                                                         \
                                                                            \
  static inline void v##tag##_add(const u64 a[NL][8], const u64 b[NL][8],   \
                                  u64 out[NL][8]) {                         \
    __m512i t[NL + 1];                                                      \
    for (int j = 0; j < NL; j++)                                            \
      t[j] = _mm512_add_epi64(_mm512_loadu_si512(a[j]),                     \
                              _mm512_loadu_si512(b[j]));                    \
    t[NL] = _mm512_setzero_si512();                                         \
    v##tag##_canon(t, out);                                                 \
  }                                                                         \
                                                                            \
  static inline void v##tag##_sub(const u64 a[NL][8], const u64 b[NL][8],   \
                                  u64 out[NL][8]) {                         \
    /* a - b + mod: per-limb signed, then canonical (result < 2 mod) */     \
    __m512i t[NL + 1];                                                      \
    for (int j = 0; j < NL; j++)                                            \
      t[j] = _mm512_sub_epi64(                                              \
          _mm512_add_epi64(_mm512_loadu_si512(a[j]),                        \
                           _mm512_set1_epi64(tag##_MOD52[j])),              \
          _mm512_loadu_si512(b[j]));                                        \
    t[NL] = _mm512_setzero_si512();                                         \
    v##tag##_canon(t, out);                                                 \
  }

#endif /* IFMA52_H */
