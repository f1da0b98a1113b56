/* Native Groth16 hot loops: BLS12-381 Montgomery arithmetic, Pippenger
 * MSM, fixed-base CRS generation, and Fr radix-2 FFT.
 *
 * The reference gets these from ark-ec/ark-poly (Rust + rayon); this is
 * the from-scratch C equivalent driven via ctypes
 * (falcon_r1cs_tpu/snark/native_backend.py), parallelized with OpenMP.
 * Differentially tested limb-for-limb against the pure-Python
 * implementation in falcon_r1cs_tpu/snark/{bls12_381,msm,fr}.py.
 *
 * Interface conventions:
 *   - field elements cross the boundary as little-endian u64 limb arrays
 *     in STANDARD (non-Montgomery) form: Fq = 6 limbs, Fr = 4 limbs;
 *   - G1 affine points are (x[6], y[6]) + a uint8 infinity flag;
 *     G2 affine points are (x[12], y[12]) (c0 then c1 limbs) + flag;
 *   - scalars are Fr standard-form (n,4) arrays, already reduced mod r.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#ifdef _OPENMP
#include <omp.h>
#endif

typedef uint64_t u64;
typedef unsigned __int128 u128;

/* ----------------------------------------------------------------- Fq -- */

#define NQ 6
static const u64 Q[NQ] = {
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL};
static u64 Q_N0;        /* -q^{-1} mod 2^64 */
static u64 Q_R2[NQ];    /* 2^768 mod q (to-Montgomery factor) */
static u64 Q_ONE[NQ];   /* 2^384 mod q (Montgomery one) */

#define NR 4
static const u64 FRM[NR] = {
    0xffffffff00000001ULL, 0x53bda402fffe5bfeULL, 0x3339d80809a1d805ULL,
    0x73eda753299d7d48ULL};
static u64 FR_N0;
static u64 FR_R2[NR];
static u64 FR_ONE[NR];

/* generic helpers over n limbs */
static int ge_n(const u64 *a, const u64 *m, int n) {
  for (int i = n - 1; i >= 0; i--) {
    if (a[i] > m[i]) return 1;
    if (a[i] < m[i]) return 0;
  }
  return 1;
}

static void sub_n(u64 *a, const u64 *m, int n) { /* a -= m (a >= m) */
  u128 borrow = 0;
  for (int i = 0; i < n; i++) {
    u128 d = (u128)a[i] - m[i] - borrow;
    a[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static void add_mod_n(const u64 *a, const u64 *b, u64 *out, const u64 *m,
                      int n) {
  u128 carry = 0;
  for (int i = 0; i < n; i++) {
    u128 s = (u128)a[i] + b[i] + carry;
    out[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || ge_n(out, m, n)) sub_n(out, m, n);
}

static void sub_mod_n(const u64 *a, const u64 *b, u64 *out, const u64 *m,
                      int n) {
  u128 borrow = 0;
  for (int i = 0; i < n; i++) {
    u128 d = (u128)a[i] - b[i] - borrow;
    out[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < n; i++) {
      u128 s = (u128)out[i] + m[i] + carry;
      out[i] = (u64)s;
      carry = s >> 64;
    }
  }
}

static int is_zero_n(const u64 *a, int n) {
  for (int i = 0; i < n; i++)
    if (a[i]) return 0;
  return 1;
}

/* ADX/BMI2 fast path: fully-unrolled CIOS with dual carry chains
 * (generated by tools/gen_adx_mont.py into adx_mont.h).  Measured
 * ~55 ns vs ~100 ns for the u128 loop below on the build host
 * (dependent-chain latency; bit-identical outputs). */
#if defined(__ADX__) && defined(__BMI2__) && defined(__x86_64__)
#define HAVE_ADX_MONT 1
#include "adx_mont.h"
#endif

/* CIOS Montgomery multiplication, n limbs */
static void mont_mul_n(const u64 *a, const u64 *b, u64 *out, const u64 *m,
                       u64 n0, int n) {
  u64 t[NQ + 2];
  memset(t, 0, (n + 2) * sizeof(u64));
  for (int i = 0; i < n; i++) {
    u128 carry = 0;
    for (int j = 0; j < n; j++) {
      u128 cur = (u128)a[j] * b[i] + t[j] + carry;
      t[j] = (u64)cur;
      carry = cur >> 64;
    }
    u128 s = (u128)t[n] + carry;
    t[n] = (u64)s;
    t[n + 1] = (u64)(s >> 64);
    u64 mfac = t[0] * n0;
    u128 cur = (u128)mfac * m[0] + t[0];
    carry = cur >> 64;
    for (int j = 1; j < n; j++) {
      cur = (u128)mfac * m[j] + t[j] + carry;
      t[j - 1] = (u64)cur;
      carry = cur >> 64;
    }
    s = (u128)t[n] + carry;
    t[n - 1] = (u64)s;
    t[n] = t[n + 1] + (u64)(s >> 64);
  }
  if (t[n] || ge_n(t, m, n)) sub_n(t, m, n);
  memcpy(out, t, n * sizeof(u64));
}

/* Fq wrappers */
static void fq_mul(const u64 *a, const u64 *b, u64 *o) {
#ifdef HAVE_ADX_MONT
  mont_mul_6_adx(a, b, o, Q, Q_N0);
#else
  mont_mul_n(a, b, o, Q, Q_N0, NQ);
#endif
}
static void fq_sqr(const u64 *a, u64 *o) { fq_mul(a, a, o); }
static void fq_add(const u64 *a, const u64 *b, u64 *o) {
  add_mod_n(a, b, o, Q, NQ);
}
static void fq_sub(const u64 *a, const u64 *b, u64 *o) {
  sub_mod_n(a, b, o, Q, NQ);
}
static void fq_neg(const u64 *a, u64 *o) {
  if (is_zero_n(a, NQ)) {
    memset(o, 0, NQ * 8);
  } else {
    u64 t[NQ];
    memcpy(t, Q, NQ * 8);
    sub_n(t, a, NQ);
    memcpy(o, t, NQ * 8);
  }
}
static void fq_dbl(const u64 *a, u64 *o) { fq_add(a, a, o); }
static void fq_to_mont(const u64 *a, u64 *o) { fq_mul(a, Q_R2, o); }
static void fq_from_mont(const u64 *a, u64 *o) {
  u64 one[NQ] = {1};
  fq_mul(a, one, o);
}
/* Fermat inversion (Montgomery in/out): a^(q-2) */
static void fq_inv(const u64 *a, u64 *o) {
  u64 e[NQ];
  memcpy(e, Q, NQ * 8);
  e[0] -= 2; /* q is odd, no borrow */
  u64 base[NQ], acc[NQ];
  memcpy(base, a, NQ * 8);
  memcpy(acc, Q_ONE, NQ * 8);
  for (int i = 0; i < NQ * 64; i++) {
    if ((e[i >> 6] >> (i & 63)) & 1) fq_mul(acc, base, acc);
    fq_sqr(base, base);
  }
  memcpy(o, acc, NQ * 8);
}

/* Binary extended-GCD inversion (Montgomery in/out), ~15x cheaper than
 * the Fermat ladder: for input x = a*R, the integer xgcd gives
 * x^-1 = a^-1 R^-1 (standard); two R^2 Montgomery muls lift it back to
 * a^-1 R.  Used by the batch-affine MSM flush where inversion cost sets
 * the amortized per-point price. */
static void shr1_carry(u64 *a, u64 top, int n) { /* a = (top:a) >> 1 */
  for (int i = 0; i < n - 1; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
  a[n - 1] = (a[n - 1] >> 1) | (top << 63);
}

static void fq_inv_fast(const u64 *a, u64 *o) {
  u64 u[NQ], v[NQ], b[NQ], c[NQ];
  /* u = a as a standard integer (Montgomery rep IS an integer mod q) */
  memcpy(u, a, NQ * 8);
  memcpy(v, Q, NQ * 8);
  memset(b, 0, NQ * 8);
  b[0] = 1;
  memset(c, 0, NQ * 8);
  while (!is_zero_n(u, NQ)) {
    while (!(u[0] & 1)) {
      shr1_carry(u, 0, NQ);
      if (b[0] & 1) { /* b = (b + q)/2 with the carry bit */
        u128 carry = 0;
        for (int i = 0; i < NQ; i++) {
          u128 s = (u128)b[i] + Q[i] + carry;
          b[i] = (u64)s;
          carry = s >> 64;
        }
        shr1_carry(b, (u64)carry, NQ);
      } else {
        shr1_carry(b, 0, NQ);
      }
    }
    while (!(v[0] & 1)) {
      shr1_carry(v, 0, NQ);
      if (c[0] & 1) {
        u128 carry = 0;
        for (int i = 0; i < NQ; i++) {
          u128 s = (u128)c[i] + Q[i] + carry;
          c[i] = (u64)s;
          carry = s >> 64;
        }
        shr1_carry(c, (u64)carry, NQ);
      } else {
        shr1_carry(c, 0, NQ);
      }
    }
    if (ge_n(u, v, NQ)) {
      sub_n(u, v, NQ);
      sub_mod_n(b, c, b, Q, NQ);
    } else {
      sub_n(v, u, NQ);
      sub_mod_n(c, b, c, Q, NQ);
    }
  }
  /* v == gcd == 1 (q prime, a != 0); c = x^-1 standard */
  u64 t[NQ];
  fq_mul(c, Q_R2, t); /* = a^-1 standard */
  fq_mul(t, Q_R2, o); /* = a^-1 Montgomery */
}

/* Fr wrappers */
static void fr_mul(const u64 *a, const u64 *b, u64 *o) {
#ifdef HAVE_ADX_MONT
  mont_mul_4_adx(a, b, o, FRM, FR_N0);
#else
  mont_mul_n(a, b, o, FRM, FR_N0, NR);
#endif
}
static void fr_add(const u64 *a, const u64 *b, u64 *o) {
  add_mod_n(a, b, o, FRM, NR);
}
static void fr_sub(const u64 *a, const u64 *b, u64 *o) {
  sub_mod_n(a, b, o, FRM, NR);
}
static void fr_to_mont(const u64 *a, u64 *o) { fr_mul(a, FR_R2, o); }
static void fr_from_mont(const u64 *a, u64 *o) {
  u64 one[NR] = {1};
  fr_mul(a, one, o);
}
static void fr_pow(const u64 *a_mont, const u64 *e, int ebits, u64 *o) {
  u64 base[NR], acc[NR];
  memcpy(base, a_mont, NR * 8);
  memcpy(acc, FR_ONE, NR * 8);
  for (int i = 0; i < ebits; i++) {
    if ((e[i >> 6] >> (i & 63)) & 1) fr_mul(acc, base, acc);
    fr_mul(base, base, base);
  }
  memcpy(o, acc, NR * 8);
}
static void fr_inv(const u64 *a_mont, u64 *o) {
  u64 e[NR];
  memcpy(e, FRM, NR * 8);
  e[0] -= 2;
  fr_pow(a_mont, e, NR * 64, o);
}

/* ---------------------------------------------------------------- Fq2 -- */

typedef struct {
  u64 c0[NQ], c1[NQ];
} fq2;

static void f2_add(const fq2 *a, const fq2 *b, fq2 *o) {
  fq_add(a->c0, b->c0, o->c0);
  fq_add(a->c1, b->c1, o->c1);
}
static void f2_sub(const fq2 *a, const fq2 *b, fq2 *o) {
  fq_sub(a->c0, b->c0, o->c0);
  fq_sub(a->c1, b->c1, o->c1);
}
static void f2_dbl(const fq2 *a, fq2 *o) { f2_add(a, a, o); }
static void f2_neg(const fq2 *a, fq2 *o) {
  fq_neg(a->c0, o->c0);
  fq_neg(a->c1, o->c1);
}
static void f2_mul(const fq2 *a, const fq2 *b, fq2 *o) {
  u64 t0[NQ], t1[NQ], s0[NQ], s1[NQ], r0[NQ];
  fq_mul(a->c0, b->c0, t0);
  fq_mul(a->c1, b->c1, t1);
  fq_add(a->c0, a->c1, s0);
  fq_add(b->c0, b->c1, s1);
  fq_sub(t0, t1, r0);
  fq_mul(s0, s1, s0);
  fq_sub(s0, t0, s0);
  fq_sub(s0, t1, o->c1);
  memcpy(o->c0, r0, NQ * 8);
}
static void f2_sqr(const fq2 *a, fq2 *o) {
  u64 s[NQ], d[NQ], m[NQ];
  fq_add(a->c0, a->c1, s);
  fq_sub(a->c0, a->c1, d);
  fq_mul(a->c0, a->c1, m);
  fq_mul(s, d, o->c0);
  fq_dbl(m, o->c1);
}
static void fq_inv_fast(const u64 *a, u64 *o); /* eGCD, defined below */
static void f2_inv(const fq2 *a, fq2 *o) {
  u64 n0_[NQ], n1[NQ], ninv[NQ];
  fq_sqr(a->c0, n0_);
  fq_sqr(a->c1, n1);
  fq_add(n0_, n1, n0_);
  fq_inv_fast(n0_, ninv); /* eGCD: ~15x cheaper than the Fermat ladder */
  fq_mul(a->c0, ninv, o->c0);
  u64 t[NQ];
  fq_mul(a->c1, ninv, t);
  fq_neg(t, o->c1);
}
static int f2_is_zero(const fq2 *a) {
  return is_zero_n(a->c0, NQ) && is_zero_n(a->c1, NQ);
}
static int f2_eq(const fq2 *a, const fq2 *b) {
  return !memcmp(a->c0, b->c0, NQ * 8) && !memcmp(a->c1, b->c1, NQ * 8);
}

/* ------------------------------------------------ Jacobian points: G1 -- */

typedef struct {
  u64 x[NQ], y[NQ], z[NQ];
} g1p; /* infinity iff z == 0 */

static void g1_set_inf(g1p *p) { memset(p, 0, sizeof(*p)); }
static int g1_is_inf(const g1p *p) { return is_zero_n(p->z, NQ); }

static void g1_dbl(const g1p *p, g1p *o) {
  if (g1_is_inf(p)) {
    *o = *p;
    return;
  }
  u64 A[NQ], B[NQ], C[NQ], D[NQ], E[NQ], F[NQ], t[NQ];
  fq_sqr(p->x, A);
  fq_sqr(p->y, B);
  fq_sqr(B, C);
  fq_add(p->x, B, t);
  fq_sqr(t, t);
  fq_sub(t, A, t);
  fq_sub(t, C, t);
  fq_dbl(t, D);
  fq_dbl(A, E);
  fq_add(E, A, E);
  fq_sqr(E, F);
  u64 x3[NQ], y3[NQ], z3[NQ];
  fq_dbl(D, t);
  fq_sub(F, t, x3);
  fq_sub(D, x3, t);
  fq_mul(E, t, y3);
  fq_dbl(C, t);
  fq_dbl(t, t);
  fq_dbl(t, t); /* 8C */
  fq_sub(y3, t, y3);
  fq_mul(p->y, p->z, z3);
  fq_dbl(z3, z3);
  memcpy(o->x, x3, NQ * 8);
  memcpy(o->y, y3, NQ * 8);
  memcpy(o->z, z3, NQ * 8);
}

static void g1_add(const g1p *p, const g1p *q, g1p *o) {
  if (g1_is_inf(p)) {
    *o = *q;
    return;
  }
  if (g1_is_inf(q)) {
    *o = *p;
    return;
  }
  u64 z1z1[NQ], z2z2[NQ], u1[NQ], u2[NQ], s1[NQ], s2[NQ];
  fq_sqr(p->z, z1z1);
  fq_sqr(q->z, z2z2);
  fq_mul(p->x, z2z2, u1);
  fq_mul(q->x, z1z1, u2);
  u64 t[NQ];
  fq_mul(p->y, q->z, t);
  fq_mul(t, z2z2, s1);
  fq_mul(q->y, p->z, t);
  fq_mul(t, z1z1, s2);
  if (!memcmp(u1, u2, NQ * 8)) {
    if (memcmp(s1, s2, NQ * 8)) {
      g1_set_inf(o);
      return;
    }
    g1_dbl(p, o);
    return;
  }
  u64 H[NQ], I[NQ], J[NQ], rr[NQ], V[NQ];
  fq_sub(u2, u1, H);
  fq_dbl(H, t);
  fq_sqr(t, I);
  fq_mul(H, I, J);
  fq_sub(s2, s1, t);
  fq_dbl(t, rr);
  fq_mul(u1, I, V);
  u64 x3[NQ], y3[NQ], z3[NQ];
  fq_sqr(rr, x3);
  fq_sub(x3, J, x3);
  fq_dbl(V, t);
  fq_sub(x3, t, x3);
  fq_sub(V, x3, t);
  fq_mul(rr, t, y3);
  fq_mul(s1, J, t);
  fq_dbl(t, t);
  fq_sub(y3, t, y3);
  fq_mul(p->z, q->z, z3);
  fq_mul(z3, H, z3);
  fq_dbl(z3, z3);
  memcpy(o->x, x3, NQ * 8);
  memcpy(o->y, y3, NQ * 8);
  memcpy(o->z, z3, NQ * 8);
}

/* mixed add: q affine (Montgomery coords), madd-2007-bl */
static void g1_madd(const g1p *p, const u64 *qx, const u64 *qy, g1p *o) {
  if (g1_is_inf(p)) {
    memcpy(o->x, qx, NQ * 8);
    memcpy(o->y, qy, NQ * 8);
    memcpy(o->z, Q_ONE, NQ * 8);
    return;
  }
  u64 z1z1[NQ], u2[NQ], s2[NQ], t[NQ];
  fq_sqr(p->z, z1z1);
  fq_mul(qx, z1z1, u2);
  fq_mul(qy, p->z, t);
  fq_mul(t, z1z1, s2);
  if (!memcmp(p->x, u2, NQ * 8)) {
    if (memcmp(p->y, s2, NQ * 8)) {
      g1_set_inf(o);
      return;
    }
    g1_dbl(p, o);
    return;
  }
  u64 H[NQ], HH[NQ], I[NQ], J[NQ], rr[NQ], V[NQ];
  fq_sub(u2, p->x, H);
  fq_sqr(H, HH);
  fq_dbl(HH, I);
  fq_dbl(I, I);
  fq_mul(H, I, J);
  fq_sub(s2, p->y, t);
  fq_dbl(t, rr);
  fq_mul(p->x, I, V);
  u64 x3[NQ], y3[NQ], z3[NQ];
  fq_sqr(rr, x3);
  fq_sub(x3, J, x3);
  fq_dbl(V, t);
  fq_sub(x3, t, x3);
  fq_sub(V, x3, t);
  fq_mul(rr, t, y3);
  fq_mul(p->y, J, t);
  fq_dbl(t, t);
  fq_sub(y3, t, y3);
  fq_add(p->z, H, z3);
  fq_sqr(z3, z3);
  fq_sub(z3, z1z1, z3);
  fq_sub(z3, HH, z3);
  memcpy(o->x, x3, NQ * 8);
  memcpy(o->y, y3, NQ * 8);
  memcpy(o->z, z3, NQ * 8);
}

/* ------------------------------------------------ Jacobian points: G2 -- */

typedef struct {
  fq2 x, y, z;
} g2p;

static void g2_set_inf(g2p *p) { memset(p, 0, sizeof(*p)); }
static int g2_is_inf(const g2p *p) { return f2_is_zero(&p->z); }

static void g2_dbl(const g2p *p, g2p *o) {
  if (g2_is_inf(p)) {
    *o = *p;
    return;
  }
  fq2 A, B, C, D, E, F, t;
  f2_sqr(&p->x, &A);
  f2_sqr(&p->y, &B);
  f2_sqr(&B, &C);
  f2_add(&p->x, &B, &t);
  f2_sqr(&t, &t);
  f2_sub(&t, &A, &t);
  f2_sub(&t, &C, &t);
  f2_dbl(&t, &D);
  f2_dbl(&A, &E);
  f2_add(&E, &A, &E);
  f2_sqr(&E, &F);
  fq2 x3, y3, z3;
  f2_dbl(&D, &t);
  f2_sub(&F, &t, &x3);
  f2_sub(&D, &x3, &t);
  f2_mul(&E, &t, &y3);
  f2_dbl(&C, &t);
  f2_dbl(&t, &t);
  f2_dbl(&t, &t);
  f2_sub(&y3, &t, &y3);
  f2_mul(&p->y, &p->z, &z3);
  f2_dbl(&z3, &z3);
  o->x = x3;
  o->y = y3;
  o->z = z3;
}

static void g2_add(const g2p *p, const g2p *q, g2p *o) {
  if (g2_is_inf(p)) {
    *o = *q;
    return;
  }
  if (g2_is_inf(q)) {
    *o = *p;
    return;
  }
  fq2 z1z1, z2z2, u1, u2, s1, s2, t;
  f2_sqr(&p->z, &z1z1);
  f2_sqr(&q->z, &z2z2);
  f2_mul(&p->x, &z2z2, &u1);
  f2_mul(&q->x, &z1z1, &u2);
  f2_mul(&p->y, &q->z, &t);
  f2_mul(&t, &z2z2, &s1);
  f2_mul(&q->y, &p->z, &t);
  f2_mul(&t, &z1z1, &s2);
  if (f2_eq(&u1, &u2)) {
    if (!f2_eq(&s1, &s2)) {
      g2_set_inf(o);
      return;
    }
    g2_dbl(p, o);
    return;
  }
  fq2 H, I, J, rr, V;
  f2_sub(&u2, &u1, &H);
  f2_dbl(&H, &t);
  f2_sqr(&t, &I);
  f2_mul(&H, &I, &J);
  f2_sub(&s2, &s1, &t);
  f2_dbl(&t, &rr);
  f2_mul(&u1, &I, &V);
  fq2 x3, y3, z3;
  f2_sqr(&rr, &x3);
  f2_sub(&x3, &J, &x3);
  f2_dbl(&V, &t);
  f2_sub(&x3, &t, &x3);
  f2_sub(&V, &x3, &t);
  f2_mul(&rr, &t, &y3);
  f2_mul(&s1, &J, &t);
  f2_dbl(&t, &t);
  f2_sub(&y3, &t, &y3);
  f2_mul(&p->z, &q->z, &z3);
  f2_mul(&z3, &H, &z3);
  f2_dbl(&z3, &z3);
  o->x = x3;
  o->y = y3;
  o->z = z3;
}

static void g2_madd(const g2p *p, const fq2 *qx, const fq2 *qy, g2p *o) {
  if (g2_is_inf(p)) {
    o->x = *qx;
    o->y = *qy;
    memcpy(o->z.c0, Q_ONE, NQ * 8);
    memset(o->z.c1, 0, NQ * 8);
    return;
  }
  fq2 z1z1, u2, s2, t;
  f2_sqr(&p->z, &z1z1);
  f2_mul(qx, &z1z1, &u2);
  f2_mul(qy, &p->z, &t);
  f2_mul(&t, &z1z1, &s2);
  if (f2_eq(&p->x, &u2)) {
    if (!f2_eq(&p->y, &s2)) {
      g2_set_inf(o);
      return;
    }
    g2_dbl(p, o);
    return;
  }
  fq2 H, HH, I, J, rr, V;
  f2_sub(&u2, &p->x, &H);
  f2_sqr(&H, &HH);
  f2_dbl(&HH, &I);
  f2_dbl(&I, &I);
  f2_mul(&H, &I, &J);
  f2_sub(&s2, &p->y, &t);
  f2_dbl(&t, &rr);
  f2_mul(&p->x, &I, &V);
  fq2 x3, y3, z3;
  f2_sqr(&rr, &x3);
  f2_sub(&x3, &J, &x3);
  f2_dbl(&V, &t);
  f2_sub(&x3, &t, &x3);
  f2_sub(&V, &x3, &t);
  f2_mul(&rr, &t, &y3);
  f2_mul(&p->y, &J, &t);
  f2_dbl(&t, &t);
  f2_sub(&y3, &t, &y3);
  f2_add(&p->z, &H, &z3);
  f2_sqr(&z3, &z3);
  f2_sub(&z3, &z1z1, &z3);
  f2_sub(&z3, &HH, &z3);
  o->x = x3;
  o->y = y3;
  o->z = z3;
}

/* --------------------------------------------- IFMA 8-lane tier -------- */

#if defined(__AVX512IFMA__) && defined(__AVX512F__)
#define HAVE_IFMA52 1
#include "ifma52.h"
#define NQ52 8 /* 8 * 52 = 416 >= 384 */
#define NR52 5 /* 5 * 52 = 260 >= 256 */
static u64 FQ_MOD52[NQ52];
static u64 FQ_N052;
static u64 FR_MOD52[NR52];
static u64 FR_N052;
/* to-Mont52 factors: R52^2 expressed in the 52-domain's Montgomery
 * sense, i.e. 2^(2*52*NL) mod m, stored radix-52 and splatted SoA */
static u64 FQ_R52SQ[NQ52][8];
static u64 FR_R52SQ[NR52][8];
static u64 FQ_ONE52[NQ52][8]; /* literal integer 1 (for from-Mont52) */
static u64 FR_ONE52[NR52][8];
static u64 FQ_W416[NQ];        /* 2^416 mod q, plain radix64 */
static u64 FQ_W352[NQ];        /* 2^352 mod q, plain radix64 */
static u64 FQ_ONE52V[NQ52];    /* Mont52(1) = 2^416 mod q, radix52 row */
static u64 FQ_ONE52M[NQ52][8]; /* ... splatted SoA */
IFMA52_DEFINE(FQ, NQ52)
IFMA52_DEFINE(FR, NR52)
#endif

/* ------------------------------------------------------- init ---------- */

static int initialized = 0;

static u64 neg_inv64(u64 x) { /* -x^{-1} mod 2^64, x odd */
  u64 inv = 1;
  for (int i = 0; i < 6; i++) inv *= 2 - x * inv; /* Newton, 64-bit wrap */
  return (u64)(0 - inv);
}

static void compute_r2(const u64 *m, int n, u64 *r2out, u64 *oneout) {
  /* one = 2^(64n) mod m via 64n doublings from 1; r2 = one doubled 64n more */
  u64 acc[NQ] = {0};
  acc[0] = 1;
  for (int i = 0; i < 64 * n; i++) add_mod_n(acc, acc, acc, m, n);
  memcpy(oneout, acc, n * 8);
  for (int i = 0; i < 64 * n; i++) add_mod_n(acc, acc, acc, m, n);
  memcpy(r2out, acc, n * 8);
}

void g16_init(void) {
  if (initialized) return;
  Q_N0 = neg_inv64(Q[0]);
  FR_N0 = neg_inv64(FRM[0]);
  compute_r2(Q, NQ, Q_R2, Q_ONE);
  compute_r2(FRM, NR, FR_R2, FR_ONE);
#ifdef HAVE_IFMA52
  limbs64_to_52(Q, NQ, FQ_MOD52, NQ52);
  limbs64_to_52(FRM, NR, FR_MOD52, NR52);
  FQ_N052 = Q_N0 & MASK52; /* inverse mod 2^64 masks to mod 2^52 */
  FR_N052 = FR_N0 & MASK52;
  /* 2^(2*52*NL) mod m by doubling from 1, then splat across lanes */
  u64 acc[NQ] = {1}, t52[NQ52];
  for (int i = 0; i < 2 * 52 * NQ52; i++) add_mod_n(acc, acc, acc, Q, NQ);
  limbs64_to_52(acc, NQ, t52, NQ52);
  for (int j = 0; j < NQ52; j++)
    for (int l = 0; l < 8; l++) FQ_R52SQ[j][l] = t52[j];
  memset(acc, 0, sizeof(acc));
  acc[0] = 1;
  for (int i = 0; i < 2 * 52 * NR52; i++) add_mod_n(acc, acc, acc, FRM, NR);
  limbs64_to_52(acc, NR, t52, NR52);
  for (int j = 0; j < NR52; j++)
    for (int l = 0; l < 8; l++) FR_R52SQ[j][l] = t52[j];
  memset(FQ_ONE52, 0, sizeof(FQ_ONE52));
  memset(FR_ONE52, 0, sizeof(FR_ONE52));
  for (int l = 0; l < 8; l++) FQ_ONE52[0][l] = FR_ONE52[0][l] = 1;
  /* MSM domain-shift constants: 2^416 and 2^352 mod q (plain radix64) */
  memset(acc, 0, sizeof(acc));
  acc[0] = 1;
  for (int i = 0; i < 416; i++) add_mod_n(acc, acc, acc, Q, NQ);
  memcpy(FQ_W416, acc, NQ * 8);
  memset(FQ_W352, 0, sizeof(FQ_W352));
  FQ_W352[5] = 1ULL << 32; /* 2^352 = 2^(5*64+32) < q, exact */
  limbs64_to_52(FQ_W416, NQ, FQ_ONE52V, NQ52); /* Mont52(1) = 2^416 */
  for (int j = 0; j < NQ52; j++)
    for (int l = 0; l < 8; l++) FQ_ONE52M[j][l] = FQ_ONE52V[j];
#endif
  initialized = 1;
}

/* ------------------------------------------------------- batch utils --- */

/* Jacobian -> affine (standard form out), batched inversion, G1 */
static void g1_normalize_batch(const g1p *pts, long n, u64 *xs, u64 *ys,
                               uint8_t *inf) {
#pragma omp parallel
  {
    long chunk = 4096;
#pragma omp for schedule(dynamic)
    for (long c0 = 0; c0 < n; c0 += chunk) {
      long c1 = c0 + chunk < n ? c0 + chunk : n;
      /* prefix products of z */
      u64(*pre)[NQ] = malloc((c1 - c0 + 1) * sizeof(*pre));
      memcpy(pre[0], Q_ONE, NQ * 8);
      long k = 0;
      for (long i = c0; i < c1; i++) {
        if (g1_is_inf(&pts[i]))
          memcpy(pre[k + 1], pre[k], NQ * 8);
        else
          fq_mul(pre[k], pts[i].z, pre[k + 1]);
        k++;
      }
      u64 invall[NQ];
      fq_inv(pre[c1 - c0], invall);
      for (long i = c1 - 1; i >= c0; i--) {
        k = i - c0;
        if (g1_is_inf(&pts[i])) {
          inf[i] = 1;
          memset(xs + i * NQ, 0, NQ * 8);
          memset(ys + i * NQ, 0, NQ * 8);
          continue;
        }
        u64 zinv[NQ], zi2[NQ], t[NQ];
        fq_mul(pre[k], invall, zinv);
        fq_mul(invall, pts[i].z, invall);
        fq_sqr(zinv, zi2);
        fq_mul(pts[i].x, zi2, t);
        fq_from_mont(t, xs + i * NQ);
        fq_mul(pts[i].y, zi2, t);
        fq_mul(t, zinv, t);
        fq_from_mont(t, ys + i * NQ);
        inf[i] = 0;
      }
      free(pre);
    }
  }
}

static void g2_normalize_batch(const g2p *pts, long n, u64 *xs, u64 *ys,
                               uint8_t *inf) {
  /* simple per-point inversion (G2 batches are smaller); still parallel */
#pragma omp parallel for schedule(dynamic, 256)
  for (long i = 0; i < n; i++) {
    if (g2_is_inf(&pts[i])) {
      inf[i] = 1;
      memset(xs + i * 2 * NQ, 0, 2 * NQ * 8);
      memset(ys + i * 2 * NQ, 0, 2 * NQ * 8);
      continue;
    }
    fq2 zinv, zi2, t;
    f2_inv(&pts[i].z, &zinv);
    f2_sqr(&zinv, &zi2);
    f2_mul(&pts[i].x, &zi2, &t);
    fq_from_mont(t.c0, xs + i * 2 * NQ);
    fq_from_mont(t.c1, xs + i * 2 * NQ + NQ);
    f2_mul(&pts[i].y, &zi2, &t);
    f2_mul(&t, &zinv, &t);
    fq_from_mont(t.c0, ys + i * 2 * NQ);
    fq_from_mont(t.c1, ys + i * 2 * NQ + NQ);
    inf[i] = 0;
  }
}

/* -------------------------------------------------- fixed-base tables -- */

static const u64 G1X[NQ] = {
    0xfb3af00adb22c6bbULL, 0x6c55e83ff97a1aefULL, 0xa14e3a3f171bac58ULL,
    0xc3688c4f9774b905ULL, 0x2695638c4fa9ac0fULL, 0x17f1d3a73197d794ULL};
static const u64 G1Y[NQ] = {
    0x0caa232946c5e7e1ULL, 0xd03cc744a2888ae4ULL, 0x00db18cb2c04b3edULL,
    0xfcf5e095d5d00af6ULL, 0xa09e30ed741d8ae4ULL, 0x08b3f481e3aaa0f1ULL};
static const u64 G2X0[NQ] = {
    0xd48056c8c121bdb8ULL, 0x0bac0326a805bbefULL, 0xb4510b647ae3d177ULL,
    0xc6e47ad4fa403b02ULL, 0x260805272dc51051ULL, 0x024aa2b2f08f0a91ULL};
static const u64 G2X1[NQ] = {
    0xe5ac7d055d042b7eULL, 0x334cf11213945d57ULL, 0xb5da61bbdc7f5049ULL,
    0x596bd0d09920b61aULL, 0x7dacd3a088274f65ULL, 0x13e02b6052719f60ULL};
static const u64 G2Y0[NQ] = {
    0xe193548608b82801ULL, 0x923ac9cc3baca289ULL, 0x6d429a695160d12cULL,
    0xadfd9baa8cbdd3a7ULL, 0x8cc9cdc6da2e351aULL, 0x0ce5d527727d6e11ULL};
static const u64 G2Y1[NQ] = {
    0xaaa9075ff05f79beULL, 0x3f370d275cec1da1ULL, 0x267492ab572e99abULL,
    0xcb3e287e85a763afULL, 0x32acd2b02bc28b99ULL, 0x0606c4a02ea734ccULL};

#define FB_WBITS 8
#define FB_WINDOWS 32 /* ceil(255/8) */
#define FB_TSIZE (1 << FB_WBITS)

/* affine Montgomery-form tables; entry 0 unused (infinity) */
static u64 (*fb1_x)[NQ] = NULL, (*fb1_y)[NQ] = NULL;
static fq2 *fb2_x = NULL, *fb2_y = NULL;
static uint8_t *fb1_inf = NULL, *fb2_inf = NULL;

static void build_fb1(void) {
  if (fb1_x) return;
  long total = (long)FB_WINDOWS * FB_TSIZE;
  g1p *jac = malloc(total * sizeof(g1p));
  g1p base, cur;
  fq_to_mont(G1X, base.x);
  fq_to_mont(G1Y, base.y);
  memcpy(base.z, Q_ONE, NQ * 8);
  for (int w = 0; w < FB_WINDOWS; w++) {
    g1_set_inf(&jac[w * FB_TSIZE]);
    cur = base;
    for (int d = 1; d < FB_TSIZE; d++) {
      g1_add(&jac[w * FB_TSIZE + d - 1], &cur, &jac[w * FB_TSIZE + d]);
    }
    for (int k = 0; k < FB_WBITS; k++) g1_dbl(&base, &base);
  }
  /* normalize to affine Montgomery for madd */
  fb1_x = malloc(total * sizeof(*fb1_x));
  fb1_y = malloc(total * sizeof(*fb1_y));
  fb1_inf = malloc(total);
  for (long i = 0; i < total; i++) {
    if (g1_is_inf(&jac[i])) {
      fb1_inf[i] = 1;
      continue;
    }
    fb1_inf[i] = 0;
    u64 zinv[NQ], zi2[NQ];
    fq_inv(jac[i].z, zinv);
    fq_sqr(zinv, zi2);
    fq_mul(jac[i].x, zi2, fb1_x[i]);
    fq_mul(jac[i].y, zi2, fb1_y[i]);
    fq_mul(fb1_y[i], zinv, fb1_y[i]);
  }
  free(jac);
}

static void build_fb2(void) {
  if (fb2_x) return;
  long total = (long)FB_WINDOWS * FB_TSIZE;
  g2p *jac = malloc(total * sizeof(g2p));
  g2p base, cur;
  fq_to_mont(G2X0, base.x.c0);
  fq_to_mont(G2X1, base.x.c1);
  fq_to_mont(G2Y0, base.y.c0);
  fq_to_mont(G2Y1, base.y.c1);
  memcpy(base.z.c0, Q_ONE, NQ * 8);
  memset(base.z.c1, 0, NQ * 8);
  for (int w = 0; w < FB_WINDOWS; w++) {
    g2_set_inf(&jac[w * FB_TSIZE]);
    cur = base;
    for (int d = 1; d < FB_TSIZE; d++) {
      g2_add(&jac[w * FB_TSIZE + d - 1], &cur, &jac[w * FB_TSIZE + d]);
    }
    for (int k = 0; k < FB_WBITS; k++) g2_dbl(&base, &base);
  }
  fb2_x = malloc(total * sizeof(fq2));
  fb2_y = malloc(total * sizeof(fq2));
  fb2_inf = malloc(total);
  for (long i = 0; i < total; i++) {
    if (g2_is_inf(&jac[i])) {
      fb2_inf[i] = 1;
      continue;
    }
    fb2_inf[i] = 0;
    fq2 zinv, zi2;
    f2_inv(&jac[i].z, &zinv);
    f2_sqr(&zinv, &zi2);
    f2_mul(&jac[i].x, &zi2, &fb2_x[i]);
    f2_mul(&jac[i].y, &zi2, &fb2_y[i]);
    f2_mul(&fb2_y[i], &zinv, &fb2_y[i]);
  }
  free(jac);
}

/* scalars: (n,4) u64 standard form.  out: affine standard + inf flags. */
void g1_fixed_base_batch(const u64 *scalars, long n, u64 *xs, u64 *ys,
                         uint8_t *inf) {
  g16_init();
  build_fb1();
  g1p *acc = malloc(n * sizeof(g1p));
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    const u64 *s = scalars + i * NR;
    g1p a;
    g1_set_inf(&a);
    for (int w = 0; w < FB_WINDOWS; w++) {
      int bit = w * FB_WBITS;
      int limb = bit >> 6, off = bit & 63;
      u64 d = s[limb] >> off;
      if (off > 64 - FB_WBITS && limb + 1 < NR)
        d |= s[limb + 1] << (64 - off);
      d &= FB_TSIZE - 1;
      if (d && !fb1_inf[w * FB_TSIZE + d])
        g1_madd(&a, fb1_x[w * FB_TSIZE + d], fb1_y[w * FB_TSIZE + d], &a);
    }
    acc[i] = a;
  }
  g1_normalize_batch(acc, n, xs, ys, inf);
  free(acc);
}

void g2_fixed_base_batch(const u64 *scalars, long n, u64 *xs, u64 *ys,
                         uint8_t *inf) {
  g16_init();
  build_fb2();
  g2p *acc = malloc(n * sizeof(g2p));
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    const u64 *s = scalars + i * NR;
    g2p a;
    g2_set_inf(&a);
    for (int w = 0; w < FB_WINDOWS; w++) {
      int bit = w * FB_WBITS;
      int limb = bit >> 6, off = bit & 63;
      u64 d = s[limb] >> off;
      if (off > 64 - FB_WBITS && limb + 1 < NR)
        d |= s[limb + 1] << (64 - off);
      d &= FB_TSIZE - 1;
      if (d && !fb2_inf[w * FB_TSIZE + d])
        g2_madd(&a, &fb2_x[w * FB_TSIZE + d], &fb2_y[w * FB_TSIZE + d], &a);
    }
    acc[i] = a;
  }
  g2_normalize_batch(acc, n, xs, ys, inf);
  free(acc);
}

/* ------------------------------------------------------------ MSM ------ */

static int msm_window_bits(long n) {
  if (n < 32) return 3;
  int c = 0;
  long t = n;
  while (t > 1) {
    t >>= 1;
    c++;
  } /* log2(n) */
  c -= 3;
  if (c < 3) c = 3;
  if (c > 16) c = 16;
  return c;
}

/* Effective window count from the widest live scalar.  Wire-value MSMs
 * are mostly bits: every add lands in window 0, and a window-parallel
 * loop serializes the whole MSM onto one thread.  Callers split the
 * point axis into chunks when nw_eff is small (the bucket-weighted sum
 * is linear in bucket partitions, so each (window, chunk) task can
 * suffix-sum independently).  +1 absorbs the signed-digit carry. */
static int msm_eff_windows(const u64 *scalars, const uint8_t *inf, long n,
                           int c, int nw) {
  int maxbits = 0;
  for (long i = 0; i < n; i++) {
    if (inf && inf[i]) continue;
    const u64 *s = scalars + i * NR;
    for (int limb = NR - 1; limb >= 0; limb--)
      if (s[limb]) {
        int b = limb * 64 + 64 - __builtin_clzll(s[limb]);
        if (b > maxbits) maxbits = b;
        break;
      }
  }
  int ne = maxbits ? (maxbits + c - 1) / c + 1 : 1;
  return ne < nw ? ne : nw;
}

/* Signed-digit recoding: digit w of scalar i in [-2^(c-1), 2^(c-1)],
 * scalar = sum_w d_w 2^(cw).  nw includes one extra carry window, so the
 * final carry is always absorbed (top digit <= 1). */
static void msm_recode(const u64 *scalars, long n, int c, int nw,
                       int16_t *dig) {
  const u64 mask = (1ULL << c) - 1;
  const long half = 1L << (c - 1);
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    const u64 *s = scalars + i * NR;
    long carry = 0;
    for (int w = 0; w < nw; w++) {
      long bit = (long)w * c;
      u64 raw = 0;
      int limb = (int)(bit >> 6), off = (int)(bit & 63);
      if (limb < NR) {
        raw = s[limb] >> off;
        if (off + c > 64 && limb + 1 < NR) raw |= s[limb + 1] << (64 - off);
        raw &= mask;
      }
      long d = (long)raw + carry;
      /* carry on d >= half so digits lie in [-half, half-1]: +half must
       * never be emitted — at c=16 (MSMs over >= 2^20 points, e.g. the
       * schoolbook-1024 h_query) +32768 wraps int16_t to -32768 with
       * carry 0, silently corrupting ~n*nw/2^16 scalars per MSM. */
      if (d >= half) {
        d -= 1L << c;
        carry = 1;
      } else {
        carry = 0;
      }
      dig[i * nw + w] = (int16_t)d;
    }
  }
}

/* Batched Montgomery inversion of m nonzero Montgomery values, in place. */
#define ABATCH 192
static void fq_batch_inv(u64 (*a)[NQ], int m) {
  u64 pref[ABATCH + 1][NQ];
  memcpy(pref[0], Q_ONE, NQ * 8);
  for (int k = 0; k < m; k++) fq_mul(pref[k], a[k], pref[k + 1]);
  u64 inv_all[NQ], t[NQ];
  fq_inv_fast(pref[m], inv_all);
  for (int k = m - 1; k >= 0; k--) {
    fq_mul(pref[k], inv_all, t);
    fq_mul(inv_all, a[k], inv_all);
    memcpy(a[k], t, NQ * 8);
  }
}

/* Affine bucket for the batch-affine accumulation pass. */
typedef struct {
  u64 x[NQ], y[NQ];
  uint8_t set;
} g1aff;

/* One batch-affine addition with a precomputed lambda:
 * (x3, y3) = bucket + (px, py),  lam = (py - by) / (px - bx);
 * py enters only through lam. */
static void g1_aff_apply(g1aff *b, const u64 *px, const u64 *lam) {
  u64 x3[NQ], y3[NQ], t[NQ];
  fq_sqr(lam, x3);
  fq_sub(x3, b->x, x3);
  fq_sub(x3, px, x3);
  fq_sub(b->x, x3, t);
  fq_mul(lam, t, y3);
  fq_sub(y3, b->y, y3);
  memcpy(b->x, x3, NQ * 8);
  memcpy(b->y, y3, NQ * 8);
}

/* Slow path (x-collision: doubling or cancellation); single inversion. */
static void g1_aff_add_slow(g1aff *b, const u64 *px, const u64 *py) {
  u64 dx[NQ];
  fq_sub(px, b->x, dx);
  if (is_zero_n(dx, NQ)) {
    u64 sy[NQ];
    fq_sub(py, b->y, sy);
    if (!is_zero_n(sy, NQ)) { /* P + (-P) */
      b->set = 0;
      return;
    }
    u64 lam[NQ], num[NQ], den[NQ];
    fq_sqr(b->x, num); /* 3x^2 / 2y */
    fq_dbl(num, lam);
    fq_add(lam, num, num);
    fq_dbl(b->y, den);
    fq_inv_fast(den, den);
    fq_mul(num, den, lam);
    g1_aff_apply(b, px, lam);
    return;
  }
  u64 lam[NQ];
  fq_inv_fast(dx, dx);
  fq_sub(py, b->y, lam);
  fq_mul(lam, dx, lam);
  g1_aff_apply(b, px, lam);
}

#ifdef HAVE_IFMA52
/* ---- IFMA MSM tier: buckets live in the 52-bit Montgomery domain ----
 *
 * The batch-affine flush is the mul-bound heart of the MSM; here it
 * runs 8 bucket-additions per instruction bundle.  Buckets and a
 * per-call copy of the points are kept in Mont52 the whole time, so
 * the flush does no radix conversions; only the rare paths (x-collision
 * slow adds, final bucket suffix) shift domains via one scalar mul.
 *
 * Domain shifts (radix64 Montgomery x*2^384 <-> radix52 x*2^416):
 *   to 52:  fq_mul(v, 2^416 mod q) then relimb   (fq_64to52m)
 *   to 64:  relimb then fq_mul(v, 2^352 mod q)   (fq_52mto64)
 */
typedef struct {
  u64 x[NQ52], y[NQ52];
  uint8_t set;
} g1aff52;

static void fq_64to52m(const u64 *v64, u64 *o52) {
  u64 t[NQ];
  fq_mul(v64, FQ_W416, t);
  limbs64_to_52(t, NQ, o52, NQ52);
}
static void fq_52mto64(const u64 *v52, u64 *o64) {
  u64 t[NQ];
  limbs52_to_64(v52, NQ52, t, NQ);
  fq_mul(t, FQ_W352, o64);
}
static void neg52(const u64 *y, u64 *o) { /* q - y canonical; 0 -> 0 */
  int z = 1;
  for (int j = 0; j < NQ52; j++) z &= y[j] == 0;
  if (z) {
    memset(o, 0, NQ52 * 8);
    return;
  }
  u64 bor = 0;
  for (int j = 0; j < NQ52; j++) {
    u64 d = FQ_MOD52[j] - y[j] - bor;
    bor = d >> 63;
    o[j] = d & MASK52;
  }
}

#define FG (ABATCH / 8)
typedef struct {
  u64 vdx[FG][NQ52][8], vpref[FG + 1][NQ52][8], vinvg[FG][NQ52][8];
  u64 vpx[FG][NQ52][8], vpy[FG][NQ52][8];
  u64 vbx[FG][NQ52][8], vby[FG][NQ52][8];
} flushbuf;

/* One batched flush: m queued (bucket, point, sign) bucket-additions.
 * Every bucket appears at most once (the pend[] guarantee), so lanes
 * are independent.  x-collisions are detected as dx == 0, excluded
 * from the vector pipeline, and replayed through the scalar slow add. */
static void ifma_flush(g1aff52 *buckets, int m, const long *sb,
                       const long *si, const int8_t *ssgn,
                       const u64 (*px52)[NQ52], const u64 (*py52)[NQ52],
                       const u64 (*mx)[NQ], const u64 (*my)[NQ],
                       flushbuf *fb) {
  int ngrp = (m + 7) / 8;
  int nslow = 0;
  int slowk[ABATCH];
  uint8_t skip[FG] = {0};
  const __m512i vzero = _mm512_setzero_si512();
  /* ---- stage points/buckets into SoA groups, compute dx (pointer-fed
   * transposes: rows load straight from point/bucket storage) ---- */
  static const u64 Z52ROW[NQ52] = {0};
  for (int g = 0; g < ngrp; g++) {
    const u64 *rx[8], *ry[8], *bx[8], *by[8];
    for (int l = 0; l < 8; l++) {
      int k = g * 8 + l;
      if (k < m) {
        rx[l] = px52[si[k]];
        ry[l] = py52[si[k]];
        bx[l] = buckets[sb[k]].x;
        by[l] = buckets[sb[k]].y;
      } else { /* pad lane: dx = 1 - 0, never zero, result discarded */
        rx[l] = FQ_ONE52V;
        ry[l] = FQ_ONE52V;
        bx[l] = Z52ROW;
        by[l] = Z52ROW;
        skip[g] |= (uint8_t)(1u << l);
      }
    }
    transpose8x8p(rx, fb->vpx[g]);
    transpose8x8p(ry, fb->vpy[g]);
    transpose8x8p(bx, fb->vbx[g]);
    transpose8x8p(by, fb->vby[g]);
    vFQ_sub(fb->vpx[g], fb->vbx[g], fb->vdx[g]);
    __mmask8 zm = 0xff;
    for (int j = 0; j < NQ52; j++)
      zm &= _mm512_cmpeq_epi64_mask(_mm512_loadu_si512(fb->vdx[g][j]), vzero);
    if (zm) { /* x-collision lanes: pull out, patch dx to 1 */
      for (int l = 0; l < 8; l++)
        if (zm & (1u << l)) {
          int k = g * 8 + l;
          if (k < m) slowk[nslow++] = k;
          for (int j = 0; j < NQ52; j++) fb->vdx[g][j][l] = FQ_ONE52V[j];
          skip[g] |= (uint8_t)(1u << l);
        }
    }
  }
  /* ---- batched inversion: vector prefix, scalar lane-combine ---- */
  memcpy(fb->vpref[0], FQ_ONE52M, sizeof(FQ_ONE52M));
  for (int g = 0; g < ngrp; g++)
    vFQ_mul(fb->vpref[g], fb->vdx[g], fb->vpref[g + 1]);
  u64 lane64[8][NQ], spref[9][NQ], invall[NQ], laneinv[8][NQ];
  for (int l = 0; l < 8; l++) {
    u64 row[NQ52];
    for (int j = 0; j < NQ52; j++) row[j] = fb->vpref[ngrp][j][l];
    fq_52mto64(row, lane64[l]);
  }
  memcpy(spref[0], Q_ONE, NQ * 8);
  for (int l = 0; l < 8; l++) fq_mul(spref[l], lane64[l], spref[l + 1]);
  fq_inv_fast(spref[8], invall);
  for (int l = 7; l >= 0; l--) {
    fq_mul(spref[l], invall, laneinv[l]);
    fq_mul(invall, lane64[l], invall);
  }
  u64 vinv[NQ52][8];
  for (int l = 0; l < 8; l++) {
    u64 row[NQ52];
    fq_64to52m(laneinv[l], row);
    for (int j = 0; j < NQ52; j++) vinv[j][l] = row[j];
  }
  /* ---- walk back: per-group inverses first (sequential chain) ---- */
  for (int g = ngrp - 1; g >= 0; g--) {
    vFQ_mul(fb->vpref[g], vinv, fb->vinvg[g]);
    vFQ_mul(vinv, fb->vdx[g], vinv);
  }
  /* ---- lambda + apply: independent across groups.  (Splitting this
   * from the sequential inverse walk measured NEUTRAL — the OoO core
   * already pipelined the interleaved form — but it keeps the serial
   * chain explicit and the apply loop forward-ordered.) ---- */
  for (int g = 0; g < ngrp; g++) {
    u64 nump[NQ52][8], numn[NQ52][8], num[NQ52][8];
    u64 t[NQ52][8], lam[NQ52][8], x3[NQ52][8], y3[NQ52][8];
    static const u64 Z52[NQ52][8]; /* zero block */
    vFQ_sub(fb->vpy[g], fb->vby[g], nump);
    vFQ_add(fb->vpy[g], fb->vby[g], t);
    vFQ_sub(Z52, t, numn);
    __mmask8 neg = 0;
    for (int l = 0; l < 8; l++) {
      int k = g * 8 + l;
      if (k < m && ssgn[k] < 0) neg |= (__mmask8)(1u << l);
    }
    for (int j = 0; j < NQ52; j++) {
      __m512i r = _mm512_mask_blend_epi64(neg, _mm512_loadu_si512(nump[j]),
                                          _mm512_loadu_si512(numn[j]));
      _mm512_storeu_si512(num[j], r);
    }
    vFQ_mul(num, fb->vinvg[g], lam);
    vFQ_mul(lam, lam, x3);
    vFQ_sub(x3, fb->vbx[g], x3);
    vFQ_sub(x3, fb->vpx[g], x3);
    vFQ_sub(fb->vbx[g], x3, t);
    vFQ_mul(lam, t, t);
    vFQ_sub(t, fb->vby[g], y3);
    u64 scratchx[NQ52], scratchy[NQ52];
    u64 *ox[8], *oy[8];
    for (int l = 0; l < 8; l++) {
      if (skip[g] & (1u << l)) {
        ox[l] = scratchx;
        oy[l] = scratchy;
      } else {
        int k = g * 8 + l;
        ox[l] = buckets[sb[k]].x;
        oy[l] = buckets[sb[k]].y;
      }
    }
    transpose8x8sp(x3, ox);
    transpose8x8sp(y3, oy);
  }
  /* ---- replay x-collision lanes through the scalar slow add ---- */
  for (int s = 0; s < nslow; s++) {
    int k = slowk[s];
    g1aff tmp;
    fq_52mto64(buckets[sb[k]].x, tmp.x);
    fq_52mto64(buckets[sb[k]].y, tmp.y);
    tmp.set = 1;
    u64 py[NQ];
    memcpy(py, my[si[k]], NQ * 8);
    if (ssgn[k] < 0) {
      u64 ny[NQ];
      memcpy(ny, Q, NQ * 8);
      sub_n(ny, py, NQ);
      memcpy(py, ny, NQ * 8);
    }
    g1_aff_add_slow(&tmp, mx[si[k]], py);
    buckets[sb[k]].set = tmp.set;
    if (tmp.set) {
      fq_64to52m(tmp.x, buckets[sb[k]].x);
      fq_64to52m(tmp.y, buckets[sb[k]].y);
    } else {
      memset(buckets[sb[k]].x, 0, NQ52 * 8);
      memset(buckets[sb[k]].y, 0, NQ52 * 8);
    }
  }
}

static double g16_prof_flush, g16_prof_queue, g16_prof_suffix;
static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

/* ---- 8-lane Jacobian arithmetic for the bucket suffix reduction ----
 *
 * The suffix (running += B_b; acc += running, b descending) is a
 * sequential chain of ~2*half group ops per window.  Splitting the
 * bucket range into 8 contiguous segments gives 8 independent chains —
 * one per SIMD lane — and the per-window result is reassembled from
 * lane totals: true_suffix(b in seg l) = local_suffix(b) + T_l with
 * T_l = sum of higher segments' totals, so
 * wsum = sum_l acc_l + seglen * T_l (seglen = 2^k doublings).
 *
 * Exceptional lanes (same-x adds, cryptographically rare but required
 * for bit-exactness) are detected by canonical limb equality and fixed
 * up through the scalar 64-domain path. */
typedef struct {
  u64 x[NQ52][8], y[NQ52][8], z[NQ52][8];
  __mmask8 inf;
} vjac;

static void vjac_lane_to_g1p(const vjac *p, int l, g1p *o) {
  if (p->inf & (1u << l)) {
    g1_set_inf(o);
    return;
  }
  u64 row[NQ52];
  for (int j = 0; j < NQ52; j++) row[j] = p->x[j][l];
  fq_52mto64(row, o->x);
  for (int j = 0; j < NQ52; j++) row[j] = p->y[j][l];
  fq_52mto64(row, o->y);
  for (int j = 0; j < NQ52; j++) row[j] = p->z[j][l];
  fq_52mto64(row, o->z);
}

static void g1p_to_vjac_lane(const g1p *src, vjac *p, int l) {
  if (g1_is_inf(src)) {
    p->inf |= (__mmask8)(1u << l);
    return;
  }
  p->inf &= (__mmask8)~(1u << l);
  u64 row[NQ52];
  fq_64to52m(src->x, row);
  for (int j = 0; j < NQ52; j++) p->x[j][l] = row[j];
  fq_64to52m(src->y, row);
  for (int j = 0; j < NQ52; j++) p->y[j][l] = row[j];
  fq_64to52m(src->z, row);
  for (int j = 0; j < NQ52; j++) p->z[j][l] = row[j];
}

static void vblend(__mmask8 m, const u64 a[NQ52][8], u64 o[NQ52][8]) {
  /* o = m ? a : o, per lane */
  for (int j = 0; j < NQ52; j++) {
    __m512i r = _mm512_mask_blend_epi64(m, _mm512_loadu_si512(o[j]),
                                        _mm512_loadu_si512(a[j]));
    _mm512_storeu_si512(o[j], r);
  }
}

static __mmask8 vzero_mask(const u64 a[NQ52][8]) {
  __mmask8 zm = 0xff;
  const __m512i z = _mm512_setzero_si512();
  for (int j = 0; j < NQ52; j++)
    zm &= _mm512_cmpeq_epi64_mask(_mm512_loadu_si512(a[j]), z);
  return zm;
}

/* p += (bx, by) mixed add (madd-2007-bl), lanes masked by binf/p->inf;
 * returns the lane mask that needs the scalar fixup (same-x, both live). */
static __mmask8 vjac_madd(vjac *p, const u64 bx[NQ52][8],
                          const u64 by[NQ52][8], __mmask8 blive) {
  u64 z1z1[NQ52][8], u2[NQ52][8], s2[NQ52][8], hh[NQ52][8], ii[NQ52][8];
  u64 jj[NQ52][8], rr[NQ52][8], vv[NQ52][8], t[NQ52][8];
  u64 x3[NQ52][8], y3[NQ52][8], z3[NQ52][8];
  vFQ_mul(p->z, p->z, z1z1);
  vFQ_mul(bx, z1z1, u2);
  vFQ_mul(by, p->z, s2);
  vFQ_mul(s2, z1z1, s2);
  u64 h[NQ52][8];
  vFQ_sub(u2, p->x, h);
  __mmask8 live = blive & (__mmask8)~p->inf;
  __mmask8 excep = vzero_mask(h) & live;
  vFQ_mul(h, h, hh);
  vFQ_add(hh, hh, ii);
  vFQ_add(ii, ii, ii); /* I = 4 HH */
  vFQ_mul(h, ii, jj);
  vFQ_sub(s2, p->y, rr);
  vFQ_add(rr, rr, rr);
  vFQ_mul(p->x, ii, vv);
  vFQ_mul(rr, rr, x3);
  vFQ_sub(x3, jj, x3);
  vFQ_sub(x3, vv, x3);
  vFQ_sub(x3, vv, x3);
  vFQ_sub(vv, x3, t);
  vFQ_mul(rr, t, y3);
  vFQ_mul(p->y, jj, t);
  vFQ_sub(y3, t, y3);
  vFQ_sub(y3, t, y3);
  vFQ_add(p->z, h, z3);
  vFQ_mul(z3, z3, z3);
  vFQ_sub(z3, z1z1, z3);
  vFQ_sub(z3, hh, z3);
  /* computed lanes: live & !excep */
  __mmask8 use = live & (__mmask8)~excep;
  vblend(use, x3, p->x);
  vblend(use, y3, p->y);
  vblend(use, z3, p->z);
  /* p was infinity, b live: promote b (z = Mont52 one) */
  __mmask8 promote = p->inf & blive;
  vblend(promote, bx, p->x);
  vblend(promote, by, p->y);
  vblend(promote, FQ_ONE52M, p->z);
  p->inf &= (__mmask8)~blive;
  return excep;
}

/* p += q full Jacobian add (add-2007-bl); returns scalar-fixup lanes. */
static __mmask8 vjac_add(vjac *p, const vjac *q) {
  u64 z1z1[NQ52][8], z2z2[NQ52][8], u1[NQ52][8], u2[NQ52][8];
  u64 s1[NQ52][8], s2[NQ52][8], h[NQ52][8], ii[NQ52][8], jj[NQ52][8];
  u64 rr[NQ52][8], vv[NQ52][8], t[NQ52][8];
  u64 x3[NQ52][8], y3[NQ52][8], z3[NQ52][8];
  vFQ_mul(p->z, p->z, z1z1);
  vFQ_mul(q->z, q->z, z2z2);
  vFQ_mul(p->x, z2z2, u1);
  vFQ_mul(q->x, z1z1, u2);
  vFQ_mul(p->y, q->z, s1);
  vFQ_mul(s1, z2z2, s1);
  vFQ_mul(q->y, p->z, s2);
  vFQ_mul(s2, z1z1, s2);
  vFQ_sub(u2, u1, h);
  __mmask8 live = (__mmask8)~(p->inf | q->inf);
  __mmask8 excep = vzero_mask(h) & live;
  vFQ_add(h, h, t); /* 2H */
  vFQ_mul(t, t, ii);
  vFQ_mul(h, ii, jj);
  vFQ_sub(s2, s1, rr);
  vFQ_add(rr, rr, rr);
  vFQ_mul(u1, ii, vv);
  vFQ_mul(rr, rr, x3);
  vFQ_sub(x3, jj, x3);
  vFQ_sub(x3, vv, x3);
  vFQ_sub(x3, vv, x3);
  vFQ_sub(vv, x3, t);
  vFQ_mul(rr, t, y3);
  vFQ_mul(s1, jj, t);
  vFQ_sub(y3, t, y3);
  vFQ_sub(y3, t, y3);
  vFQ_add(p->z, q->z, z3);
  vFQ_mul(z3, z3, z3);
  vFQ_sub(z3, z1z1, z3);
  vFQ_sub(z3, z2z2, z3);
  vFQ_mul(z3, h, z3);
  __mmask8 use = live & (__mmask8)~excep;
  vblend(use, x3, p->x);
  vblend(use, y3, p->y);
  vblend(use, z3, p->z);
  /* p inf, q live: copy q */
  __mmask8 promote = p->inf & (__mmask8)~q->inf;
  vblend(promote, q->x, p->x);
  vblend(promote, q->y, p->y);
  vblend(promote, q->z, p->z);
  p->inf &= q->inf;
  return excep;
}

/* scalar fixups: redo the masked lanes through the 64-domain path */
static void vjac_fix_madd(vjac *p, __mmask8 excep, const g1aff52 *bk8[8]) {
  for (int l = 0; l < 8; l++) {
    if (!(excep & (1u << l))) continue;
    g1p pl;
    vjac_lane_to_g1p(p, l, &pl);
    u64 bx[NQ], by[NQ];
    fq_52mto64(bk8[l]->x, bx);
    fq_52mto64(bk8[l]->y, by);
    g1_madd(&pl, bx, by, &pl);
    g1p_to_vjac_lane(&pl, p, l);
  }
}

static void vjac_fix_add(vjac *p, __mmask8 excep, const vjac *q_before) {
  for (int l = 0; l < 8; l++) {
    if (!(excep & (1u << l))) continue;
    g1p pl, ql;
    vjac_lane_to_g1p(p, l, &pl);
    vjac_lane_to_g1p(q_before, l, &ql);
    g1_add(&pl, &ql, &pl);
    g1p_to_vjac_lane(&pl, p, l);
  }
}

/* K-proof batched MSM core: K scalar vectors over ONE shared point set
 * (the Groth16 batch-prove shape — every proof reuses the same CRS query
 * points, so the Mont52 point conversion is paid once and the task grid
 * K x windows x chunks keeps all cores busy even for narrow wire-value
 * scalars).  Realizes the batch intent of
 * falcon-aggregate-sig/src/main.rs:1-3. */
static void g1_msm_core_ifma_multi(const u64 (*mx)[NQ], const u64 (*my)[NQ],
                                   const uint8_t *inf, const u64 *scalars,
                                   long n, int K, g1p *outs) {
  const int prof = getenv("G16_MSM_PROF") != NULL;
  double t_start = prof ? now_s() : 0;
  int c = msm_window_bits(n);
  int nw = (255 + c - 1) / c + 1;
  long half = 1L << (c - 1);
  /* recode only the live windows (bit scalars: 2 instead of 21);
   * nw_eff = max over the K vectors so the digit buffer is uniform */
  int nw_eff = 1;
  for (int k = 0; k < K; k++) {
    int ne = msm_eff_windows(scalars + (size_t)k * n * NR, inf, n, c, nw);
    if (ne > nw_eff) nw_eff = ne;
  }
  int16_t *dig = malloc((size_t)K * n * nw_eff * sizeof(int16_t));
  for (int k = 0; k < K; k++)
    msm_recode(scalars + (size_t)k * n * NR, n, c, nw_eff,
               dig + (size_t)k * n * nw_eff);
  double t_recode = prof ? now_s() : 0;
  u64(*px52)[NQ52] = malloc((size_t)n * sizeof(*px52));
  u64(*py52)[NQ52] = malloc((size_t)n * sizeof(*py52));
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    if (inf[i]) continue;
    fq_64to52m(mx[i], px52[i]);
    fq_64to52m(my[i], py52[i]);
  }
  double t_conv = prof ? now_s() : 0;
  if (prof) g16_prof_flush = g16_prof_queue = g16_prof_suffix = 0;
  int nchunks = (K * nw_eff) >= 8 ? 1 : (8 + nw_eff - 1) / nw_eff;
  long chunk_n = (n + nchunks - 1) / nchunks;
  int ntasks = K * nw_eff * nchunks;
  g1p *tsums = malloc(ntasks * sizeof(g1p));
#pragma omp parallel for schedule(dynamic)
  for (int t = 0; t < ntasks; t++) {
    int k = t / (nw_eff * nchunks);
    int rem = t % (nw_eff * nchunks);
    int w = rem / nchunks;
    const int16_t *kdig = dig + (size_t)k * n * nw_eff;
    long ti0 = (long)(rem % nchunks) * chunk_n;
    long ti1 = ti0 + chunk_n < n ? ti0 + chunk_n : n;
    double tq = 0, tf = 0, tsx = 0, t0 = 0;
    g1aff52 *buckets = calloc(half + 1, sizeof(g1aff52));
    g1p *jbuck = calloc(half + 1, sizeof(g1p));
    uint8_t *pend = calloc(half + 1, 1);
    flushbuf *fb = malloc(sizeof(flushbuf));
    long sb[ABATCH], si[ABATCH];
    int8_t ssgn[ABATCH];
    int m = 0;
    if (prof) t0 = now_s();
    for (long i = ti0; i < ti1; i++) {
      if (inf[i]) continue;
      int d = kdig[i * nw_eff + w];
      if (!d) continue;
      long b = d > 0 ? d : -(long)d;
      g1aff52 *bk = &buckets[b];
      if (pend[b]) { /* conflict this batch: Jacobian overflow (64-dom) */
        u64 ny[NQ];
        const u64 *py = my[i];
        if (d < 0) {
          memcpy(ny, Q, NQ * 8);
          sub_n(ny, my[i], NQ);
          py = ny;
        }
        g1_madd(&jbuck[b], mx[i], py, &jbuck[b]);
        continue;
      }
      if (!bk->set) {
        memcpy(bk->x, px52[i], NQ52 * 8);
        if (d > 0) {
          memcpy(bk->y, py52[i], NQ52 * 8);
        } else {
          neg52(py52[i], bk->y);
        }
        /* a free write completes synchronously: the bucket may queue a
         * batched add later in this same batch, so do NOT set pend —
         * doing so deadlocked the affine pipeline for uniform scalars
         * (all 2^(c-1) flags latched after the fill sweep, m never
         * reached ABATCH, and every add fell to the Jacobian path) */
        bk->set = 1;
        continue;
      }
      sb[m] = b;
      si[m] = i;
      ssgn[m] = d > 0 ? 1 : -1;
      pend[b] = 1;
      m++;
      if (m == ABATCH) {
        if (prof) {
          tq += now_s() - t0;
          t0 = now_s();
        }
        ifma_flush(buckets, m, sb, si, ssgn,
                   (const u64(*)[NQ52])px52, (const u64(*)[NQ52])py52, mx, my,
                   fb);
        m = 0;
        memset(pend, 0, half + 1);
        if (prof) {
          tf += now_s() - t0;
          t0 = now_s();
        }
      }
    }
    if (m)
      ifma_flush(buckets, m, sb, si, ssgn, (const u64(*)[NQ52])px52,
                 (const u64(*)[NQ52])py52, mx, my, fb);
    if (prof) {
      tq += now_s() - t0;
      t0 = now_s();
    }
    g1p acc;
    if (half >= 8) {
      /* convert the nonempty Jacobian overflow accumulators to the
       * 52-domain once (uniform windows have THOUSANDS of them — an
       * eGCD-per-merge pre-merge cost 33 ms/window); the vector loop
       * folds them in as a masked third op per step */
      u64(*j52x)[NQ52] = NULL, (*j52y)[NQ52] = NULL, (*j52z)[NQ52] = NULL;
      uint8_t *jlive = calloc(half + 1, 1);
      long nj = 0;
      for (long b = 1; b <= half; b++)
        if (!g1_is_inf(&jbuck[b])) {
          jlive[b] = 1;
          nj++;
        }
      static const u64 Z52R[NQ52] = {0};
      if (nj) {
        j52x = malloc((size_t)(half + 1) * sizeof(*j52x));
        j52y = malloc((size_t)(half + 1) * sizeof(*j52y));
        j52z = malloc((size_t)(half + 1) * sizeof(*j52z));
        for (long b = 1; b <= half; b++) {
          if (!jlive[b]) continue;
          fq_64to52m(jbuck[b].x, j52x[b]);
          fq_64to52m(jbuck[b].y, j52y[b]);
          fq_64to52m(jbuck[b].z, j52z[b]);
        }
      }
      long seglen = half >> 3;
      vjac running, vacc;
      running.inf = vacc.inf = 0xff;
      for (long s = seglen - 1; s >= 0; s--) {
        const u64 *bx8[8], *by8[8];
        const g1aff52 *bk8[8];
        __mmask8 blive = 0;
        u64 gbx[NQ52][8], gby[NQ52][8];
        for (int l = 0; l < 8; l++) {
          long b = (long)l * seglen + 1 + s;
          bk8[l] = &buckets[b];
          bx8[l] = buckets[b].x;
          by8[l] = buckets[b].y;
          if (buckets[b].set) blive |= (__mmask8)(1u << l);
        }
        transpose8x8p(bx8, gbx);
        transpose8x8p(by8, gby);
        __mmask8 e1 = vjac_madd(&running, gbx, gby, blive);
        if (e1) vjac_fix_madd(&running, e1, bk8);
        if (nj) { /* fold this step's jbuck lanes */
          vjac qj;
          qj.inf = 0xff;
          const u64 *jx8[8], *jy8[8], *jz8[8];
          int any = 0;
          for (int l = 0; l < 8; l++) {
            long b = (long)l * seglen + 1 + s;
            if (jlive[b]) {
              qj.inf &= (__mmask8)~(1u << l);
              jx8[l] = j52x[b];
              jy8[l] = j52y[b];
              jz8[l] = j52z[b];
              any = 1;
            } else {
              jx8[l] = jy8[l] = jz8[l] = Z52R;
            }
          }
          if (any) {
            transpose8x8p(jx8, qj.x);
            transpose8x8p(jy8, qj.y);
            transpose8x8p(jz8, qj.z);
            __mmask8 ej = vjac_add(&running, &qj);
            if (ej) vjac_fix_add(&running, ej, &qj);
          }
        }
        __mmask8 e2 = vjac_add(&vacc, &running);
        if (e2) vjac_fix_add(&vacc, e2, &running);
      }
      free(jlive);
      free(j52x);
      free(j52y);
      free(j52z);
      /* stitch lanes: wsum = sum_l (acc_l + seglen * T_l),
       * T_l = sum of higher lanes' totals */
      int logseg = 63 - __builtin_clzl(seglen);
      g1p T, wsum;
      g1_set_inf(&T);
      g1_set_inf(&wsum);
      for (int l = 7; l >= 0; l--) {
        g1p al, rl, scaled;
        vjac_lane_to_g1p(&vacc, l, &al);
        vjac_lane_to_g1p(&running, l, &rl);
        scaled = T;
        for (int k = 0; k < logseg; k++) g1_dbl(&scaled, &scaled);
        g1_add(&wsum, &al, &wsum);
        g1_add(&wsum, &scaled, &wsum);
        g1_add(&T, &rl, &T);
      }
      acc = wsum;
    } else {
      g1p running;
      g1_set_inf(&running);
      g1_set_inf(&acc);
      for (long b = half; b >= 1; b--) {
        if (buckets[b].set) {
          u64 bx[NQ], by[NQ];
          fq_52mto64(buckets[b].x, bx);
          fq_52mto64(buckets[b].y, by);
          g1_madd(&running, bx, by, &running);
        }
        if (!g1_is_inf(&jbuck[b])) g1_add(&running, &jbuck[b], &running);
        g1_add(&acc, &running, &acc);
      }
    }
    tsums[t] = acc;
    if (prof) {
      tsx = now_s() - t0;
#pragma omp critical
      {
        g16_prof_queue += tq;
        g16_prof_flush += tf;
        g16_prof_suffix += tsx;
      }
    }
    free(buckets);
    free(jbuck);
    free(pend);
    free(fb);
  }
  if (prof)
    fprintf(stderr,
            "[msm-prof n=%ld K=%d c=%d nw_eff=%d nchunks=%d] recode %.3fs "
            "conv %.3fs | thread-sums: queue %.3fs flush %.3fs suffix %.3fs\n",
            n, K, c, nw_eff, nchunks, t_recode - t_start, t_conv - t_recode,
            g16_prof_queue, g16_prof_flush, g16_prof_suffix);
  /* fold chunk partials per window, then Horner from the top live one */
#pragma omp parallel for schedule(static)
  for (int k = 0; k < K; k++) {
    g1p total;
    g1_set_inf(&total);
    for (int w = nw_eff - 1; w >= 0; w--) {
      if (w != nw_eff - 1)
        for (int d = 0; d < c; d++) g1_dbl(&total, &total);
      for (int ch = 0; ch < nchunks; ch++)
        g1_add(&total, &tsums[((size_t)k * nw_eff + w) * nchunks + ch],
               &total);
    }
    outs[k] = total;
  }
  free(tsums);
  free(dig);
  free(px52);
  free(py52);
}

static void g1_msm_core_ifma(const u64 (*mx)[NQ], const u64 (*my)[NQ],
                             const uint8_t *inf, const u64 *scalars, long n,
                             g1p *out) {
  g1_msm_core_ifma_multi(mx, my, inf, scalars, n, 1, out);
}
#endif /* HAVE_IFMA52 */

/* Core MSM over Montgomery-form affine points: signed-digit Pippenger
 * with batch-affine bucket accumulation — one shared inversion per
 * ~ABATCH independent bucket additions.  A bucket with an addition
 * already pending in the current batch absorbs further hits through a
 * Jacobian overflow accumulator instead (so heavily repeated scalars —
 * the wire-value MSMs are mostly bits — cost one mixed add each, never
 * a deferral loop; random full-width scalars almost never conflict). */
static void g1_msm_core_multi(const u64 (*mx)[NQ], const u64 (*my)[NQ],
                              const uint8_t *inf, const u64 *scalars, long n,
                              int K, g1p *outs) {
#ifdef HAVE_IFMA52
  if (!getenv("G16_NO_IFMA")) {
    g1_msm_core_ifma_multi(mx, my, inf, scalars, n, K, outs);
    return;
  }
#endif
  int c = msm_window_bits(n);
  int nw = (255 + c - 1) / c + 1; /* + carry window */
  long half = 1L << (c - 1);
  int nw_eff = 1;
  for (int k = 0; k < K; k++) {
    int ne = msm_eff_windows(scalars + (size_t)k * n * NR, inf, n, c, nw);
    if (ne > nw_eff) nw_eff = ne;
  }
  int nchunks = (K * nw_eff) >= 8 ? 1 : (8 + nw_eff - 1) / nw_eff;
  long chunk_n = (n + nchunks - 1) / nchunks;
  int ntasks = K * nw_eff * nchunks;
  int16_t *dig = malloc((size_t)K * n * nw_eff * sizeof(int16_t));
  for (int k = 0; k < K; k++)
    msm_recode(scalars + (size_t)k * n * NR, n, c, nw_eff,
               dig + (size_t)k * n * nw_eff);
  g1p *tsums = malloc(ntasks * sizeof(g1p));
#pragma omp parallel for schedule(dynamic)
  for (int t = 0; t < ntasks; t++) {
    int k = t / (nw_eff * nchunks);
    int rem = t % (nw_eff * nchunks);
    int w = rem / nchunks;
    const int16_t *kdig = dig + (size_t)k * n * nw_eff;
    long ti0 = (long)(rem % nchunks) * chunk_n;
    long ti1 = ti0 + chunk_n < n ? ti0 + chunk_n : n;
    g1aff *buckets = calloc(half + 1, sizeof(g1aff));
    g1p *jbuck = calloc(half + 1, sizeof(g1p)); /* z=0 => infinity */
    uint8_t *pend = calloc(half + 1, 1);
    /* batch slots: pointers into mx/my plus sign — no point copies */
    long sb[ABATCH], si[ABATCH];
    int8_t ssgn[ABATCH];
    u64 sden[ABATCH][NQ];
    int m = 0;
    for (long i = ti0; i < ti1; i++) {
      if (inf[i]) continue;
      int d = kdig[i * nw_eff + w];
      if (!d) continue;
      long b = d > 0 ? d : -(long)d;
      g1aff *bk = &buckets[b];
      if (pend[b]) { /* conflict this batch: Jacobian overflow */
        u64 ny[NQ];
        const u64 *py = my[i];
        if (d < 0) {
          memcpy(ny, Q, NQ * 8);
          sub_n(ny, my[i], NQ);
          py = ny;
        }
        g1_madd(&jbuck[b], mx[i], py, &jbuck[b]);
        continue;
      }
      if (!bk->set) { /* free write */
        memcpy(bk->x, mx[i], NQ * 8);
        if (d > 0) {
          memcpy(bk->y, my[i], NQ * 8);
        } else {
          memcpy(bk->y, Q, NQ * 8);
          sub_n(bk->y, my[i], NQ); /* Montgomery negate: q - y */
        }
        /* synchronous write: no pend (see the IFMA core's note — the
         * latched flag deadlocked the affine pipeline) */
        bk->set = 1;
        continue;
      }
      fq_sub(mx[i], bk->x, sden[m]);
      if (is_zero_n(sden[m], NQ)) { /* rare x-collision: slow path */
        u64 ny[NQ];
        const u64 *py = my[i];
        if (d < 0) {
          memcpy(ny, Q, NQ * 8);
          sub_n(ny, my[i], NQ);
          py = ny;
        }
        g1_aff_add_slow(bk, mx[i], py); /* synchronous: no pend */
        continue;
      }
      sb[m] = b;
      si[m] = i;
      ssgn[m] = d > 0 ? 1 : -1;
      pend[b] = 1;
      m++;
      if (m == ABATCH) {
        fq_batch_inv(sden, m);
        for (int k = 0; k < m; k++) {
          u64 lam[NQ];
          g1aff *t = &buckets[sb[k]];
          if (ssgn[k] > 0) {
            fq_sub(my[si[k]], t->y, lam); /* (py - by) * dx^-1 */
          } else {
            fq_add(my[si[k]], t->y, lam); /* -(py + by) * dx^-1 */
            fq_neg(lam, lam);
          }
          fq_mul(lam, sden[k], lam);
          g1_aff_apply(t, mx[si[k]], lam);
        }
        m = 0;
        memset(pend, 0, half + 1);
      }
    }
    if (m) {
      fq_batch_inv(sden, m);
      for (int k = 0; k < m; k++) {
        u64 lam[NQ];
        g1aff *t = &buckets[sb[k]];
        if (ssgn[k] > 0) {
          fq_sub(my[si[k]], t->y, lam);
        } else {
          fq_add(my[si[k]], t->y, lam);
          fq_neg(lam, lam);
        }
        fq_mul(lam, sden[k], lam);
        g1_aff_apply(t, mx[si[k]], lam);
      }
    }
    /* suffix-sum the affine buckets + Jacobian overflow */
    g1p running, acc;
    g1_set_inf(&running);
    g1_set_inf(&acc);
    for (long b = half; b >= 1; b--) {
      if (buckets[b].set)
        g1_madd(&running, buckets[b].x, buckets[b].y, &running);
      if (!g1_is_inf(&jbuck[b])) g1_add(&running, &jbuck[b], &running);
      g1_add(&acc, &running, &acc);
    }
    tsums[t] = acc;
    free(buckets);
    free(jbuck);
    free(pend);
  }
#pragma omp parallel for schedule(static)
  for (int k = 0; k < K; k++) {
    g1p total;
    g1_set_inf(&total);
    for (int w = nw_eff - 1; w >= 0; w--) {
      if (w != nw_eff - 1)
        for (int d = 0; d < c; d++) g1_dbl(&total, &total);
      for (int ch = 0; ch < nchunks; ch++)
        g1_add(&total, &tsums[((size_t)k * nw_eff + w) * nchunks + ch],
               &total);
    }
    outs[k] = total;
  }
  free(tsums);
  free(dig);
}

static void g1_msm_core(const u64 (*mx)[NQ], const u64 (*my)[NQ],
                        const uint8_t *inf, const u64 *scalars, long n,
                        g1p *out) {
  g1_msm_core_multi(mx, my, inf, scalars, n, 1, out);
}

static int g1_out_affine(const g1p *total, u64 *ox, u64 *oy) {
  if (g1_is_inf(total)) return 1;
  u64 zinv[NQ], zi2[NQ], t[NQ];
  fq_inv(total->z, zinv);
  fq_sqr(zinv, zi2);
  fq_mul(total->x, zi2, t);
  fq_from_mont(t, ox);
  fq_mul(total->y, zi2, t);
  fq_mul(t, zinv, t);
  fq_from_mont(t, oy);
  return 0;
}

/* One-time standard -> Montgomery conversion of a point array (lets the
 * prover cache the conversion per proving key instead of per MSM call). */
void g1_to_mont(const u64 *xs, const u64 *ys, long n, u64 *mx, u64 *my) {
  g16_init();
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    fq_to_mont(xs + i * NQ, mx + i * NQ);
    fq_to_mont(ys + i * NQ, my + i * NQ);
  }
}

/* MSM over pre-converted Montgomery points. */
int g1_msm_pre(const u64 *mx, const u64 *my, const uint8_t *inf,
               const u64 *scalars, long n, u64 *ox, u64 *oy) {
  g16_init();
  g1p total;
  g1_msm_core((const u64(*)[NQ])mx, (const u64(*)[NQ])my, inf, scalars, n,
              &total);
  return g1_out_affine(&total, ox, oy);
}

/* K MSMs over ONE pre-converted point set (scalars: K contiguous (n, NR)
 * vectors).  oxs/oys are (K, NQ); oinfs[k] = 1 marks an infinity result.
 * The batched Groth16 prover's hot entry: the point conversion, digit
 * buffers, and task scheduling amortize over the K proofs. */
int g1_msm_multi_pre(const u64 *mx, const u64 *my, const uint8_t *inf,
                     const u64 *scalars, long n, long K, u64 *oxs, u64 *oys,
                     uint8_t *oinfs) {
  g16_init();
  g1p *totals = malloc((size_t)K * sizeof(g1p));
  g1_msm_core_multi((const u64(*)[NQ])mx, (const u64(*)[NQ])my, inf, scalars,
                    n, (int)K, totals);
  for (long k = 0; k < K; k++)
    oinfs[k] =
        (uint8_t)g1_out_affine(&totals[k], oxs + k * NQ, oys + k * NQ);
  free(totals);
  return 0;
}

/* points affine standard form; scalars (n,4) standard; out jacobian -> we
 * return affine standard via single inversion.  Returns 1 if infinity. */
int g1_msm(const u64 *xs, const u64 *ys, const uint8_t *inf,
           const u64 *scalars, long n, u64 *ox, u64 *oy) {
  g16_init();
  u64(*mx)[NQ] = malloc(n * sizeof(*mx));
  u64(*my)[NQ] = malloc(n * sizeof(*my));
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    fq_to_mont(xs + i * NQ, mx[i]);
    fq_to_mont(ys + i * NQ, my[i]);
  }
  g1p total;
  g1_msm_core((const u64(*)[NQ])mx, (const u64(*)[NQ])my, inf, scalars, n,
              &total);
  free(mx);
  free(my);
  return g1_out_affine(&total, ox, oy);
}

/* ---- G2 batch-affine bucket accumulation (mirrors the G1 design:
 * affine buckets, one shared Fq2 inversion per ~ABATCH adds, Jacobian
 * overflow for in-batch conflicts).  A plain Jacobian mixed add costs
 * ~11 Fq2 muls; the batch-affine path ~4 plus the amortized inversion. */
typedef struct {
  fq2 x, y;
  uint8_t set;
} g2aff;

static void f2_batch_inv(fq2 *a, int m) {
  fq2 pref[ABATCH + 1];
  memcpy(pref[0].c0, Q_ONE, NQ * 8);
  memset(pref[0].c1, 0, NQ * 8);
  for (int k = 0; k < m; k++) f2_mul(&pref[k], &a[k], &pref[k + 1]);
  fq2 invall, t;
  f2_inv(&pref[m], &invall);
  for (int k = m - 1; k >= 0; k--) {
    f2_mul(&pref[k], &invall, &t);
    f2_mul(&invall, &a[k], &invall);
    a[k] = t;
  }
}

static void g2_aff_apply(g2aff *b, const fq2 *px, const fq2 *lam) {
  fq2 x3, y3, t;
  f2_sqr(lam, &x3);
  f2_sub(&x3, &b->x, &x3);
  f2_sub(&x3, px, &x3);
  f2_sub(&b->x, &x3, &t);
  f2_mul(lam, &t, &y3);
  f2_sub(&y3, &b->y, &y3);
  b->x = x3;
  b->y = y3;
}

static void g2_aff_add_slow(g2aff *b, const fq2 *px, const fq2 *py) {
  fq2 dx;
  f2_sub(px, &b->x, &dx);
  if (f2_is_zero(&dx)) {
    fq2 sy;
    f2_sub(py, &b->y, &sy);
    if (!f2_is_zero(&sy)) { /* P + (-P) */
      b->set = 0;
      return;
    }
    fq2 lam, num, den;
    f2_sqr(&b->x, &num); /* 3x^2 / 2y */
    f2_dbl(&num, &lam);
    f2_add(&lam, &num, &num);
    f2_dbl(&b->y, &den);
    f2_inv(&den, &den);
    f2_mul(&num, &den, &lam);
    g2_aff_apply(b, px, &lam);
    return;
  }
  f2_inv(&dx, &dx);
  fq2 lam;
  f2_sub(py, &b->y, &lam);
  f2_mul(&lam, &dx, &lam);
  g2_aff_apply(b, px, &lam);
}

static void g2_flush(g2aff *buckets, int m, const long *sb, const long *si,
                     fq2 *sden, const fq2 *mx, const fq2 *my) {
  f2_batch_inv(sden, m);
  for (int k = 0; k < m; k++) {
    fq2 lam;
    g2aff *t = &buckets[sb[k]];
    f2_sub(&my[si[k]], &t->y, &lam);
    f2_mul(&lam, &sden[k], &lam);
    g2_aff_apply(t, &mx[si[k]], &lam);
  }
}

/* Jacobian -> affine standard-form output; returns 1 for infinity. */
static int g2_out_affine(const g2p *total, u64 *ox, u64 *oy) {
  if (g2_is_inf(total)) return 1;
  fq2 zinv, zi2, t;
  f2_inv(&total->z, &zinv);
  f2_sqr(&zinv, &zi2);
  f2_mul(&total->x, &zi2, &t);
  fq_from_mont(t.c0, ox);
  fq_from_mont(t.c1, ox + NQ);
  f2_mul(&total->y, &zi2, &t);
  f2_mul(&t, &zinv, &t);
  fq_from_mont(t.c0, oy);
  fq_from_mont(t.c1, oy + NQ);
  return 0;
}

/* G2 core over pre-converted Montgomery points, K scalar vectors (the
 * batched B2 MSM of the Groth16 multi-prove; mirrors
 * g1_msm_core_*_multi's K x window x chunk task grid). */
static void g2_msm_core_multi(const fq2 *mx, const fq2 *my,
                              const uint8_t *inf, const u64 *scalars, long n,
                              int K, g2p *outs) {
  int c = msm_window_bits(n);
  int nw = (255 + c - 1) / c;
  u64 mask = (1ULL << c) - 1;
  /* effective window count from the widest scalar: wire-value MSMs are
   * mostly bits, where every add lands in window 0 — without the chunk
   * split below, that serializes the whole MSM onto one thread */
  int nw_eff = 1;
  for (int k = 0; k < K; k++) {
    int ne = msm_eff_windows(scalars + (size_t)k * n * NR, inf, n, c, nw);
    if (ne > nw_eff) nw_eff = ne;
  }
  int nchunks = (K * nw_eff) >= 8 ? 1 : (8 + nw_eff - 1) / nw_eff;
  long nb = 1L << c;
  long chunk_n = (n + nchunks - 1) / nchunks;
  int ntasks = K * nw_eff * nchunks;
  g2p *tsums = malloc(ntasks * sizeof(g2p));
#pragma omp parallel for schedule(dynamic)
  for (int t = 0; t < ntasks; t++) {
    int k = t / (nw_eff * nchunks);
    int rem = t % (nw_eff * nchunks);
    int w = rem / nchunks;
    const u64 *ksc = scalars + (size_t)k * n * NR;
    long i0 = (long)(rem % nchunks) * chunk_n;
    long i1 = i0 + chunk_n < n ? i0 + chunk_n : n;
    g2aff *buckets = calloc(nb, sizeof(g2aff));
    g2p *jbuck = calloc(nb, sizeof(g2p));
    uint8_t *pend = calloc(nb, 1);
    long sb[ABATCH], si[ABATCH];
    fq2 sden[ABATCH];
    int m = 0;
    int bit = w * c;
    for (long i = i0; i < i1; i++) {
      if (inf[i]) continue;
      const u64 *s = ksc + i * NR;
      int limb = bit >> 6, off = bit & 63;
      u64 d = s[limb] >> off;
      if (off + c > 64 && limb + 1 < NR) d |= s[limb + 1] << (64 - off);
      d &= mask;
      if (!d) continue;
      g2aff *bk = &buckets[d];
      if (pend[d]) { /* conflict this batch: Jacobian overflow */
        g2_madd(&jbuck[d], &mx[i], &my[i], &jbuck[d]);
        continue;
      }
      if (!bk->set) { /* synchronous free write: no pend (G1 note) */
        bk->x = mx[i];
        bk->y = my[i];
        bk->set = 1;
        continue;
      }
      f2_sub(&mx[i], &bk->x, &sden[m]);
      if (f2_is_zero(&sden[m])) { /* x-collision: synchronous slow add */
        g2_aff_add_slow(bk, &mx[i], &my[i]);
        continue;
      }
      sb[m] = d;
      si[m] = i;
      pend[d] = 1;
      m++;
      if (m == ABATCH) {
        g2_flush(buckets, m, sb, si, sden, mx, my);
        m = 0;
        memset(pend, 0, nb);
      }
    }
    if (m) g2_flush(buckets, m, sb, si, sden, mx, my);
    g2p running, acc;
    g2_set_inf(&running);
    g2_set_inf(&acc);
    for (long b = nb - 1; b >= 1; b--) {
      if (buckets[b].set)
        g2_madd(&running, &buckets[b].x, &buckets[b].y, &running);
      if (!g2_is_inf(&jbuck[b])) g2_add(&running, &jbuck[b], &running);
      g2_add(&acc, &running, &acc);
    }
    tsums[t] = acc;
    free(buckets);
    free(jbuck);
    free(pend);
  }
#pragma omp parallel for schedule(static)
  for (int k = 0; k < K; k++) {
    g2p total;
    g2_set_inf(&total);
    for (int w = nw_eff - 1; w >= 0; w--) {
      if (w != nw_eff - 1)
        for (int d = 0; d < c; d++) g2_dbl(&total, &total);
      for (int ch = 0; ch < nchunks; ch++)
        g2_add(&total, &tsums[((size_t)k * nw_eff + w) * nchunks + ch],
               &total);
    }
    outs[k] = total;
  }
  free(tsums);
}

static fq2 *g2_points_to_mont(const u64 *xs, const u64 *ys, long n,
                              fq2 **myo) {
  fq2 *mx = malloc(n * sizeof(fq2));
  fq2 *my = malloc(n * sizeof(fq2));
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    fq_to_mont(xs + i * 2 * NQ, mx[i].c0);
    fq_to_mont(xs + i * 2 * NQ + NQ, mx[i].c1);
    fq_to_mont(ys + i * 2 * NQ, my[i].c0);
    fq_to_mont(ys + i * 2 * NQ + NQ, my[i].c1);
  }
  *myo = my;
  return mx;
}

int g2_msm(const u64 *xs, const u64 *ys, const uint8_t *inf,
           const u64 *scalars, long n, u64 *ox, u64 *oy) {
  g16_init();
  fq2 *my, *mx = g2_points_to_mont(xs, ys, n, &my);
  g2p total;
  g2_msm_core_multi(mx, my, inf, scalars, n, 1, &total);
  free(mx);
  free(my);
  return g2_out_affine(&total, ox, oy);
}

/* K G2 MSMs over one point set; one Montgomery conversion for the batch.
 * oxs/oys are (K, 2*NQ); oinfs[k] = 1 marks an infinity result. */
int g2_msm_multi(const u64 *xs, const u64 *ys, const uint8_t *inf,
                 const u64 *scalars, long n, long K, u64 *oxs, u64 *oys,
                 uint8_t *oinfs) {
  g16_init();
  fq2 *my, *mx = g2_points_to_mont(xs, ys, n, &my);
  g2p *totals = malloc((size_t)K * sizeof(g2p));
  g2_msm_core_multi(mx, my, inf, scalars, n, (int)K, totals);
  free(mx);
  free(my);
  for (long k = 0; k < K; k++)
    oinfs[k] = (uint8_t)g2_out_affine(&totals[k], oxs + k * 2 * NQ,
                                      oys + k * 2 * NQ);
  free(totals);
  return 0;
}

/* ------------------------------------------------------------ Fr FFT --- */

static void bit_reverse(u64 *a, long n) {
  long j = 0;
  for (long i = 1; i < n; i++) {
    long bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j |= bit;
    if (i < j) {
      u64 tmp[NR];
      memcpy(tmp, a + i * NR, NR * 8);
      memcpy(a + i * NR, a + j * NR, NR * 8);
      memcpy(a + j * NR, tmp, NR * 8);
    }
  }
}

/* in-place NTT; a is (n,4) standard form; omega standard form; if
 * scale_inv, multiply all outputs by n^{-1} (i.e. this is the inverse
 * transform when omega = w^{-1}). */
#ifdef HAVE_IFMA52
/* IFMA radix-2 NTT over blocks of 8 lanes (SoA per block).
 *
 * a: (n,4) standard-form limbs, already BIT-REVERSED; tw: Mont64
 * twiddle table tw[j] = omega^j (j < n/2).  Strategy: convert once to
 * Mont52 block-SoA, run every stage 8 butterflies per instruction
 * bundle — stages with half >= 8 pair whole blocks (twiddles fetched
 * with 64-bit gathers); the three in-block stages (len 2/4/8) use lane
 * permutes with a per-stage blend mask.  The final pass multiplies by
 * a PLAIN (non-Montgomery) constant, which simultaneously leaves the
 * Montgomery domain and applies the optional 1/n scaling. */
static void fr_fft52(u64 *a, long log_n, u64 (*tw)[NR], const u64 *om,
                     int scale_inv) {
  long n = 1L << log_n;
  long nblk = n >> 3;
  /* --- tw52 cache: Mont52 AoS [n/2][NR52] --- */
  static u64(*tw52_cache)[NR52] = NULL;
  static u64 tw52_om[NR];
  static long tw52_n = 0;
  if (!(tw52_cache && tw52_n == n && !memcmp(tw52_om, om, NR * 8))) {
    free(tw52_cache);
    long halfn = n >> 1;
    u64(*t52)[NR52] = malloc(halfn * sizeof(*t52));
#pragma omp parallel for schedule(static)
    for (long j0 = 0; j0 < halfn; j0 += 8) {
      u64 soa[NR52][8];
      long m = halfn - j0 < 8 ? halfn - j0 : 8;
      for (long l = 0; l < m; l++) {
        u64 std[NR], v52[NR52];
        fr_from_mont(tw[j0 + l], std);
        limbs64_to_52(std, NR, v52, NR52);
        for (int j = 0; j < NR52; j++) soa[j][l] = v52[j];
      }
      for (long l = m; l < 8; l++)
        for (int j = 0; j < NR52; j++) soa[j][l] = 0;
      vFR_mul(soa, FR_R52SQ, soa); /* -> Mont52 */
      for (long l = 0; l < m; l++)
        for (int j = 0; j < NR52; j++) t52[j0 + l][j] = soa[j][l];
    }
    tw52_cache = t52;
    tw52_n = n;
    memcpy(tw52_om, om, NR * 8);
  }
  u64(*tw52)[NR52] = tw52_cache;

  /* --- convert input: standard radix64 -> Mont52 block-SoA --- */
  typedef u64 blk_t[NR52][8];
  blk_t *w = malloc((size_t)nblk * sizeof(blk_t));
#pragma omp parallel for schedule(static)
  for (long b = 0; b < nblk; b++) {
    for (int l = 0; l < 8; l++) {
      u64 v52[NR52];
      limbs64_to_52(a + (8 * b + l) * NR, NR, v52, NR52);
      for (int j = 0; j < NR52; j++) w[b][j][l] = v52[j];
    }
    vFR_mul(w[b], FR_R52SQ, w[b]);
  }

  /* --- stages 1-3: in-block butterflies via lane permutes --- */
  for (long len = 2; len <= 8 && len <= n; len <<= 1) {
    long half = len >> 1;
    long step = n / len;
    /* per-lane twiddle vector (same for every block) */
    u64 W[NR52][8];
    for (int p = 0; p < 8; p++) {
      long k = p & (len - 1);
      long ti = k >= half ? (k - half) * step : 0; /* lo lanes: dummy */
      for (int j = 0; j < NR52; j++) W[j][p] = tw52[ti][j];
    }
    __m512i perm = _mm512_set_epi64(7 ^ half, 6 ^ half, 5 ^ half, 4 ^ half,
                                    3 ^ half, 2 ^ half, 1 ^ half, 0 ^ half);
    __mmask8 himask = 0;
    for (int p = 0; p < 8; p++)
      if ((p & (len - 1)) >= half) himask |= (__mmask8)(1u << p);
#pragma omp parallel for schedule(static)
    for (long b = 0; b < nblk; b++) {
      u64 tm[NR52][8], tswap[NR52][8], uswap[NR52][8], addr_[NR52][8],
          subr[NR52][8];
      vFR_mul(w[b], W, tm);
      for (int j = 0; j < NR52; j++) {
        __m512i t = _mm512_loadu_si512(tm[j]);
        __m512i v = _mm512_loadu_si512(w[b][j]);
        _mm512_storeu_si512(tswap[j], _mm512_permutexvar_epi64(perm, t));
        _mm512_storeu_si512(uswap[j], _mm512_permutexvar_epi64(perm, v));
      }
      vFR_add(w[b], tswap, addr_);
      vFR_sub(uswap, tm, subr);
      for (int j = 0; j < NR52; j++) {
        __m512i r = _mm512_mask_blend_epi64(
            himask, _mm512_loadu_si512(addr_[j]), _mm512_loadu_si512(subr[j]));
        _mm512_storeu_si512(w[b][j], r);
      }
    }
  }

  /* --- stages with half >= 8: whole-block butterflies --- */
  for (long len = 16; len <= n; len <<= 1) {
    long half = len >> 1;
    long step = n / len;
    long hb = half >> 3;              /* hi-block offset */
    long vb_per_group = half >> 3;    /* lo blocks per group */
    long nvb = n >> 4;                /* total vector butterflies */
    int shift = 63 - __builtin_clzl(vb_per_group);
    __m512i ivec = _mm512_mullo_epi64(
        _mm512_set_epi64(7, 6, 5, 4, 3, 2, 1, 0),
        _mm512_set1_epi64(step * NR52));
#pragma omp parallel for schedule(static)
    for (long vb = 0; vb < nvb; vb++) {
      long g = vb >> shift;
      long kb = vb & (vb_per_group - 1);
      long lob = g * (len >> 3) + kb;
      long k = kb << 3;
      __m512i kbase =
          _mm512_add_epi64(_mm512_set1_epi64(k * step * NR52), ivec);
      u64 twv[NR52][8], tvec[NR52][8];
      for (int j = 0; j < NR52; j++) {
        __m512i vidx = _mm512_add_epi64(kbase, _mm512_set1_epi64(j));
        _mm512_storeu_si512(twv[j],
                            _mm512_i64gather_epi64(vidx, (const long long *)tw52, 8));
      }
      vFR_mul(w[lob + hb], twv, tvec);
      u64 lo_old[NR52][8];
      memcpy(lo_old, w[lob], sizeof(lo_old));
      vFR_add(lo_old, tvec, w[lob]);
      vFR_sub(lo_old, tvec, w[lob + hb]);
    }
  }

  /* --- leave Montgomery (+ optional 1/n) and convert back --- */
  u64 kconst[NR52][8];
  if (scale_inv) {
    u64 ninv[NR] = {0}, nval[NR] = {0}, nm[NR];
    nval[log_n >> 6] = 1ULL << (log_n & 63);
    fr_to_mont(nval, nm);
    fr_inv(nm, ninv);
    fr_from_mont(ninv, ninv); /* plain n^-1 */
    u64 k52[NR52];
    limbs64_to_52(ninv, NR, k52, NR52);
    for (int j = 0; j < NR52; j++)
      for (int l = 0; l < 8; l++) kconst[j][l] = k52[j];
  } else {
    memcpy(kconst, FR_ONE52, sizeof(kconst));
  }
#pragma omp parallel for schedule(static)
  for (long b = 0; b < nblk; b++) {
    vFR_mul(w[b], kconst, w[b]);
    for (int l = 0; l < 8; l++) {
      u64 v52[NR52];
      for (int j = 0; j < NR52; j++) v52[j] = w[b][j][l];
      limbs52_to_64(v52, NR52, a + (8 * b + l) * NR, NR);
    }
  }
  free(w);
}
#endif /* HAVE_IFMA52 */

void fr_fft(u64 *a, long log_n, const u64 *omega_std, int scale_inv) {
  g16_init();
  long n = 1L << log_n;
#ifndef HAVE_IFMA52
  /* to Montgomery (scalar path converts up front; the IFMA path
   * converts into its own 52-bit domain after the twiddle build) */
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) fr_to_mont(a + i * NR, a + i * NR);
#else
  if (n < 16) /* tiny transforms: scalar */
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) fr_to_mont(a + i * NR, a + i * NR);
#endif
  /* twiddles for the full size: tw[j] = omega^j, j < n/2 (Montgomery).
   * Cached across calls: witness_map runs six transforms over just two
   * omegas, and the sequential power chain is the only serial O(n)
   * stretch in here.  Parallel fill via per-thread jump-in powers. */
  u64 om[NR];
  fr_to_mont(omega_std, om);
  /* NOT safe under concurrent fr_fft calls; the only caller
   * (native_backend.witness_map) runs transforms sequentially. */
  static u64(*tw_cache)[NR] = NULL;
  static u64 tw_om[NR];
  static long tw_n = 0;
  u64(*tw)[NR];
  long halfn = n / 2 > 0 ? n / 2 : 1;
  int hit = tw_cache && tw_n == n && !memcmp(tw_om, om, NR * 8);
  if (hit) {
    tw = tw_cache;
  } else {
    tw = malloc(halfn * sizeof(*tw));
    memcpy(tw[0], FR_ONE, NR * 8);
    long nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
#endif
    long chunk = (halfn + nt - 1) / nt;
#pragma omp parallel for schedule(static)
    for (long t = 0; t < nt; t++) {
      long lo = t * chunk, hi = lo + chunk < halfn ? lo + chunk : halfn;
      if (lo >= hi) continue;
      u64 cur[NR], base[NR];
      memcpy(cur, FR_ONE, NR * 8);
      memcpy(base, om, NR * 8);
      long e = lo;
      while (e) {
        if (e & 1) fr_mul(cur, base, cur);
        fr_mul(base, base, base);
        e >>= 1;
      }
      memcpy(tw[lo], cur, NR * 8);
      for (long j = lo + 1; j < hi; j++) fr_mul(tw[j - 1], om, tw[j]);
    }
    free(tw_cache);
    tw_cache = tw;
    tw_n = n;
    memcpy(tw_om, om, NR * 8);
  }
  bit_reverse(a, n);
#ifdef HAVE_IFMA52
  if (n >= 16) {
    fr_fft52(a, log_n, tw, om, scale_inv);
    return;
  }
#endif
  for (long len = 2; len <= n; len <<= 1) {
    long half = len >> 1;
    long step = n / len;
    /* flat butterfly index: the block loop alone starves threads once
     * len grows past n/nthreads (the last stage is ONE block) */
    long pairs = n >> 1;
#pragma omp parallel for schedule(static)
    for (long b = 0; b < pairs; b++) {
      long start = (b >> (63 - __builtin_clzl(half))) * len;
      long k = b & (half - 1);
      u64 *lo = a + (start + k) * NR;
      u64 *hi = a + (start + k + half) * NR;
      u64 t[NR], u[NR];
      fr_mul(hi, tw[k * step], t);
      memcpy(u, lo, NR * 8);
      fr_add(u, t, lo);
      fr_sub(u, t, hi);
    }
  }
  if (scale_inv) {
    /* n^{-1} mod r */
    u64 ninv[NR] = {0}, nval[NR] = {0};
    nval[log_n >> 6] = 1ULL << (log_n & 63);
    u64 nm[NR];
    fr_to_mont(nval, nm);
    fr_inv(nm, ninv);
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n; i++) fr_mul(a + i * NR, ninv, a + i * NR);
  }
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) fr_from_mont(a + i * NR, a + i * NR);
}

/* a[i] *= g^i (all standard form); invert_g for the coset inverse */
void fr_scale_powers(u64 *a, long n, const u64 *g_std, int invert_g) {
  g16_init();
  u64 g[NR];
  fr_to_mont(g_std, g);
  if (invert_g) fr_inv(g, g);
  /* per-thread chunks with a jump-in power */
  long nt = 1;
#ifdef _OPENMP
  nt = omp_get_max_threads();
#endif
  long chunk = (n + nt - 1) / nt;
#pragma omp parallel for schedule(static)
  for (long t = 0; t < nt; t++) {
    long lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) continue;
    /* g^lo by square-and-multiply */
    u64 cur[NR], base[NR];
    memcpy(cur, FR_ONE, NR * 8);
    memcpy(base, g, NR * 8);
    long e = lo;
    while (e) {
      if (e & 1) fr_mul(cur, base, cur);
      fr_mul(base, base, base);
      e >>= 1;
    }
    for (long i = lo; i < hi; i++) {
      u64 am[NR];
      fr_to_mont(a + i * NR, am);
      fr_mul(am, cur, am);
      fr_from_mont(am, a + i * NR);
      fr_mul(cur, g, cur);
    }
  }
}

/* out = (a*b - c) * zinv, all (n,4) standard, elementwise */
void fr_quotient(const u64 *a, const u64 *b, const u64 *c, const u64 *zinv_std,
                 long n, u64 *out) {
  g16_init();
  u64 zi[NR];
  fr_to_mont(zinv_std, zi);
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) {
    u64 am[NR], bm[NR], cm[NR], t[NR];
    fr_to_mont(a + i * NR, am);
    fr_to_mont(b + i * NR, bm);
    fr_to_mont(c + i * NR, cm);
    fr_mul(am, bm, t);
    fr_sub(t, cm, t);
    fr_mul(t, zi, t);
    fr_from_mont(t, out + i * NR);
  }
}

/* sparse matvec over Fr: out[rows[k]] += vals[k] * z[cols[k]].
 * vals standard form (n,4); z standard; out must be zeroed by caller.
 * Sequential per-row accumulation; parallel over disjoint row ranges is
 * the caller's job (rows are sorted in our COO artifacts). */
void fr_spmv(const int32_t *rows, const int32_t *cols, const u64 *vals,
             long nnz, const u64 *z_mont, u64 *out) {
  g16_init();
#pragma omp parallel
  {
    int nt = 1, tid = 0;
#ifdef _OPENMP
    nt = omp_get_num_threads();
    tid = omp_get_thread_num();
#endif
    for (long k = 0; k < nnz; k++) {
      int32_t r = rows[k];
      if (r % nt != tid) continue; /* row-disjoint partition */
      u64 t[NR];
      /* montmul(std, mont) = standard product */
      fr_mul(vals + k * NR, z_mont + (long)cols[k] * NR, t);
      fr_add(out + (long)r * NR, t, out + (long)r * NR);
    }
  }
}

/* z (n,4) standard -> Montgomery, helper for spmv */
void fr_batch_to_mont(const u64 *in, long n, u64 *out) {
  g16_init();
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; i++) fr_to_mont(in + i * NR, out + i * NR);
}

/* ----------------------------------------------------- self-check ------ */

/* returns 0 on success; exercises field round-trips for the build sanity
 * check in the Python loader */
int g16_selftest(void) {
  g16_init();
  /* fq: to/from Montgomery round trip on a known value */
  u64 a[NQ] = {12345, 678, 0, 0, 0, 0}, m[NQ], back[NQ];
  fq_to_mont(a, m);
  fq_from_mont(m, back);
  if (memcmp(a, back, NQ * 8)) return 1;
  /* fq: x * x^{-1} == 1 */
  u64 inv[NQ], prod[NQ], one_std[NQ] = {1};
  fq_inv(m, inv);
  fq_mul(m, inv, prod);
  fq_from_mont(prod, back);
  if (memcmp(back, one_std, NQ * 8)) return 2;
  /* g1: generator doubling stays on curve: y^2 = x^3 + 4 */
  g1p g;
  fq_to_mont(G1X, g.x);
  fq_to_mont(G1Y, g.y);
  memcpy(g.z, Q_ONE, NQ * 8);
  g1p d;
  g1_dbl(&g, &d);
  u64 xs[NQ], ys[NQ];
  uint8_t inf;
  g1_normalize_batch(&d, 1, xs, ys, &inf);
  if (inf) return 3;
  u64 xm[NQ], ym[NQ], lhs[NQ], rhs[NQ], four[NQ] = {4};
  fq_to_mont(xs, xm);
  fq_to_mont(ys, ym);
  fq_sqr(ym, lhs);
  fq_sqr(xm, rhs);
  fq_mul(rhs, xm, rhs);
  u64 fourm[NQ];
  fq_to_mont(four, fourm);
  fq_add(rhs, fourm, rhs);
  if (memcmp(lhs, rhs, NQ * 8)) return 4;
#ifdef HAVE_IFMA52
  /* IFMA 8-lane tier vs the scalar core: mul/add/sub over random and
   * edge lanes, plus the 8x8 transpose and domain conversions. */
  {
    u64 seed = 0x243f6a8885a308d3ULL;
    u64 a64[8][NQ], b64[8][NQ];
    for (int l = 0; l < 8; l++) {
      for (int j = 0; j < NQ; j++) {
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        a64[l][j] = seed;
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        b64[l][j] = seed;
      }
      a64[l][NQ - 1] %= Q[NQ - 1];
      b64[l][NQ - 1] %= Q[NQ - 1];
    }
    /* edge lanes: 0, 1, q-1 */
    memset(a64[0], 0, NQ * 8);
    memset(b64[1], 0, NQ * 8);
    b64[1][0] = 1;
    memcpy(a64[2], Q, NQ * 8);
    a64[2][0] -= 1;
    memcpy(b64[2], Q, NQ * 8);
    b64[2][0] -= 1;
    u64 a52[NQ52][8], b52[NQ52][8], o52[NQ52][8], t52[NQ52];
    for (int l = 0; l < 8; l++) {
      limbs64_to_52(a64[l], NQ, t52, NQ52);
      for (int j = 0; j < NQ52; j++) a52[j][l] = t52[j];
      limbs64_to_52(b64[l], NQ, t52, NQ52);
      for (int j = 0; j < NQ52; j++) b52[j][l] = t52[j];
    }
    /* to Mont52, multiply, from Mont52; compare against scalar mont64 */
    u64 am[NQ52][8], bm[NQ52][8];
    vFQ_mul(a52, FQ_R52SQ, am);
    vFQ_mul(b52, FQ_R52SQ, bm);
    vFQ_mul(am, bm, o52);
    vFQ_mul(o52, FQ_ONE52, o52);
    for (int l = 0; l < 8; l++) {
      u64 got52[NQ52], got[NQ], am_[NQ], bm_[NQ], want[NQ];
      for (int j = 0; j < NQ52; j++) got52[j] = o52[j][l];
      limbs52_to_64(got52, NQ52, got, NQ);
      fq_to_mont(a64[l], am_);
      fq_to_mont(b64[l], bm_);
      fq_mul(am_, bm_, want);
      fq_from_mont(want, want);
      if (memcmp(got, want, NQ * 8)) return 5;
    }
    /* add/sub (plain integer domain: canonical residues) */
    u64 s52[NQ52][8], d52[NQ52][8];
    vFQ_add(a52, b52, s52);
    vFQ_sub(a52, b52, d52);
    for (int l = 0; l < 8; l++) {
      u64 got52[NQ52], got[NQ], want[NQ];
      for (int j = 0; j < NQ52; j++) got52[j] = s52[j][l];
      limbs52_to_64(got52, NQ52, got, NQ);
      add_mod_n(a64[l], b64[l], want, Q, NQ);
      if (memcmp(got, want, NQ * 8)) return 6;
      for (int j = 0; j < NQ52; j++) got52[j] = d52[j][l];
      limbs52_to_64(got52, NQ52, got, NQ);
      sub_mod_n(a64[l], b64[l], want, Q, NQ);
      if (memcmp(got, want, NQ * 8)) return 7;
    }
    /* Fr lane check (mul only; add/sub share the macro) */
    u64 fa[8][NR], fb[8][NR];
    for (int l = 0; l < 8; l++) {
      for (int j = 0; j < NR; j++) {
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        fa[l][j] = seed;
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        fb[l][j] = seed;
      }
      fa[l][NR - 1] %= FRM[NR - 1];
      fb[l][NR - 1] %= FRM[NR - 1];
    }
    u64 fa52[NR52][8], fb52[NR52][8], fo52[NR52][8], ft52[NR52];
    for (int l = 0; l < 8; l++) {
      limbs64_to_52(fa[l], NR, ft52, NR52);
      for (int j = 0; j < NR52; j++) fa52[j][l] = ft52[j];
      limbs64_to_52(fb[l], NR, ft52, NR52);
      for (int j = 0; j < NR52; j++) fb52[j][l] = ft52[j];
    }
    u64 fam[NR52][8], fbm[NR52][8];
    vFR_mul(fa52, FR_R52SQ, fam);
    vFR_mul(fb52, FR_R52SQ, fbm);
    vFR_mul(fam, fbm, fo52);
    vFR_mul(fo52, FR_ONE52, fo52);
    for (int l = 0; l < 8; l++) {
      u64 got52[NR52], got[NR], am_[NR], bm_[NR], want[NR];
      for (int j = 0; j < NR52; j++) got52[j] = fo52[j][l];
      limbs52_to_64(got52, NR52, got, NR);
      fr_to_mont(fa[l], am_);
      fr_to_mont(fb[l], bm_);
      fr_mul(am_, bm_, want);
      fr_from_mont(want, want);
      if (memcmp(got, want, NR * 8)) return 8;
    }
    /* transpose involution + correctness */
    u64 tin[8][8], tout[8][8], tback[8][8];
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) tin[i][j] = (u64)(i * 8 + j) * 0x9e3779b9ULL;
    transpose8x8(tin, tout);
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (tout[i][j] != tin[j][i]) return 9;
    transpose8x8(tout, tback);
    if (memcmp(tin, tback, sizeof(tin))) return 9;
  }
#endif
  return 0;
}
