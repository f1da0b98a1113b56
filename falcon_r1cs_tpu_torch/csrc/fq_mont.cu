// BLS12-381 Fq Montgomery arithmetic and G1 point additions for Hopper
// (sm_90a), plain C entry points loaded with ctypes by
// falcon_r1cs_tpu_torch/ops/_build.py and wrapped by ops/fq.py.
//
// The kernels replace the Pallas TPU kernels of
//   falcon_r1cs_tpu/ops/pallas_fq.py:
//   mont_mul_kernel       <- _build_mul_cached's kernel (K4): x <- x*b, depth times
//   point_add_kernel      <- _point_add_kernel (K5): complete Jacobian add
//   point_add_aff_kernel  <- _point_add_aff_kernel (K6): affine + affine -> Jacobian
// They compute exactly the arithmetic of ops/fq_mont.py (the plain
// versions in ops/fq_mont.py and ops/fq.py): relaxed signed 12-bit limbs,
// 35 a value, R = 2^408; the 35x35 limb product, three semi-normalisation
// rounds, m = T mu mod R, u = m q, the f32 carry estimate of the exact
// divide by R and the spill fold; the equality tests by an f32 quotient
// estimate and 30 CRT residues.  Every output limb is bit-equal to the
// plain version.
//
// Layout: limb-major, (35, m) int32 per coordinate and (m,) bool flags,
// one thread per point.  Limb l of point i sits at l * m + i, so the
// threads of a warp load and store neighbouring addresses.
//
// What bounds them on an H100: integer multiply-adds, not bytes.  One
// mont_mul is 1225 + 595 + 1190 = 3010 int32 multiply-adds (the a*b
// product, the 34 low columns of T*mu, m*q) plus ~2,500 shifts, masks and
// adds of the semi rounds; K5 runs 8 of them before its equality tests
// and 8 (chord) or 7 (tangent) after, K6 runs 6 on either path.  K5 reads
// about 850 bytes a point and writes 424: at ~16 multiply-adds per byte
// read the card's int32 rate, not its bandwidth, sets the bound.
//
// What the design does about it (a first, simple and exact design):
// - one thread per point; every 35-limb value is a local array, and
//   mont_mul is one non-inlined function whose 71-column accumulator and
//   operands live in registers while it runs (fully unrolled, constant
//   indices); values between calls live in the thread's local memory,
//   cached in L1/L2 (ptxas reports the spill; see PERF.md);
// - the mu product computes only the 34 columns that m keeps: a
//   semi round carries upward only, so columns < 34 of the full product
//   depend only on columns < 34;
// - K5 and K6 branch on the infinity flags and on the equality tests and
//   compute only the path they select (the plain versions compute both
//   and select), so the chord add costs 16 products, not 23; the selected
//   path's limbs are the same either way;
// - constant tables (q, mu, the f32 weights, the CRT tables, one) sit in
//   __constant__ memory, read at the same address by every thread.
// Limb-parallel warps, shared-memory staging and tensor-core products are
// left for later.
//
// Exactness (signed overflow is undefined in CUDA C++): all bounds of
// ops/fq_mont.py hold (products < 2^29.1, semi rounds bring limbs to
// <= 2^12 + 2), and every integer multiply and add here runs through
// unsigned helpers that wrap mod 2^32 as the plain version's int32 tensors
// do, so no expression has undefined behaviour even outside those bounds.
// asr() is the arithmetic shift right of a signed int (nvcc shifts signed
// values arithmetically; C++20 defines it so).  Nothing shifts a negative
// value left: the spill fold multiplies.  The f32 estimates use
// __fmul_rn / __fadd_rn (no FMA contraction, no fast math) and rintf
// (round half to even, as torch.round and jnp.round).

#include <cuda_runtime.h>

namespace {

constexpr int kLimb = 12;
constexpr int kMask = (1 << kLimb) - 1;
constexpr int kNsig = 34;
constexpr int kNl = 35;
constexpr int kProd = 2 * kNl + 1;  // 71
constexpr int kZcols = kNl + 2;     // 37
constexpr int kPrimes = 30;
constexpr int kThreads = 128;

__constant__ int c_q[kNl];
__constant__ int c_mu[kNsig];
__constant__ float c_carry_w[kNsig];
__constant__ float c_alpha_w[kNl];
__constant__ int c_crt_w[kZcols * kPrimes];  // [i][p]
__constant__ int c_crt_p[kPrimes];
__constant__ float c_crt_r[kPrimes];
__constant__ int c_one[kNl];

// two's-complement wrapping arithmetic (mod 2^32), as the plain version's
// int32 tensors
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
// arithmetic shift right of a signed value (jnp/torch `>>` on int32)
__device__ __forceinline__ int asr(int x, int s) { return x >> s; }

// One masked shift-add round over L columns: t_k <- (t_k & mask) +
// (t_{k-1} >> 12); the top column keeps its full value plus the incoming
// carry when `top` is set (fq_mont._semi_round), and is masked like the
// others when the L columns are the prefix of a longer buffer.
template <int L, bool top>
__device__ __forceinline__ void semi_round(int (&t)[L]) {
  int carry = asr(t[0], kLimb);
  t[0] &= kMask;
#pragma unroll
  for (int k = 1; k < L; ++k) {
    const int c = asr(t[k], kLimb);
    t[k] = (top && k == L - 1) ? wadd(t[k], carry) : wadd(t[k] & kMask, carry);
    carry = c;
  }
}

template <int L, bool top>
__device__ __forceinline__ void semi3(int (&t)[L]) {
  semi_round<L, top>(t);
  semi_round<L, top>(t);
  semi_round<L, top>(t);
}

// o = a * b * R^-1 (lazy; fq_mont.mont_mul).  o may alias a or b: both are
// read into registers first.
__device__ __noinline__ void mont_mul(int* o, const int* a, const int* b) {
  int ra[kNl], rb[kNl];
#pragma unroll
  for (int i = 0; i < kNl; ++i) {
    ra[i] = a[i];
    rb[i] = b[i];
  }
  // T = a b: 69 anti-diagonals + 2 spare columns, exact (< 2^29.1)
  int t[kProd];
#pragma unroll
  for (int c = 0; c < kProd; ++c) {
    int acc = 0;
#pragma unroll
    for (int i = (c > kNl - 1 ? c - (kNl - 1) : 0); i <= (c < kNl - 1 ? c : kNl - 1); ++i) {
      acc = wadd(acc, wmul(ra[i], rb[c - i]));
    }
    t[c] = acc;
  }
  semi3<kProd, true>(t);
  // m = semi(T[:34] mu)[:34]: columns < 34 of the full product only
  int m[kNsig];
#pragma unroll
  for (int c = 0; c < kNsig; ++c) {
    int acc = 0;
#pragma unroll
    for (int i = 0; i <= c; ++i) acc = wadd(acc, wmul(t[i], c_mu[c - i]));
    m[c] = acc;
  }
  semi3<kNsig, false>(m);
  // u = semi(m q), 71 columns
  int u[kProd];
#pragma unroll
  for (int c = 0; c < kProd; ++c) {
    int acc = 0;
#pragma unroll
    for (int i = (c > kNl - 1 ? c - (kNl - 1) : 0); i <= (c < kNsig - 1 ? c : kNsig - 1); ++i) {
      acc = wadd(acc, wmul(m[i], c_q[c - i]));
    }
    u[c] = acc;
  }
  semi3<kProd, true>(u);
  // s = semi_round(T + u), an exact multiple of R
#pragma unroll
  for (int c = 0; c < kProd; ++c) u[c] = wadd(t[c], u[c]);
  semi_round<kProd, true>(u);
  // k = value(s[:34]) / 2^408, an integer |k| <= 2
  float est = 0.0f;
#pragma unroll
  for (int i = 0; i < kNsig; ++i) {
    est = __fadd_rn(est, __fmul_rn(static_cast<float>(u[i]), c_carry_w[i]));
  }
  const int k = static_cast<int>(rintf(est));
  o[0] = wadd(u[kNsig], k);
#pragma unroll
  for (int i = 1; i < kNl - 1; ++i) o[i] = u[kNsig + i];
  // fold the spill columns 69, 70 into the headroom limb (multiply, as
  // they may be negative)
  o[kNl - 1] = wadd(wadd(u[kNsig + kNl - 1], wmul(u[kNsig + kNl], 1 << kLimb)),
                    wmul(u[kNsig + kNl + 1], 1 << (2 * kLimb)));
}

// o = semi_round(a + b) / semi_round(a - b) over 35 limbs (fq_mont.add_mod,
// sub_mod); o may alias a or b
__device__ __forceinline__ void add_mod(int* o, const int* a, const int* b) {
  int t[kNl];
#pragma unroll
  for (int i = 0; i < kNl; ++i) t[i] = wadd(a[i], b[i]);
  semi_round<kNl, true>(t);
#pragma unroll
  for (int i = 0; i < kNl; ++i) o[i] = t[i];
}

__device__ __forceinline__ void sub_mod(int* o, const int* a, const int* b) {
  int t[kNl];
#pragma unroll
  for (int i = 0; i < kNl; ++i) t[i] = wsub(a[i], b[i]);
  semi_round<kNl, true>(t);
#pragma unroll
  for (int i = 0; i < kNl; ++i) o[i] = t[i];
}

// o = a doubled `times` times by add_mod(a, a)
__device__ __forceinline__ void dbl(int* o, const int* a, int times = 1) {
  add_mod(o, a, a);
  for (int r = 1; r < times; ++r) add_mod(o, o, o);
}

// (a - b == 0 mod q) for relaxed reps (fq_mont.eq_mod_q)
__device__ __noinline__ bool eq_mod_q(const int* a, const int* b) {
  int z[kZcols];
  float est = 0.0f;
#pragma unroll
  for (int i = 0; i < kNl; ++i) z[i] = wsub(a[i], b[i]);
  z[kNl] = 0;
  z[kNl + 1] = 0;
  {
    int d[kNl];
#pragma unroll
    for (int i = 0; i < kNl; ++i) d[i] = z[i];
    semi_round<kNl, true>(d);  // sub_mod(a, b)
#pragma unroll
    for (int i = 0; i < kNl; ++i) {
      z[i] = d[i];
      est = __fadd_rn(est, __fmul_rn(static_cast<float>(d[i]), c_alpha_w[i]));
    }
  }
  const int alpha = static_cast<int>(rintf(est));
#pragma unroll
  for (int i = 0; i < kNl; ++i) z[i] = wsub(z[i], wmul(alpha, c_q[i]));
  semi3<kZcols, true>(z);
  bool zero = true;
#pragma unroll 6
  for (int p = 0; p < kPrimes; ++p) {
    int r = 0;
#pragma unroll
    for (int i = 0; i < kZcols; ++i) r = wadd(r, wmul(z[i], c_crt_w[i * kPrimes + p]));
    const int kq =
        wmul(static_cast<int>(rintf(__fmul_rn(static_cast<float>(r), c_crt_r[p]))), c_crt_p[p]);
    zero = zero && (r == kq);
  }
  return zero;
}

__device__ __forceinline__ void load(int* v, const int* __restrict__ src, size_t i, size_t m) {
#pragma unroll
  for (int l = 0; l < kNl; ++l) v[l] = src[l * m + i];
}

__device__ __forceinline__ void store(int* __restrict__ dst, const int* v, size_t i, size_t m) {
#pragma unroll
  for (int l = 0; l < kNl; ++l) dst[l * m + i] = v[l];
}

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                int m, int depth) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  int x[kNl], y[kNl];
  load(x, a, i, m);
  load(y, b, i, m);
  for (int d = 0; d < depth; ++d) mont_mul(x, x, y);
  store(out, x, i, m);
}

// dbl-2007-bl on (X, Y, Z): the tangent path of tpu_msm.point_double
__device__ void point_double(int* X3, int* Y3, int* Z3, const int* X, const int* Y,
                             const int* Z, bool z_is_one) {
  int A[kNl], B[kNl], C[kNl], t[kNl], D[kNl], E[kNl];
  mont_mul(A, X, X);
  mont_mul(B, Y, Y);
  mont_mul(C, B, B);
  add_mod(t, X, B);
  mont_mul(t, t, t);
  sub_mod(t, t, A);
  sub_mod(t, t, C);
  dbl(D, t);
  dbl(E, A);
  add_mod(E, E, A);
  mont_mul(t, E, E);  // F
  dbl(B, D);
  sub_mod(X3, t, B);  // Xd = F - 2D
  sub_mod(t, D, X3);
  mont_mul(t, E, t);
  dbl(B, C, 3);
  sub_mod(Y3, t, B);  // Yd = E (D - Xd) - 8C
  if (z_is_one) {
    dbl(Z3, Y);  // Zd = 2 Y (Z = one, the affine kernel)
  } else {
    mont_mul(t, Y, Z);
    dbl(Z3, t);  // Zd = 2 Y Z
  }
}

// the chord path of tpu_msm.point_add from U1, U2, S1, S2 and ZZ = Z1 Z2
// (or ZZ == nullptr for the affine kernel, where Z3 = 2 H)
__device__ void point_chord(int* X3, int* Y3, int* Z3, const int* U1, const int* U2,
                            const int* S1, const int* S2, const int* ZZ) {
  int H[kNl], I[kNl], J[kNl], rr[kNl], V[kNl], t[kNl];
  sub_mod(H, U2, U1);
  dbl(t, H);
  mont_mul(I, t, t);
  mont_mul(J, H, I);
  sub_mod(t, S2, S1);
  dbl(rr, t);
  mont_mul(V, U1, I);
  mont_mul(t, rr, rr);
  sub_mod(t, t, J);
  dbl(X3, V);
  sub_mod(X3, t, X3);  // X3 = rr^2 - J - 2V
  sub_mod(t, V, X3);
  mont_mul(t, rr, t);
  mont_mul(V, S1, J);
  dbl(V, V);
  sub_mod(Y3, t, V);  // Y3 = rr (V - X3) - 2 S1 J
  if (ZZ == nullptr) {
    dbl(Z3, H);
  } else {
    mont_mul(t, ZZ, H);
    dbl(Z3, t);  // Z3 = 2 Z1 Z2 H
  }
}

__global__ void __launch_bounds__(kThreads)
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
  int X1[kNl], Y1[kNl], Z1[kNl], X2[kNl], Y2[kNl], Z2[kNl];
  load(X1, x1, i, m);
  load(Y1, y1, i, m);
  load(Z1, z1, i, m);
  load(X2, x2, i, m);
  load(Y2, y2, i, m);
  load(Z2, z2, i, m);
  int Z1Z1[kNl], Z2Z2[kNl], U1[kNl], U2[kNl], S1[kNl], S2[kNl];
  mont_mul(Z1Z1, Z1, Z1);
  mont_mul(Z2Z2, Z2, Z2);
  mont_mul(U1, X1, Z2Z2);
  mont_mul(U2, X2, Z1Z1);
  mont_mul(S1, Y1, Z2);
  mont_mul(S1, S1, Z2Z2);
  mont_mul(S2, Y2, Z1);
  mont_mul(S2, S2, Z1Z1);
  const bool same_x = eq_mod_q(U1, U2);
  const bool same_y = eq_mod_q(S1, S2);
  int X3[kNl], Y3[kNl], Z3[kNl];
  if (same_x && same_y) {
    point_double(X3, Y3, Z3, X1, Y1, Z1, false);
  } else {
    mont_mul(Z1Z1, Z1, Z2);  // Z1 Z2
    point_chord(X3, Y3, Z3, U1, U2, S1, S2, Z1Z1);
  }
  store(x3, X3, i, m);
  store(y3, Y3, i, m);
  store(z3, Z3, i, m);
  i3[i] = same_x && !same_y;
}

__global__ void __launch_bounds__(kThreads)
point_add_aff_kernel(const int* __restrict__ x1, const int* __restrict__ y1,
                     const bool* __restrict__ i1, const int* __restrict__ x2,
                     const int* __restrict__ y2, const bool* __restrict__ i2,
                     int* __restrict__ x3, int* __restrict__ y3, int* __restrict__ z3,
                     bool* __restrict__ i3, int m) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(m)) return;
  const bool inf1 = i1[i], inf2 = i2[i];
  if (inf1 || inf2) {  // the other operand with Z = one
    const int* xs = inf1 ? x2 : x1;
    const int* ys = inf1 ? y2 : y1;
#pragma unroll
    for (int l = 0; l < kNl; ++l) {
      x3[l * m + i] = xs[l * m + i];
      y3[l * m + i] = ys[l * m + i];
      z3[l * m + i] = c_one[l];
    }
    i3[i] = inf1 && inf2;
    return;
  }
  int X1[kNl], Y1[kNl], X2[kNl], Y2[kNl];
  load(X1, x1, i, m);
  load(Y1, y1, i, m);
  load(X2, x2, i, m);
  load(Y2, y2, i, m);
  const bool same_x = eq_mod_q(X1, X2);
  const bool same_y = eq_mod_q(Y1, Y2);
  int X3[kNl], Y3[kNl], Z3[kNl];
  if (same_x && same_y) {
    point_double(X3, Y3, Z3, X1, Y1, nullptr, true);
  } else {
    point_chord(X3, Y3, Z3, X1, X2, Y1, Y2, nullptr);
  }
  store(x3, X3, i, m);
  store(y3, Y3, i, m);
  store(z3, Z3, i, m);
  i3[i] = same_x && !same_y;
}

unsigned blocks_for(int m) { return static_cast<unsigned>((m + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Copies the constant tables (host pointers) into __constant__ memory of
// the current device; returns the CUDA error code.
int fq_load_constants(const int* q, const int* mu, const float* carry_w, const float* alpha_w,
                      const int* crt_w, const int* crt_p, const float* crt_r, const int* one) {
  cudaError_t e = cudaSuccess;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_q, q, sizeof(c_q));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_mu, mu, sizeof(c_mu));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_carry_w, carry_w, sizeof(c_carry_w));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_alpha_w, alpha_w, sizeof(c_alpha_w));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_crt_w, crt_w, sizeof(c_crt_w));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_crt_p, crt_p, sizeof(c_crt_p));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_crt_r, crt_r, sizeof(c_crt_r));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_one, one, sizeof(c_one));
  return static_cast<int>(e);
}

// Each launcher runs on the given stream and returns cudaGetLastError().
int mont_mul_launch(const int* a, const int* b, int* out, int m, int depth, void* stream) {
  if (m <= 0 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  mont_mul_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, m, depth);
  return static_cast<int>(cudaGetLastError());
}

int point_add_launch(const int* x1, const int* y1, const int* z1, const bool* i1,
                     const int* x2, const int* y2, const int* z2, const bool* i2, int* x3,
                     int* y3, int* z3, bool* i3, int m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  point_add_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, i1, x2, y2, z2, i2, x3, y3, z3, i3, m);
  return static_cast<int>(cudaGetLastError());
}

int point_add_aff_launch(const int* x1, const int* y1, const bool* i1, const int* x2,
                         const int* y2, const bool* i2, int* x3, int* y3, int* z3, bool* i3,
                         int m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  point_add_aff_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, i1, x2, y2, i2, x3, y3, z3, i3, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
