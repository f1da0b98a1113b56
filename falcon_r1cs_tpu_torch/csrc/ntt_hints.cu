// Bound-tracked NTT hint kernels for Hopper (sm_90a), plain C entry points
// loaded with ctypes by falcon_r1cs_tpu_torch/ops/_build.py.
//
// ntt_hints_kernel (K1) replaces the Pallas TPU kernel
//   falcon_r1cs_tpu/ops/pallas_ntt.py::_make_kernel
// intt_ntt_hints_kernel (K2) replaces
//   falcon_r1cs_tpu/ops/pallas_ntt.py::_make_kernel_vchain
// add_one_kernel replaces the capability probe
//   falcon_r1cs_tpu/ops/pallas_support.py::pallas_available
// and is the build's self-test.
//
// What they compute, per batch row of n coefficients in [0, q): the
// bound-tracked forward NTT over exact integers (every value stays below
// 2^164).  Stage l pairs j with j + half inside each group, v = x[j+half] s
// with s = ntt_table[2^l + group], and writes u + v to the lo slot and
// (u + c) - v to the hi slot, c = const_q_powers[l + 1] the stage bound.
// Then the exact divmod by q, from the top 16 bits down, gives the
// quotient hint t = floor(V / q) as 11 limbs of 16 bits (11, B, n) and b =
// V mod q (B, n).  K2 first computes v = INTT(w) of its row (lazy in [0,
// 2q), 16-bit Montgomery products against 2^16-premultiplied inverse
// roots), writes v and runs K1's sweep on it.  Each value is an exact
// integer, so the outputs equal the plain versions (ops/ntt_limb.py
// ntt_with_hints, intt_with_hints) bit for bit whatever form holds them.
//
// What bounds them on an H100: bytes.  A row reads n int32 and writes 12 n
// (K2: 13 n), 52 MB at B = n = 1024.  The arithmetic is 5 aw - 1 word
// operations a butterfly pair in a stage of aw active words (35 word steps
// a pair at n = 1024) and ~4 a 16-bit divmod step: 1,544 SASS
// instructions a thread for K1 at n = 1024, 2,112 for K2 (counted by
// ops/tune_ntt_hints.py).
//
// What the design does about it (one CTA a row, n / 8 threads):
// - registers between stages: a thread owns kPer = 8 coefficients, each as
//   kWords = 6 words of 32 bits, and runs the stages in phases of up to
//   three.  A phase whose narrowest pair distance is H owns j = own<H>(t) +
//   k H, k < 8, so each of its stages pairs two registers of the thread;
// - shared memory only to exchange: between phases only the active words
//   change hands, in word planes u32 [aw][n] with a bank swizzle (`swz`)
//   that keeps every phase's warp accesses free of conflicts.  Two regions
//   take the exchanges in turn, so one __syncthreads() an exchange is the
//   only barrier: 3 for K1 at n = 1024, 2 at n = 512 (K2: 6 and 4);
// - the butterfly runs PTX carry chains on the active words only (a
//   compile-time schedule, `kActiveWords`): v = b s is a mul.lo / mad.hi
//   chain by the 14-bit root, u + v an add chain, (u + c) - v an add chain
//   then a sub chain; no mask, no shift;
// - the divmod takes 11 steps of 16 bits from the words, each quotient an
//   exact multiply-high by a magic constant; the last phase owns 8
//   consecutive j, so t and b leave as int4 pairs.  x enters coalesced over
//   j (the first phase owns j = t + k n / 8);
// - K2's INTT runs the same phases in reverse (level log_n - 1 first, one
//   word a coefficient); its last phase owns the forward's first phase's
//   coefficients, so v passes to the sweep in registers.
//
// Integer bounds (unsigned 32-bit arithmetic throughout): the value
// entering stage l and the stage's intermediates fit its aw_l words (the
// host's 16-bit schedule counts two bits of headroom; aw_l = ceil(act_l /
// 2)), and v < c, so no chain carries or borrows out of its top word; the
// divmod numerator r 2^16 + limb < q 2^16 < 2^30.  The INTT keeps [0, 2q):
// (u - v + 2q) s' < 4 q^2 < 2^29.2, p + m q < 2^30.5.  No float.

#include <cstdint>

#include <cuda_runtime.h>

#include "carry_chain.cuh"  // the PTX carry-chain steps
#include "div_q.cuh"        // kQ, div_q

namespace {

constexpr int kLimbs = 11;      // 16-bit limbs of the quotient hint t
constexpr int kWords = 6;       // 32-bit words of a coefficient
constexpr int kPer = 8;         // coefficients a thread owns
constexpr int kMaxLogN = 10;
constexpr int kXchgWords = 5;   // the widest exchange, after stage 8

// Words of a coefficient in stage l: ceil(act_l / 2) of the host's 16-bit
// active-limb schedule (ops/cuda_ntt._active_limbs).  It depends on l
// alone, so one table serves log_n = 9 and 10.  The words above stay zero.
constexpr int kActiveWords[kMaxLogN] = {1, 2, 2, 3, 3, 4, 4, 5, 5, 6};

__host__ __device__ constexpr int active_words(int l) { return kActiveWords[l]; }

// -q^-1 mod 2^16, the INTT's Montgomery factor
constexpr u32 kQInv16 = 12287u;
// bank swizzle: bits 5, 6 and 7 of j flip these bank bits
constexpr int kSwz5 = 0x02;
constexpr int kSwz6 = 0x09;
constexpr int kSwz7 = 0x14;

// p < 2^30.5 -> p 2^-16 mod q in [0, 2q): m = p (-q^-1) mod 2^16 makes
// p + m q a multiple of 2^16
__device__ __forceinline__ u32 mont16(u32 p) {
  const u32 m = (p * kQInv16) & 0xFFFFu;
  return (p + m * kQ) >> 16;
}

// The first of the kPer coefficients that thread t owns in a phase whose
// narrowest pair distance is H: it owns j = own<H>(t) + k H, k < kPer.
template <int H>
__device__ __forceinline__ int own(int t) {
  return (t / H) * (kPer * H) + t % H;
}

// The ownership of the INTT phase whose top level is lh: its narrowest pair
// distance, but at most n / kPer (the forward's first phase's).
__host__ __device__ constexpr int inv_own(int n, int lh) {
  return (n >> (lh + 1)) < n / kPer ? (n >> (lh + 1)) : n / kPer;
}

// The slot of coefficient j in an exchange plane.  For every ownership the
// phases use (H = 1, 2, 8, 16 and H >= 32) the 32 lanes of a warp hit 32
// distinct banks for each k.  swz is linear over XOR: swz(a ^ b) = swz(a) ^
// swz(b).
__device__ __forceinline__ int swz(int j) {
  return j ^ (((j >> 5) & 1) * kSwz5) ^ (((j >> 6) & 1) * kSwz6) ^ (((j >> 7) & 1) * kSwz7);
}

// d = a + b over the low AW words; d may be a or b
template <int AW>
__device__ __forceinline__ void add_words(u32 (&d)[kWords], const u32 (&a)[kWords],
                                          const u32 (&b)[kWords]) {
  if constexpr (AW == 1) {
    d[0] = a[0] + b[0];
  } else {
    add_cc(d[0], a[0], b[0]);
#pragma unroll
    for (int w = 1; w < AW - 1; ++w) addc_cc(d[w], a[w], b[w]);
    addc(d[AW - 1], a[AW - 1], b[AW - 1]);
  }
}

// d = a - b over the low AW words (a >= b); d may be a or b
template <int AW>
__device__ __forceinline__ void sub_words(u32 (&d)[kWords], const u32 (&a)[kWords],
                                          const u32 (&b)[kWords]) {
  if constexpr (AW == 1) {
    d[0] = a[0] - b[0];
  } else {
    sub_cc(d[0], a[0], b[0]);
#pragma unroll
    for (int w = 1; w < AW - 1; ++w) subc_cc(d[w], a[w], b[w]);
    subc(d[AW - 1], a[AW - 1], b[AW - 1]);
  }
}

// v = b s over the low AW words: the low halves, then the high halves added
// one word up in one chain (s < 2^14; the product fits AW words)
template <int AW>
__device__ __forceinline__ void mul_word(u32 (&v)[kWords], const u32 (&b)[kWords], u32 s) {
#pragma unroll
  for (int w = 0; w < AW; ++w) v[w] = b[w] * s;
  if constexpr (AW == 2) {
    v[1] += __umulhi(b[0], s);
  } else if constexpr (AW > 2) {
    mad_hi_cc(v[1], b[0], s, v[1]);
#pragma unroll
    for (int w = 1; w < AW - 2; ++w) madc_hi_cc(v[w + 1], b[w], s, v[w + 1]);
    madc_hi(v[AW - 1], b[AW - 2], s, v[AW - 1]);
  }
}

// (a, b) <- (a + b s, (a + c) - b s)
template <int AW>
__device__ __forceinline__ void butterfly(u32 (&a)[kWords], u32 (&b)[kWords], u32 s,
                                          const u32 (&c)[kWords]) {
  u32 v[kWords], e[kWords];
  mul_word<AW>(v, b, s);
  add_words<AW>(e, a, c);
  add_words<AW>(a, a, v);
  sub_words<AW>(b, e, v);
}

// Forward stage L on the coefficients j = base + k H: pair p joins
// registers k and k + D, D = half / H.  base = own<H>(t) and k H share no
// bit, so the root of j, ntt_table[2^L + (j >> (log_n - L))], sits at
// (base >> (log_n - L)) plus a constant offset for each pair.
template <int LOG_N, int H, int L>
__device__ __forceinline__ void fwd_stage(u32 (&x)[kPer][kWords], int base,
                                          const int* __restrict__ roots,
                                          const u32* __restrict__ bounds) {
  constexpr int D = ((1 << LOG_N) >> (L + 1)) / H;
  constexpr int AW = active_words(L);
  u32 c[kWords];
#pragma unroll
  for (int w = 0; w < AW; ++w) c[w] = __ldg(bounds + (L + 1) * kWords + w);
  const int* r = roots + (base >> (LOG_N - L));
#pragma unroll
  for (int p = 0; p < kPer / 2; ++p) {
    const int k = (p / D) * 2 * D + p % D;
    const u32 s = static_cast<u32>(__ldg(r + (1 << L) + ((k * H) >> (LOG_N - L))));
    butterfly<AW>(x[k], x[k + D], s, c);
  }
}

template <int LOG_N, int H, int L, int L1>
__device__ __forceinline__ void fwd_stages(u32 (&x)[kPer][kWords], int base,
                                           const int* __restrict__ roots,
                                           const u32* __restrict__ bounds) {
  if constexpr (L < L1) {
    fwd_stage<LOG_N, H, L>(x, base, roots, bounds);
    fwd_stages<LOG_N, H, L + 1, L1>(x, base, roots, bounds);
  }
}

// The low AW words of every coefficient move from the ownership HFrom to
// HTo through one region of shared memory: planes u32 [AW][n], swizzled.
// own<H>(t) and k H share no bit, so the slot of coefficient k is
// swz(own<H>(t)) ^ swz(k H), the second a constant.
template <int LOG_N, int HFrom, int HTo, int AW>
__device__ __forceinline__ void exchange(u32 (&x)[kPer][kWords], u32* __restrict__ plane,
                                         int t) {
  constexpr int N = 1 << LOG_N;
  const int from = swz(own<HFrom>(t)), to = swz(own<HTo>(t));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = from ^ swz(k * HFrom);
#pragma unroll
    for (int w = 0; w < AW; ++w) plane[w * N + j] = x[k][w];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = to ^ swz(k * HTo);
#pragma unroll
    for (int w = 0; w < AW; ++w) x[k][w] = plane[w * N + j];
  }
}

// Forward stages [L0, log_n) in phases of up to three; the phase [L0, L1)
// owns H = n >> L1, its narrowest pair distance.  X counts the exchanges
// before it; exchange X uses region X & 1 of sh.
template <int LOG_N, int L0, int X>
__device__ __forceinline__ void fwd_phases(u32 (&x)[kPer][kWords], u32* sh, int t,
                                           const int* __restrict__ roots,
                                           const u32* __restrict__ bounds) {
  constexpr int N = 1 << LOG_N;
  constexpr int L1 = L0 + 3 < LOG_N ? L0 + 3 : LOG_N;
  constexpr int H = N >> L1;
  fwd_stages<LOG_N, H, L0, L1>(x, own<H>(t), roots, bounds);
  if constexpr (L1 < LOG_N) {
    constexpr int L2 = L1 + 3 < LOG_N ? L1 + 3 : LOG_N;
    exchange<LOG_N, H, (N >> L2), active_words(L1 - 1)>(x, sh + (X & 1) * kXchgWords * N, t);
    fwd_phases<LOG_N, L1, X + 1>(x, sh, t, roots, bounds);
  }
}

// INTT level L on word 0 of the coefficients j = base + k H, lazy in
// [0, 2q): the sum folds by one conditional 2q subtract, the difference
// goes through the Montgomery step against the 2^16-premultiplied root
template <int LOG_N, int H, int L>
__device__ __forceinline__ void inv_level(u32 (&x)[kPer][kWords], int base,
                                          const int* __restrict__ inv_roots) {
  constexpr int D = ((1 << LOG_N) >> (L + 1)) / H;
  const int* r = inv_roots + (base >> (LOG_N - L));  // as in fwd_stage
#pragma unroll
  for (int p = 0; p < kPer / 2; ++p) {
    const int k = (p / D) * 2 * D + p % D;
    const u32 s = static_cast<u32>(__ldg(r + (1 << L) + ((k * H) >> (LOG_N - L))));
    const u32 u = x[k][0], v = x[k + D][0];
    u32 sum = u + v;
    if (sum >= 2 * kQ) sum -= 2 * kQ;
    x[k][0] = sum;
    x[k + D][0] = mont16((u - v + 2 * kQ) * s);
  }
}

template <int LOG_N, int H, int L, int LL>
__device__ __forceinline__ void inv_levels(u32 (&x)[kPer][kWords], int base,
                                           const int* __restrict__ inv_roots) {
  if constexpr (L >= LL) {
    inv_level<LOG_N, H, L>(x, base, inv_roots);
    inv_levels<LOG_N, H, L - 1, LL>(x, base, inv_roots);
  }
}

// INTT levels LH, LH - 1, ..., 0 (intt_torch's order) in phases of up to
// three, one word a coefficient; the phase with top level LH owns
// inv_own(n, LH).  X as in fwd_phases.
template <int LOG_N, int LH, int X>
__device__ __forceinline__ void inv_phases(u32 (&x)[kPer][kWords], u32* sh, int t,
                                           const int* __restrict__ inv_roots) {
  constexpr int N = 1 << LOG_N;
  constexpr int LL = LH > 2 ? LH - 2 : 0;
  constexpr int H = inv_own(N, LH);
  inv_levels<LOG_N, H, LH, LL>(x, own<H>(t), inv_roots);
  if constexpr (LL > 0) {
    exchange<LOG_N, H, inv_own(N, LL - 1), 1>(x, sh + (X & 1) * kXchgWords * N, t);
    inv_phases<LOG_N, LL - 1, X + 1>(x, sh, t, inv_roots);
  }
}

// The divmod by q of the thread's 8 consecutive coefficients (the last
// forward phase owns j = 8 t + k): limb k of the value is the half k & 1 of
// word k >> 1; t's limb k and then b leave as two int4 each
template <int LOG_N>
__device__ __forceinline__ void divmod_store(const u32 (&x)[kPer][kWords],
                                             int* __restrict__ t_out, int* __restrict__ b_out,
                                             int row, int batch, int t) {
  constexpr int N = 1 << LOG_N;
  const int col = own<1>(t);
  u32 r[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) r[e] = 0;
#pragma unroll
  for (int k = kLimbs - 1; k >= 0; --k) {
    u32 d[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const u32 w = x[e][k >> 1];
      // cur = r 2^16 + limb k (r < q < 2^14)
      const u32 cur = (k & 1) ? __funnelshift_r(w, r[e], 16) : __byte_perm(w, r[e], 0x5410);
      d[e] = div_q(cur);
      r[e] = cur - d[e] * kQ;
    }
    int4* dst = reinterpret_cast<int4*>(t_out + (static_cast<size_t>(k) * batch + row) * N + col);
    dst[0] = make_int4(static_cast<int>(d[0]), static_cast<int>(d[1]), static_cast<int>(d[2]),
                       static_cast<int>(d[3]));
    dst[1] = make_int4(static_cast<int>(d[4]), static_cast<int>(d[5]), static_cast<int>(d[6]),
                       static_cast<int>(d[7]));
  }
  int4* dst = reinterpret_cast<int4*>(b_out + static_cast<size_t>(row) * N + col);
  dst[0] = make_int4(static_cast<int>(r[0]), static_cast<int>(r[1]), static_cast<int>(r[2]),
                     static_cast<int>(r[3]));
  dst[1] = make_int4(static_cast<int>(r[4]), static_cast<int>(r[5]), static_cast<int>(r[6]),
                     static_cast<int>(r[7]));
}

template <int LOG_N>
__global__ void __launch_bounds__((1 << LOG_N) / kPer)
ntt_hints_kernel(const int* __restrict__ x_in, const int* __restrict__ roots,
                 const u32* __restrict__ bounds, int* __restrict__ t_out,
                 int* __restrict__ b_out, int batch) {
  constexpr int N = 1 << LOG_N;
  __shared__ u32 sh[2 * kXchgWords * N];
  const int row = blockIdx.x, t = threadIdx.x;
  u32 x[kPer][kWords];
  // the first phase owns j = t + k n / 8: a coalesced warp row for each k
  const int* src = x_in + static_cast<size_t>(row) * N + t;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    x[k][0] = static_cast<u32>(__ldg(src + k * (N / kPer)));
#pragma unroll
    for (int w = 1; w < kWords; ++w) x[k][w] = 0;
  }
  fwd_phases<LOG_N, 0, 0>(x, sh, t, roots, bounds);
  divmod_store<LOG_N>(x, t_out, b_out, row, batch, t);
}

template <int LOG_N>
__global__ void __launch_bounds__((1 << LOG_N) / kPer)
intt_ntt_hints_kernel(const int* __restrict__ w_in, const int* __restrict__ roots,
                      const int* __restrict__ inv_roots, const u32* __restrict__ bounds,
                      int* __restrict__ t_out, int* __restrict__ b_out,
                      int* __restrict__ v_out, int batch) {
  constexpr int N = 1 << LOG_N;
  // the INTT's exchanges; the forward's go on from there
  constexpr int kInvXchg = (LOG_N + 2) / 3 - 1;
  // n^-1 mod q (n divides q - 1 = 3 * 2^12), times 2^16 mod q
  constexpr u32 kNInvMont = ((kQ - (kQ - 1) / N) << 16) % kQ;
  __shared__ u32 sh[2 * kXchgWords * N];
  const int row = blockIdx.x, t = threadIdx.x;
  u32 x[kPer][kWords];
  // the INTT's first phase owns 8 consecutive j: two int4 loads
  const int4* src = reinterpret_cast<const int4*>(w_in + static_cast<size_t>(row) * N) + 2 * t;
  const int4 lo = __ldg(src), hi = __ldg(src + 1);
  const int w8[kPer] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    x[k][0] = static_cast<u32>(w8[k]);
#pragma unroll
    for (int w = 1; w < kWords; ++w) x[k][w] = 0;
  }
  inv_phases<LOG_N, LOG_N - 1, 0>(x, sh, t, inv_roots);
  // n^-1 scale and canonical v in [0, q); the last INTT phase owns j = t +
  // k n / 8, the forward's first phase's coefficients
  int* dst = v_out + static_cast<size_t>(row) * N + t;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    u32 y = mont16(x[k][0] * kNInvMont);
    if (y >= kQ) y -= kQ;
    x[k][0] = y;
    dst[k * (N / kPer)] = static_cast<int>(y);
  }
  fwd_phases<LOG_N, 0, kInvXchg>(x, sh, t, roots, bounds);
  divmod_store<LOG_N>(x, t_out, b_out, row, batch, t);
}

__global__ void add_one_kernel(const int* __restrict__ x,
                               int* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = x[i] + 1;
}

}  // namespace

extern "C" {

// Each entry launches on the given stream and returns cudaGetLastError().
// bounds: the (log_n + 1, 6) words of the stage bounds; roots, inv_roots:
// the (n,) forward roots and the 2^16-premultiplied inverse roots.

int ntt_hints_launch(const int* x, const int* roots, const void* bounds, int* t_out,
                     int* b_out, int batch, int log_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const u32* bw = static_cast<const u32*>(bounds);
  if (log_n == 10) {
    ntt_hints_kernel<10><<<batch, (1 << 10) / kPer, 0, s>>>(x, roots, bw, t_out, b_out, batch);
  } else if (log_n == 9) {
    ntt_hints_kernel<9><<<batch, (1 << 9) / kPer, 0, s>>>(x, roots, bw, t_out, b_out, batch);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int intt_ntt_hints_launch(const int* w, const int* roots, const int* inv_roots,
                          const void* bounds, int* t_out, int* b_out, int* v_out, int batch,
                          int log_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const u32* bw = static_cast<const u32*>(bounds);
  if (log_n == 10) {
    intt_ntt_hints_kernel<10><<<batch, (1 << 10) / kPer, 0, s>>>(w, roots, inv_roots, bw, t_out,
                                                                 b_out, v_out, batch);
  } else if (log_n == 9) {
    intt_ntt_hints_kernel<9><<<batch, (1 << 9) / kPer, 0, s>>>(w, roots, inv_roots, bw, t_out,
                                                               b_out, v_out, batch);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int add_one_launch(const int* x, int* out, int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  add_one_kernel<<<(count + 255) / 256, 256, 0, s>>>(x, out, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
