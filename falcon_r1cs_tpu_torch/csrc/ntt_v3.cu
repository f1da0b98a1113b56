// Semi-carry limb NTT kernel for Hopper (sm_90a), plain C entry points
// loaded with ctypes by falcon_r1cs_tpu_torch/ops/_build.py.
//
// ntt_semi_kernel replaces the Pallas TPU kernel
//   tools/pallas_ntt_v3.py::kernel (built by _build, entry
//   ntt_with_hints_pallas_v3)
// and, with its hints epilogue, that whole entry: the kernel and the exact
// normalisation and divmod by q that run after it in XLA.
//
// What it computes, per batch row of n coefficients in [0, q): the
// bound-tracked forward NTT of ntt_hints.cu, over L = 12 redundant 16-bit
// limbs.  Stage l pairs j with j + half inside each group, s = tw[l][j],
// c = the limbs of the stage bound 2^l * q^(l+2), and runs exactly three
// carry rounds:
//   v   = semi(hi * s)
//   lo' = semi(u + v)
//   hi' = semi(u + (c - v))
// where semi is ONE parallel carry round over the limb axis,
//   semi(x)_k = (x_k & 0xFFFF) + (x_{k-1} >> 16),  x_{-1} = 0,
// the carry out of the top limb dropped.  Every limb's incoming carry
// comes from the values before the round, so the state equals the plain
// version (ops/ntt_limb.ntt_semi) limb by limb, not only in value.  One
// template, two epilogues:
// - semi (ntt_semi_launch): the semi state (12, B, n), as the TPU kernel;
// - hints (ntt_semi_hints_launch): each coefficient's 12 limbs normalised
//   by a sequential carry chain (limbs.normalize), then divided by q from
//   the top limb down with the multiply-high div_q of div_q.cuh
//   (limbs.divmod_q): t (11, B, n) and b (B, n), the outputs of
//   ntt_limb.ntt_with_hints and of K1.  Limb 11 of the normalised value is
//   zero (every value is below 2^164), so t's limb 11 is not stored.
//
// What bounds it on an H100: its integer instructions, level with its
// bytes.  Per live limb of a butterfly pair and stage the definition does
// one multiply, three rounds of mask, shift and add, and u + v, c - v, u +
// (c - v): 13 operations, which Hopper issues as about 9 instructions (the
// multiply; u + v and u + (c - v) one three-input add each; a round a mask
// and one shift-and-add).  The masks and shift-and-adds (LOP3, LEA) run on
// the integer ALU pipe alone, 64 lanes a clock an SM, while the multiply
// and some adds issue as IMAD on the FMA pipe beside it.  chip_smoke.py
// counts the bound from the compiled kernel's own SASS, pipe by pipe; at
// n = B = 1024 its ALU instructions take about as long as reading x and
// writing 12 n limbs.
//
// What the design does about it (one CTA a row, n / 4 threads):
// - registers across phases: a thread owns kPer = 4 coefficients of 12
//   int32 limbs (a limb spans about [-3, 2^16 + 2], so 16 bits do not hold
//   it) and runs the stages in phases of two.  A phase whose narrowest pair
//   distance is H owns j = own<H>(t) + k H, k < 4, so every pair of a stage
//   joins two registers of one thread and a phase touches no shared
//   memory.  Eight coefficients a thread in phases of three (ntt_hints.cu's
//   layout) took 128 registers with a spill and ran slower at both n
//   (ops/tune_ntt_v3.py); four take ~76 registers, 24 warps an SM;
// - the trim: after stage l only the low kLiveLimbs[l] limbs can be
//   non-zero, a sound interval bound (ops/ntt_v3.live_limbs, recomputed
//   by tests/test_torch_ntt_semi_words.py): 81 of the 120 limb-stages at
//   n = 1024, 69 of 108 at n = 512.  A stage computes only its live limbs;
//   limb k of a round reads limbs k and k - 1 alone, so the live limbs are
//   exact and the limbs above stay the zeros they started as;
// - shared memory only to exchange: between phases the live limbs change
//   hands through int32 planes [W][n] swizzled by swz, one region of at
//   most 12 planes (48 KB at n = 1024: the static limit), a barrier before
//   each exchange's writes but the first and one after them: 7 barriers at
//   both n, against 10 and 9 stage barriers before;
// - coalesced edges: the first phase owns j = t + k n / 4, a warp row of x
//   for each k; the last owns 4 consecutive j, so every limb plane of the
//   state, every limb of t and b leave as one int4 store a thread.
//
// Integer bounds: for inputs in [0, q), the domain on which the trim is
// proved, the interval bound keeps every product, sum and limb below 2^30
// in magnitude (|limb * s| < 2^31 for s < q < 2^14), and the kernel equals
// the plain version's int32 arithmetic bit for bit.  Outside [0, q) a limb
// the trim calls dead may not be zero, so the kernel may differ from
// ntt_semi there; no wrapper checks the range.  Every add, subtract and
// multiply wraps through unsigned helpers (signed overflow is undefined in
// CUDA C++); >> of a negative limb is one arithmetic-shift helper, as
// torch's >> is.  The divmod's numerator r 2^16 + limb < q 2^16 < 2^30.
// No float.

#include <cstdint>

#include <cuda_runtime.h>

#include "div_q.cuh"  // kQ, div_q

namespace {

constexpr int kSemiLimbs = 12;
constexpr int kHintLimbs = 11;   // t's limbs
constexpr int kLimbBits = 16;
constexpr int kLimbMask = 0xFFFF;
constexpr int kMaxLogN = 10;
constexpr int kPer = 4;          // coefficients a thread owns
constexpr int kPhaseStages = 2;  // stages a phase: log2(kPer)
// bank swizzle: bits 5 and 6 of j flip these bank bits
constexpr int kSwz5 = 0x0A;
constexpr int kSwz6 = 0x15;

// The limbs that can be non-zero after stage l (ops/ntt_v3.live_limbs: an
// interval bound through the multiply by the stage's twiddle range, the
// mask, the arithmetic shift and the adds).  It depends on l alone, so one
// table serves log_n = 9 and 10.  The input has one live limb.
constexpr int kLiveLimbs[kMaxLogN] = {2, 3, 4, 6, 8, 10, 12, 12, 12, 12};

__host__ __device__ constexpr int live_limbs(int l) { return kLiveLimbs[l]; }

// The planes of the widest exchange: the live limbs after the last stage
// of each phase but the last.
__host__ __device__ constexpr int xchg_limbs(int log_n) {
  int w = 0;
  for (int l1 = kPhaseStages; l1 < log_n; l1 += kPhaseStages)
    w = live_limbs(l1 - 1) > w ? live_limbs(l1 - 1) : w;
  return w;
}

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
// arithmetic shift right of a signed value (torch `>>` on int32)
__device__ __forceinline__ int asr(int x, int s) { return x >> s; }

// The first of the kPer coefficients that thread t owns in a phase whose
// narrowest pair distance is H: it owns j = own<H>(t) + k H, k < kPer.
template <int H>
__device__ __forceinline__ int own(int t) {
  return (t / H) * (kPer * H) + t % H;
}

// The slot of coefficient j in an exchange plane.  For every ownership the
// phases use (H = 1, 2, 4, ..., n / 4) the 32 lanes of a warp hit 32
// distinct banks for each k.  swz is linear over XOR: swz(a ^ b) = swz(a) ^
// swz(b).
__device__ __forceinline__ int swz(int j) {
  return j ^ (((j >> 5) & 1) * kSwz5) ^ (((j >> 6) & 1) * kSwz6);
}

// One parallel carry round in place over the low W limbs, top limb down:
// limb k reads limb k - 1 before it is rewritten, so every carry comes from
// the pre-round values.
template <int W>
__device__ __forceinline__ void semi(int (&x)[kSemiLimbs]) {
#pragma unroll
  for (int k = W - 1; k > 0; --k) x[k] = wadd(x[k] & kLimbMask, asr(x[k - 1], kLimbBits));
  x[0] &= kLimbMask;
}

// (a, b) <- (semi(a + v), semi(a + (c - v))), v = semi(b s), over the low
// W limbs
template <int W>
__device__ __forceinline__ void butterfly(int (&a)[kSemiLimbs], int (&b)[kSemiLimbs], int s,
                                          const int (&c)[kSemiLimbs]) {
  int v[kSemiLimbs];
#pragma unroll
  for (int k = 0; k < W; ++k) v[k] = wmul(b[k], s);
  semi<W>(v);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    b[k] = wadd(a[k], wsub(c[k], v[k]));
    a[k] = wadd(a[k], v[k]);
  }
  semi<W>(a);
  semi<W>(b);
}

// Stage L on the coefficients j = base + k H: pair p joins registers k and
// k + D, D = half / H; the twiddle of the pair is tw[L][j] of its low j.
template <int LOG_N, int H, int L>
__device__ __forceinline__ void stage(int (&x)[kPer][kSemiLimbs], int base,
                                      const int* __restrict__ tw,
                                      const int* __restrict__ bounds) {
  constexpr int D = ((1 << LOG_N) >> (L + 1)) / H;
  constexpr int W = live_limbs(L);
  int c[kSemiLimbs];
#pragma unroll
  for (int k = 0; k < W; ++k) c[k] = __ldg(bounds + (L + 1) * kSemiLimbs + k);
  const int* r = tw + L * (1 << LOG_N) + base;
#pragma unroll
  for (int p = 0; p < kPer / 2; ++p) {
    const int k = (p / D) * 2 * D + p % D;
    butterfly<W>(x[k], x[k + D], __ldg(r + k * H), c);
  }
}

template <int LOG_N, int H, int L, int L1>
__device__ __forceinline__ void stages(int (&x)[kPer][kSemiLimbs], int base,
                                       const int* __restrict__ tw,
                                       const int* __restrict__ bounds) {
  if constexpr (L < L1) {
    stage<LOG_N, H, L>(x, base, tw, bounds);
    stages<LOG_N, H, L + 1, L1>(x, base, tw, bounds);
  }
}

// The low W limbs of every coefficient move from the ownership HFrom to
// HTo through the region: planes int [W][n], swizzled.  The slot of
// coefficient k is swz(own<H>(t)) ^ swz(k H).  A barrier before the writes
// (but for the first exchange) lets every thread finish reading the last
// one; the barrier after them lets every write land.
template <int LOG_N, int HFrom, int HTo, int W, bool First>
__device__ __forceinline__ void exchange(int (&x)[kPer][kSemiLimbs], int* __restrict__ plane,
                                         int t) {
  constexpr int N = 1 << LOG_N;
  if constexpr (!First) __syncthreads();
  const int from = swz(own<HFrom>(t)), to = swz(own<HTo>(t));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = from ^ swz(k * HFrom);
#pragma unroll
    for (int w = 0; w < W; ++w) plane[w * N + j] = x[k][w];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = to ^ swz(k * HTo);
#pragma unroll
    for (int w = 0; w < W; ++w) x[k][w] = plane[w * N + j];
  }
}

// Stages [L0, log_n) in phases of kPhaseStages; the phase [L0, L1) owns H =
// n >> L1, its narrowest pair distance.
template <int LOG_N, int L0>
__device__ __forceinline__ void phases(int (&x)[kPer][kSemiLimbs], int* sh, int t,
                                       const int* __restrict__ tw,
                                       const int* __restrict__ bounds) {
  constexpr int N = 1 << LOG_N;
  constexpr int L1 = L0 + kPhaseStages < LOG_N ? L0 + kPhaseStages : LOG_N;
  constexpr int H = N >> L1;
  stages<LOG_N, H, L0, L1>(x, own<H>(t), tw, bounds);
  if constexpr (L1 < LOG_N) {
    constexpr int L2 = L1 + kPhaseStages < LOG_N ? L1 + kPhaseStages : LOG_N;
    exchange<LOG_N, H, (N >> L2), live_limbs(L1 - 1), L0 == 0>(x, sh, t);
    phases<LOG_N, L1>(x, sh, t, tw, bounds);
  }
}

// kPer consecutive values of the row as int4 stores (own<1>(t) = kPer t)
__device__ __forceinline__ void store_row(int* __restrict__ dst, const int (&v)[kPer]) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int e = 0; e < kPer; e += 4) d[e / 4] = make_int4(v[e], v[e + 1], v[e + 2], v[e + 3]);
}

// The semi epilogue: limb k of the thread's kPer consecutive coefficients
// to plane k of the state (12, B, n); the dead limbs store their zeros.
template <int LOG_N>
__device__ __forceinline__ void semi_store(const int (&x)[kPer][kSemiLimbs],
                                           int* __restrict__ out, int row, int batch, int t) {
  constexpr int N = 1 << LOG_N;
#pragma unroll
  for (int k = 0; k < kSemiLimbs; ++k) {
    int v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = x[e][k];
    store_row(out + (static_cast<size_t>(k) * batch + row) * N + own<1>(t), v);
  }
}

// The hints epilogue: normalise each coefficient's limbs by a sequential
// carry chain, then the base-2^16 long division by q from the top limb;
// t's limbs 0..10 and b leave as int4 stores.
template <int LOG_N>
__device__ __forceinline__ void hints_store(int (&x)[kPer][kSemiLimbs], int* __restrict__ t_out,
                                            int* __restrict__ b_out, int row, int batch, int t) {
  constexpr int N = 1 << LOG_N;
  const int col = own<1>(t);
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    int carry = 0;
#pragma unroll
    for (int k = 0; k < kSemiLimbs; ++k) {
      const int s = wadd(x[e][k], carry);
      x[e][k] = s & kLimbMask;
      carry = asr(s, kLimbBits);
    }
  }
  u32 r[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) r[e] = 0;
#pragma unroll
  for (int k = kSemiLimbs - 1; k >= 0; --k) {
    int d[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      // cur = r 2^16 + limb k (r < q < 2^14, the limb < 2^16)
      const u32 cur = (r[e] << kLimbBits) | static_cast<u32>(x[e][k]);
      const u32 quo = div_q(cur);
      r[e] = cur - quo * kQ;
      d[e] = static_cast<int>(quo);
    }
    if (k < kHintLimbs) store_row(t_out + (static_cast<size_t>(k) * batch + row) * N + col, d);
  }
  int b[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) b[e] = static_cast<int>(r[e]);
  store_row(b_out + static_cast<size_t>(row) * N + col, b);
}

// out: the state (12, B, n), or with Hints t (11, B, n) and b_out (B, n)
template <int LOG_N, bool Hints>
__global__ void __launch_bounds__((1 << LOG_N) / kPer)
ntt_semi_kernel(const int* __restrict__ x_in, const int* __restrict__ tw,
                const int* __restrict__ bounds, int* __restrict__ out,
                int* __restrict__ b_out, int batch) {
  constexpr int N = 1 << LOG_N;
  __shared__ int sh[xchg_limbs(LOG_N) * N];
  const int row = blockIdx.x, t = threadIdx.x;
  int x[kPer][kSemiLimbs];
  // the first phase owns j = t + k n / kPer: a coalesced warp row for each k
  const int* src = x_in + static_cast<size_t>(row) * N + t;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    x[k][0] = __ldg(src + k * (N / kPer));
#pragma unroll
    for (int w = 1; w < kSemiLimbs; ++w) x[k][w] = 0;
  }
  phases<LOG_N, 0>(x, sh, t, tw, bounds);
  if constexpr (Hints) {
    hints_store<LOG_N>(x, out, b_out, row, batch, t);
  } else {
    semi_store<LOG_N>(x, out, row, batch, t);
  }
}

template <bool Hints>
int launch(const int* x, const int* tw, const int* bounds, int* out, int* b_out, int batch,
           int log_n, cudaStream_t s) {
  if (log_n == 10) {
    ntt_semi_kernel<10, Hints><<<batch, (1 << 10) / kPer, 0, s>>>(x, tw, bounds, out, b_out,
                                                                  batch);
  } else if (log_n == 9) {
    ntt_semi_kernel<9, Hints><<<batch, (1 << 9) / kPer, 0, s>>>(x, tw, bounds, out, b_out,
                                                                batch);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on the given stream and returns cudaGetLastError().
// tw: the (log_n, n) per-position twiddles; bounds12: the (log_n + 1, 12)
// bound limbs.

int ntt_semi_launch(const int* x, const int* tw, const int* bounds12, int* semi_out, int batch,
                    int log_n, void* stream) {
  return launch<false>(x, tw, bounds12, semi_out, nullptr, batch, log_n,
                       static_cast<cudaStream_t>(stream));
}

int ntt_semi_hints_launch(const int* x, const int* tw, const int* bounds12, int* t_out,
                          int* b_out, int batch, int log_n, void* stream) {
  return launch<true>(x, tw, bounds12, t_out, b_out, batch, log_n,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
