// BLS12-381 Fr (the scalar field, r of 255 bits) on 32-bit words for
// Hopper (sm_90a): the Groth16 witness map's kernels, plain C entry points
// loaded with ctypes by falcon_r1cs_tpu_torch/ops/_build.py and wrapped by
// ops/fr.py; snark/gpu_qap.py chains them into h(X) = (a b - c) / Z.
//
// They replace no Pallas kernel: the JAX package computes the witness map
// on the host (falcon_r1cs_tpu/snark/native_backend.py witness_map, the C
// of native/groth16_native.c: fr_batch_to_mont, fr_spmv, fr_fft,
// fr_scale_powers, fr_quotient), and so did the port.  They were added to
// take that host work, the largest stage of a Falcon-512 proof, off the
// host and onto the card beside the G1 MSMs.
//
// Layout: every field vector is word planes, (8, n) uint32, word k of
// element i at k n + i, so the threads of a warp load and store
// neighbouring words.  Values are canonical ([0, r)) Montgomery forms
// x 2^256 mod r from entry (fr_to_mont_kernel, which also reduces any
// 256-bit input) until exit (fr_from_mont_kernel, which writes canonical
// standard u64 rows).
//
// Arithmetic: CIOS Montgomery products over 8 words with R' = 2^256 and
// n0' = -r^-1 mod 2^32 = 0xffffffff (r = 1 mod 2^32, so m = -t_0), the
// carries as PTX carry chains (carry_chain.cuh), as fq_mont.cu does over
// 12 words.  4r > 2^256, so nothing here is lazy: with a, b < r the CIOS
// sum t stays below 2r and t + a b_i + m r below 2^289 / 2 < 2^288 (nine
// words, no carry out of t[8]), and one conditional subtraction of r makes
// every product canonical; add and subtract correct once by r.  One
// product is 2 x 64 multiplies for a b and 8 x (1 + 16) for the
// reduction: 264 int32 multiplies (chip_smoke.py FR_MONT_MULS).  The
// reduction alone (`redc`, the exit's v 2^-256) is those 136: t = v < 2^256,
// and each round's t + m r < 2^256 + 2^32 r < 2^288 fits nine words, its
// shifted result below 2^224 + r < 2^256, so t[8] is 0 again; after 8
// rounds t = (v + M r) / 2^256 with M < 2^256, below r + 1, and one
// conditional subtraction of r makes it canonical for any v < 2^256.
//
// The kernels:
// - fr_to_mont_kernel: (n, 4) u64 rows -> planes, x mod r times R'^2 (one
//   product), one row a thread; in a warp whose rows stay below word 7 the
//   product takes x as the CIOS b operand and runs round i's a b_i chains
//   only where some lane has x.w[i] != 0 (z is mostly 0 and 1);
// - fr_from_mont_kernel: planes of n = 2^k -> (n, 4) u64 rows, the
//   Montgomery reduction alone, element i written at row bitrev(i), so the
//   last inverse transform, whose output is bit-reversed, needs no
//   permutation pass; a CTA a tile of 2^2s elements, the rows staged in
//   shared memory so that a warp's loads and stores each cover one span;
// - fr_spmv_kernel: out[row] = sum val z[col] over a CSR matrix whose rows
//   come binned by length (ops/fr.py spmv_order, once a circuit): the
//   long rows (A's of 1,026 to 2,075 entries at 2^18) one CTA each, its
//   256 threads a strided share of the row, summed by a warp shuffle tree
//   of Fr adds and then across the 8 warps in shared memory; every other
//   row of the n_out one thread a row, ordered by length from the longest
//   (A's short rows hold 1, 2, 4 or 15 entries; a warp of one length
//   wastes no lane on a longer neighbour): rows nrows .. nrows + ncopy - 1
//   take z[0 .. ncopy - 1] (the instance rows of A), empty rows and the
//   rest 0;
// - fr_ntt_tile_kernel: the transform's stages whose butterflies lie in a
//   tile of 2^log_t <= 1024 contiguous elements, over a batch of vectors:
//   DIT (bit-reversed in, the first stages), DIF (natural in, the last
//   stages, with an optional product by a table at the end: the coset
//   scale n^-1 g^{+-bitrev(i)}), or the round trip of the witness map, the
//   DIF stages over w^-1, the scale and the DIT stages over w in one pass
//   while the tile stays on the SM.  One CTA a tile of any vector of the
//   batch.  A thread holds 4 elements in registers and runs the stages in
//   phases of up to 2; shared memory (32 KB) only exchanges words between
//   phases, swizzled so that no warp access conflicts; the twiddle
//   prefixes tw[0 .. 2^log_t), the same for every tile, come through the
//   read-only cache;
// - fr_ntt_stage_kernel: one stage of span 2h >= 2 tiles over device
//   memory, one thread a butterfly;
// - fr_quotient_kernel: a = (a b - c) zinv elementwise, in place;
// - fr_powers_kernel: c base^e(i) for the tables (e(i) = bitrev(i), or
//   the stage twiddle exponent of index h + j: j n / 2h), from the
//   squares base^(2^k): one product an element, H(a) L(b), from two small
//   tables a CTA builds on chip; stage mode computes the top segment's n /
//   2 values and writes the lower segments as its strides.
// The transform is radix 2 with twiddle tables by stage, tw[h + j] =
// w^(j n / 2h) for the butterflies of span 2h, so a warp's twiddle loads
// coalesce: DIF takes natural order to bit-reversed, DIT bit-reversed to
// natural, and the witness map runs DIF (inverse) -> scale -> DIT
// (forward) -> quotient -> DIF (inverse) -> scale with no permutation.
//
// What bounds them on an H100: the int32 multiplies.  A Falcon-512 proof's
// witness map (domain 2^17, 846k nonzeros) is ~9.4 M products, 2.5 G
// multiplies at 132 x 64 x 1.98e9 a second: ~0.15 ms; its bytes (the CSR
// values 27 MB, z, two passes of 4.2 MB a global stage) ~0.05 ms at 3.35
// TB/s.  So every kernel is built to keep the multiply pipe fed: the sparse
// product gives no lane a row it does not need (each long row is many
// threads' work, the short ones run in warps of one length) and loads each
// product's operands while the one before it multiplies, and the tile
// keeps its elements in registers across the stages of a phase, with no
// barrier inside one, and enough warps an SM to cover the products'
// dependent latency.  At these sizes the 57 launches of a witness map at
// 2^17 (8 + 7 (k - 10)) and their dependences decide the rest: one launch
// a stage outside a tile is the simple form; stages merged into one column
// pass are the next step.

#include <cuda_runtime.h>

#include <cstdint>

#include "carry_chain.cuh"  // the PTX carry-chain steps

namespace {

constexpr int kW = 8;
constexpr int kThreads = 256;
constexpr int kSpmvThreads = 256;  // a long row's CTA: 4 products a thread at 1,027
constexpr int kTileLog = 10;
constexpr int kTile = 1 << kTileLog;
constexpr int kMaxLog = 32;  // rows of the squares table of fr_powers_kernel

// r = 0x73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001,
// its 32-bit words, least first
__constant__ u32 c_rw[kW] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
                             0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
// R'^2 mod r = 2^512 mod r: a product by it enters the Montgomery domain
__constant__ u32 c_r2w[kW] = {0xf3f29c6du, 0xc999e990u, 0x87925c23u, 0x2b6cedcbu,
                              0x7254398fu, 0x05d31496u, 0x9f59ff11u, 0x0748d9d9u};
// n0' = -r^-1 mod 2^32
constexpr u32 kRInv = 0xffffffffu;

struct Fr {
  u32 w[kW];
};

// t = (t + m r) / 2^32, m = t_0 n0': one round of the reduction, two carry
// chains, t += lo(m r), then t = (t + hi(m r) one word up) / 2^32 with the
// shift folded into the destinations.  t[8] is 0 on return.
__device__ __forceinline__ void reduce_round(u32 (&t)[kW + 1]) {
  const u32 m = t[0] * kRInv;
  mad_lo_cc(t[0], m, c_rw[0]);  // t[0] becomes 0
#pragma unroll
  for (int j = 1; j < kW; ++j) madc_lo_cc(t[j], m, c_rw[j]);
  addc_zero(t[kW]);
  mad_hi_cc(t[0], m, c_rw[0], t[1]);  // word j - 1 <- word j: the shift
#pragma unroll
  for (int j = 1; j < kW - 1; ++j) madc_hi_cc(t[j], m, c_rw[j], t[j + 1]);
  madc_hi(t[kW - 1], m, c_rw[kW - 1], t[kW]);
  t[kW] = 0;
}

// o = t[0 .. 8) - r unless that borrows
__device__ __forceinline__ void canonical(Fr& o, const u32 (&t)[kW + 1]) {
  u32 d[kW], borrow;
  sub_cc(d[0], t[0], c_rw[0]);
#pragma unroll
  for (int j = 1; j < kW; ++j) subc_cc(d[j], t[j], c_rw[j]);
  subc(borrow, 0u, 0u);  // 0xffffffff when t < r
#pragma unroll
  for (int j = 0; j < kW; ++j) o.w[j] = borrow ? t[j] : d[j];
}

// o = a b 2^-256 mod r, canonical: a, b < r -> o < r.  Per word b_i four
// carry chains: t += lo(a b_i), t += hi(a b_i) one word up, then the
// reduction round; t < 2r after each step, so t[8] is 0 there.  Then t - r
// unless that borrows.  o may alias a or b.  kSkipZero: round i's a b_i
// chains run only where some lane of the warp has b.w[i] != 0 (every lane
// must call it); where none has, they would add 0, so o is the same.
template <bool kSkipZero = false>
__device__ __forceinline__ void mont(Fr& o, const Fr& a, const Fr& b) {
  u32 t[kW + 1];
#pragma unroll
  for (int k = 0; k < kW + 1; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const u32 bi = b.w[i];
    if (!kSkipZero || __any_sync(0xffffffffu, bi != 0)) {
      mad_lo_cc(t[0], a.w[0], bi);
#pragma unroll
      for (int j = 1; j < kW; ++j) madc_lo_cc(t[j], a.w[j], bi);
      addc_zero(t[kW]);
      mad_hi_cc(t[1], a.w[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < kW - 1; ++j) madc_hi_cc(t[j + 1], a.w[j], bi, t[j + 1]);
      madc_hi(t[kW], a.w[kW - 1], bi, t[kW]);
    }
    reduce_round(t);
  }
  canonical(o, t);
}

// o = v 2^-256 mod r, canonical, for any v < 2^256 (REDC: the file's
// header bounds it); o may alias v
__device__ __forceinline__ void redc(Fr& o, const Fr& v) {
  u32 t[kW + 1];
#pragma unroll
  for (int k = 0; k < kW; ++k) t[k] = v.w[k];
  t[kW] = 0;
#pragma unroll
  for (int i = 0; i < kW; ++i) reduce_round(t);
  canonical(o, t);
}

// o = a + b mod r: a, b < r; the sum is below 2r < 2^256
__device__ __forceinline__ void add(Fr& o, const Fr& a, const Fr& b) {
  u32 s[kW], d[kW], borrow;
  add_cc(s[0], a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < kW - 1; ++j) addc_cc(s[j], a.w[j], b.w[j]);
  addc(s[kW - 1], a.w[kW - 1], b.w[kW - 1]);
  sub_cc(d[0], s[0], c_rw[0]);
#pragma unroll
  for (int j = 1; j < kW; ++j) subc_cc(d[j], s[j], c_rw[j]);
  subc(borrow, 0u, 0u);
#pragma unroll
  for (int j = 0; j < kW; ++j) o.w[j] = borrow ? s[j] : d[j];
}

// o = a - b mod r: a, b < r; + r where a < b
__device__ __forceinline__ void sub(Fr& o, const Fr& a, const Fr& b) {
  u32 d[kW], e[kW], borrow;
  sub_cc(d[0], a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < kW; ++j) subc_cc(d[j], a.w[j], b.w[j]);
  subc(borrow, 0u, 0u);
  add_cc(e[0], d[0], c_rw[0]);
#pragma unroll
  for (int j = 1; j < kW - 1; ++j) addc_cc(e[j], d[j], c_rw[j]);
  addc(e[kW - 1], d[kW - 1], c_rw[kW - 1]);
#pragma unroll
  for (int j = 0; j < kW; ++j) o.w[j] = borrow ? e[j] : d[j];
}

__device__ __forceinline__ Fr load(const u32* __restrict__ p, size_t n, size_t i) {
  Fr v;
#pragma unroll
  for (int k = 0; k < kW; ++k) v.w[k] = p[k * n + i];
  return v;
}

__device__ __forceinline__ void store(u32* __restrict__ p, size_t n, size_t i, const Fr& v) {
#pragma unroll
  for (int k = 0; k < kW; ++k) p[k * n + i] = v.w[k];
}

__device__ __forceinline__ Fr constant(const u32 (&c)[kW]) {
  Fr v;
#pragma unroll
  for (int k = 0; k < kW; ++k) v.w[k] = c[k];
  return v;
}

// x with its low `bits` >= 0 bits reversed
__device__ __forceinline__ unsigned rev(unsigned x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// -- the entry -------------------------------------------------------------
//
// A CTA of kEntryThreads threads takes kEntryPer runs of as many rows;
// thread q's slot j is row base + j kEntryThreads + q, so a warp's slot
// holds 32 consecutive rows, and the word skip of `mont` votes over them.
// Every slot's two 16-byte loads are issued before the first product.
// Lanes past n hold 0 and vote.  A warp where some row reaches word 7
// (full-width values: A's, B's and C's CSR values) runs the straight-line
// product, every round: the votes and the branches between rounds cost it
// 7-8 % (ops/tune_fr.py, PERF.md section 6).  Every warp subtracts r
// first: moved into the full-width branch, the subtractions (no-ops below
// 2^224) cost the CSR values 3 %.  Reading a warp's 32 rows as two
// contiguous 512-byte spans, the words handed to their lanes by shuffles,
// measured no faster (`entry_row_shuffle` there).
//
// Why one row a thread: the carry chains of a thread's rows run one after
// the other (PTX has one carry flag), so only more warps cover a chain's
// dependent latency; 4 rows a thread ran 0.0091 ms at 2^18 against 0.0057
// for 1 (158,773 rows, 38 warps an SM against 9.5).  CTAs of 128 threads
// spread cell B's 79,411 rows over more SMs than 256 (0.0038 ms against
// 0.0041) and cost nothing at 2^18.

constexpr int kEntryThreads = 128;
constexpr int kEntryPer = 1;  // rows a thread converts

// the 8 words of the two 16-byte halves of a row, least first
__device__ __forceinline__ Fr row_words(const ulonglong2& lo, const ulonglong2& hi) {
  const uint64_t l[4] = {lo.x, lo.y, hi.x, hi.y};
  Fr x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x.w[2 * k] = static_cast<u32>(l[k]);
    x.w[2 * k + 1] = static_cast<u32>(l[k] >> 32);
  }
  return x;
}

__global__ void __launch_bounds__(kEntryThreads)
fr_to_mont_kernel(const ulonglong2* __restrict__ rows, u32* __restrict__ out, int n) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kEntryThreads * kEntryPer;
  const int q = threadIdx.x;
  Fr x[kEntryPer];
#pragma unroll
  for (int j = 0; j < kEntryPer; ++j) {
    const size_t i = base + j * kEntryThreads + q;
    const bool in = i < static_cast<size_t>(n);
    const ulonglong2 zero = make_ulonglong2(0, 0);
    x[j] = row_words(in ? rows[2 * i] : zero, in ? rows[2 * i + 1] : zero);
  }
  const Fr r2 = constant(c_r2w);
#pragma unroll
  for (int j = 0; j < kEntryPer; ++j) {
    // x < 2^256 < 3r: at most two subtractions of r make it canonical
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      u32 d[kW], borrow;
      sub_cc(d[0], x[j].w[0], c_rw[0]);
#pragma unroll
      for (int k = 1; k < kW; ++k) subc_cc(d[k], x[j].w[k], c_rw[k]);
      subc(borrow, 0u, 0u);
#pragma unroll
      for (int k = 0; k < kW; ++k) x[j].w[k] = borrow ? x[j].w[k] : d[k];
    }
    if (__any_sync(0xffffffffu, x[j].w[kW - 1] != 0))
      mont(x[j], x[j], r2);
    else
      mont<true>(x[j], r2, x[j]);
  }
#pragma unroll
  for (int j = 0; j < kEntryPer; ++j) {
    const size_t i = base + j * kEntryThreads + q;
    if (i < static_cast<size_t>(n)) store(out, n, i, x[j]);
  }
}

// -- the exit --------------------------------------------------------------
//
// n = 2^k, index i = [a: top s bits][m: middle k - 2s bits][b: low s bits],
// bitrev_k(i) = rev_s(b) 2^(k-s) + rev_{k-2s}(m) 2^s + rev_s(a).  CTA m
// takes the 2^2s elements of one m: for each a the 2^s consecutive
// elements over b (a warp reads runs of each word plane), reduces them and
// stages their rows in shared memory in output order, slot rev_s(b) 2^s +
// rev_s(a); then for each b the 2^s consecutive rows over rev_s(a), a run
// of 2^s x 32 bytes, leave as 16-byte chunks, consecutive threads on
// consecutive chunks, so a warp's store covers 512 contiguous bytes.  The
// staging chunk of slot p, half h sits at (2 p + h) ^ (b & 7): the 8 lanes
// of a quarter warp (consecutive b in the writes, one b in the reads) then
// touch 8 distinct 16-byte bank groups.  s = min(kExitSideLog, k / 2).
// One element a thread and s = 4 (256 threads, 8 KB) measured fastest: at
// 2^18 0.0070 ms against 0.0086 for s = 5 and 4 elements a thread, whose
// 256 CTAs left 16 warps an SM (the entry's reason).

constexpr int kExitSideLog = 4;  // s: 2^2s elements a CTA (8 KB of rows at 4)
constexpr int kExitPer = 1;      // elements a thread reduces
constexpr int kExitTile = 1 << (2 * kExitSideLog);
constexpr int kExitThreads = kExitTile / kExitPer;

__global__ void __launch_bounds__(kExitThreads)
fr_from_mont_kernel(const u32* __restrict__ x, uint4* __restrict__ rows, int n, int log_n,
                    int s) {
  __shared__ uint4 staged[2 * kExitTile];
  const int count = 1 << (2 * s);
  const int low = (1 << s) - 1;
  const unsigned mid = blockIdx.x;
  Fr v[kExitPer];
#pragma unroll
  for (int j = 0; j < kExitPer; ++j) {
    const int e = threadIdx.x + j * kExitThreads;
    if (e < count) {
      const size_t i = (static_cast<size_t>(e >> s) << (log_n - s)) | (mid << s) | (e & low);
      v[j] = load(x, n, i);
    }
  }
#pragma unroll
  for (int j = 0; j < kExitPer; ++j) {
    const int e = threadIdx.x + j * kExitThreads;
    if (e < count) {
      const int b = e & low;
      redc(v[j], v[j]);
      const int p = 2 * ((rev(b, s) << s) | rev(e >> s, s));
      staged[p ^ (b & 7)] = make_uint4(v[j].w[0], v[j].w[1], v[j].w[2], v[j].w[3]);
      staged[(p + 1) ^ (b & 7)] = make_uint4(v[j].w[4], v[j].w[5], v[j].w[6], v[j].w[7]);
    }
  }
  __syncthreads();
  const size_t middle = static_cast<size_t>(rev(mid, log_n - 2 * s)) << s;
  for (int c = threadIdx.x; c < 2 * count; c += kExitThreads) {
    const int rb = c >> (s + 1);  // rev_s(b) of the run
    const size_t row = (static_cast<size_t>(rb) << (log_n - s)) | middle | ((c >> 1) & low);
    rows[2 * row + (c & 1)] = staged[c ^ (rev(rb, s) & 7)];
  }
}

// acc += the xor-partner lane's acc, every lane of the warp taking part
__device__ __forceinline__ void shfl_add(Fr& acc, int off) {
  Fr o;
#pragma unroll
  for (int k = 0; k < kW; ++k) o.w[k] = __shfl_xor_sync(0xffffffffu, acc.w[k], off);
  add(acc, acc, o);
}

// acc += vals[k] z[cols[k]] for k = k, k + step, ... < end, in that
// order; the next product's operands are loaded before the current
// product runs, so the loads overlap the multiplies.
__device__ __forceinline__ void dot(Fr& acc, const u32* __restrict__ vals, int nnz,
                                    const int* __restrict__ cols, const u32* __restrict__ z,
                                    int nz, int k, int end, int step) {
  if (k >= end) return;
  Fr v = load(vals, nnz, k), x = load(z, nz, cols[k]);
  for (;;) {
    const int next = k + step;
    const bool more = next < end;
    Fr nv, nx;
    if (more) {
      nv = load(vals, nnz, next);
      nx = load(z, nz, cols[next]);
    }
    mont(v, v, x);
    add(acc, acc, v);
    if (!more) return;
    v = nv;
    x = nx;
    k = next;
  }
}

// order (n_out,): the n_long long rows, then every other row of out, by
// length from the longest.  The first CTAs take those other rows, one a
// thread, so the longest of them start first; the last n_long CTAs sum a
// long row each: thread t the products k = begin + t, begin + t + 256, ...,
// each warp a shuffle tree, then warp 0 the 8 warps' sums.
__global__ void __launch_bounds__(kSpmvThreads)
fr_spmv_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
               const u32* __restrict__ vals, int nnz, const u32* __restrict__ z, int nz,
               u32* __restrict__ out, int n_out, int nrows, int ncopy,
               const int* __restrict__ order, int n_long) {
  constexpr int kWarps = kSpmvThreads / 32;
  const int short_blocks = (n_out - n_long + kSpmvThreads - 1) / kSpmvThreads;
  Fr acc = {};
  if (static_cast<int>(blockIdx.x) >= short_blocks) {
    __shared__ u32 part[kW][kWarps];
    const int row = order[blockIdx.x - short_blocks];
    dot(acc, vals, nnz, cols, z, nz, row_ptr[row] + threadIdx.x, row_ptr[row + 1],
        kSpmvThreads);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) shfl_add(acc, off);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kW; ++k) part[k][warp] = acc.w[k];
    }
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int k = 0; k < kW; ++k) acc.w[k] = lane < kWarps ? part[k][lane] : 0u;
    for (int off = kWarps / 2; off > 0; off >>= 1) shfl_add(acc, off);
    if (lane == 0) store(out, n_out, row, acc);
    return;
  }
  const int i = n_long + blockIdx.x * kSpmvThreads + threadIdx.x;
  if (i >= n_out) return;
  const int row = order[i];
  if (row < nrows) {
    dot(acc, vals, nnz, cols, z, nz, row_ptr[row], row_ptr[row + 1], 1);
  } else if (row - nrows < ncopy) {
    acc = load(z, nz, row - nrows);
  }
  store(out, n_out, row, acc);
}

// One butterfly of span 2h at u = x[i], v = x[i + h] with twiddle w:
// DIT (u + w v, u - w v), DIF (u + v, w (u - v)).
template <bool kDif>
__device__ __forceinline__ void butterfly(Fr& u, Fr& v, const Fr& w) {
  if (kDif) {
    Fr d;
    sub(d, u, v);
    add(u, u, v);
    mont(v, d, w);
  } else {
    Fr t;
    mont(t, v, w);
    sub(v, u, t);
    add(u, u, t);
  }
}

// -- the tile kernel -------------------------------------------------------
//
// A tile of t = 2^log_t elements, t / 4 threads (one for t <= 4), one CTA
// a tile.  In a phase on the bit set s, thread q holds the 4 elements whose
// index bits s, s + 1 are its slot m and whose other bits are q's (`elem`),
// so each stage of span 2^(lh + 1), s <= lh < s + 2, pairs two of its
// registers.  Phases: DIF from the top, stages hi .. max(0, hi - 1) on s =
// max(0, hi - 1), hi = log_t - 1, log_t - 3, ...; DIT from the bottom,
// stages lo .. min(lo + 1, log_t - 1) on s = min(lo, top), lo = 0, 2, ...;
// top = max(0, log_t - 2), the set of the loads and stores from device
// memory, where a warp's 32 threads read 32 consecutive elements.  At
// log_t = 10 the sets run 8, 6, 4, 2, 0 (DIF), 0, 2, 4, 6, 8 (DIT): the
// round trip exchanges 8 times, the scale between the halves in
// registers.  The twiddles of a tile are the prefix tw[0 .. t) of the
// stage table, the same for every tile: read through the read-only cache,
// where the SM keeps them.
//
// Why 4 elements a thread: a product is one long dependent chain of
// carries, and the SM covers its latency with warps better than with a
// thread's independent products.  8 elements a thread (127 registers, 128
// threads a tile) left 16 warps an SM and 768 tiles (2^18, three vectors)
// in 528 CTA slots, 1.45 rounds: the round trip ran 0.41 ms, 3x its
// bound, and with the twiddles in 64 KB of shared memory (2 CTAs an SM)
// 0.45 ms; at 4 a thread a tile takes 256 threads under 85 registers (3
// CTAs, 24 warps an SM, 396 slots: 768 tiles in 1.94 rounds) and 0.30 ms
// (ops/tune_fr.py, PERF.md section 6).

constexpr int kPerLog = 2;
constexpr int kPer = 1 << kPerLog;           // elements a thread holds
constexpr int kTileThreads = kTile / kPer;   // 256
enum TileForm { kFormDif = 0, kFormDit = 1, kFormRoundTrip = 2 };

// slot m of thread q on the bit set s: q's low s bits, m, q's other bits
__device__ __forceinline__ int elem(int q, int s, int m) {
  return (q & ((1 << s) - 1)) | (m << s) | ((q >> s) << (s + kPerLog));
}

// The exchange slot of element e: bits 5 and 6 of e flip the bank bits
// 0x0a and 0x15.  On every set s a warp's 32 threads hold index bits
// {0 .. s-1} and {s+2 .. 6} (s < 5) or {0 .. 4}; with these flips those
// bits map onto the 5 bank bits one to one, so for each slot the warp's
// 32 words lie in 32 banks.
__device__ __forceinline__ int swz(int e) {
  return e ^ (((e >> 5) & 1) * 0x0a) ^ (((e >> 6) & 1) * 0x15);
}

// The held elements move from bit set `from` to bit set `to` through the
// planes sx[k][swz(e)]; the first barrier lets the last phase's readers of
// sx finish.
__device__ __forceinline__ void exchange(Fr (&r)[kPer], u32* sx, int q, int from, int to,
                                         int slots) {
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (m >= slots) break;
    const int e = swz(elem(q, from, m));
#pragma unroll
    for (int k = 0; k < kW; ++k) sx[k * kTile + e] = r[m].w[k];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (m >= slots) break;
    const int e = swz(elem(q, to, m));
#pragma unroll
    for (int k = 0; k < kW; ++k) r[m].w[k] = sx[k * kTile + e];
  }
}

// The stages lh in [lo, hi] of one phase on bit set s (s <= lo, hi < s +
// 2), DIF from the widest, DIT from the narrowest: stage lh = s + b pairs
// slots m and m + 2^b with twiddle tw[h + j] (planes of n), j = the
// element's index mod h (q's low s bits and m's low b bits).
template <bool kDif>
__device__ __forceinline__ void phase(Fr (&r)[kPer], int q, int s, int lo, int hi,
                                      const u32* __restrict__ tw, int n) {
#pragma unroll
  for (int c = 0; c < kPerLog; ++c) {
    const int b = kDif ? kPerLog - 1 - c : c;
    const int lh = s + b;
    if (lh < lo || lh > hi) continue;
    const int h = 1 << lh;
    const int low = q & ((1 << s) - 1);
#pragma unroll
    for (int p = 0; p < kPer / 2; ++p) {
      const int m = ((p >> b) << (b + 1)) | (p & ((1 << b) - 1));
      const int idx = h + (low | ((m & ((1 << b) - 1)) << s));
      Fr w;
#pragma unroll
      for (int k = 0; k < kW; ++k) w.w[k] = __ldg(tw + k * static_cast<size_t>(n) + idx);
      butterfly<kDif>(r[m], r[m + (1 << b)], w);
    }
  }
}

// x (nvec, 8, n) in place, tile blockIdx.x of the nvec n / 2^log_t; tw the
// DIF or the DIT form's table (the round trip's DIF half), tw_dit the round
// trip's DIT table; scale (8, n) or null.
template <int kForm>
__global__ void __launch_bounds__(kTileThreads, 3)
fr_ntt_tile_kernel(u32* __restrict__ x, const u32* __restrict__ tw,
                   const u32* __restrict__ tw_dit, const u32* __restrict__ scale, int n,
                   int log_t) {
  __shared__ u32 sx[kW * kTile];
  const int t = 1 << log_t;
  const int q = threadIdx.x;
  const int slots = t < kPer ? t : kPer;
  const int top = log_t > kPerLog ? log_t - kPerLog : 0;
  const int per_vec = n >> log_t;
  const int v = blockIdx.x / per_vec;
  const size_t base = static_cast<size_t>(blockIdx.x - v * per_vec) << log_t;
  u32* xv = x + static_cast<size_t>(v) * kW * n;
  Fr r[kPer] = {};
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (m < slots) r[m] = load(xv, n, base + elem(q, top, m));
  }
  int s = top;
  if (kForm != kFormDit) {
    for (int hi = log_t - 1; hi >= 0; hi -= kPerLog) {
      const int lo = hi > kPerLog - 1 ? hi - (kPerLog - 1) : 0;
      if (lo != s) {
        exchange(r, sx, q, s, lo, slots);
        s = lo;
      }
      phase<true>(r, q, s, lo, hi, tw, n);
    }
    if (kForm == kFormDif && s != top) {  // the scale's and the store's order
      exchange(r, sx, q, s, top, slots);
      s = top;
    }
    if (scale) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        if (m < slots) mont(r[m], r[m], load(scale, n, base + elem(q, s, m)));
      }
    }
  }
  if (kForm != kFormDif) {
    const u32* twd = kForm == kFormDit ? tw : tw_dit;
    for (int lo = 0; lo < log_t; lo += kPerLog) {
      const int hi = lo + kPerLog - 1 < log_t ? lo + kPerLog - 1 : log_t - 1;
      const int set = lo < top ? lo : top;
      if (set != s) {
        exchange(r, sx, q, s, set, slots);
        s = set;
      }
      phase<false>(r, q, s, lo, hi, twd, n);
    }
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    if (m < slots) store(xv, n, base + elem(q, s, m), r[m]);
  }
}

template <bool kDif>
__global__ void __launch_bounds__(kThreads)
fr_ntt_stage_kernel(u32* __restrict__ x, const u32* __restrict__ tw, int n, int lh) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n / 2) return;
  const int h = 1 << lh;
  const int j = b & (h - 1);
  const int i = ((b >> lh) << (lh + 1)) | j;
  Fr u = load(x, n, i), v = load(x, n, i + h);
  butterfly<kDif>(u, v, load(tw, n, h + j));
  store(x, n, i, u);
  store(x, n, i + h, v);
}

__global__ void __launch_bounds__(kThreads)
fr_quotient_kernel(u32* __restrict__ a, const u32* __restrict__ b,
                   const u32* __restrict__ c, const u32* __restrict__ zinv, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Fr v;
  mont(v, load(a, n, i), load(b, n, i));
  sub(v, v, load(c, n, i));
  mont(v, v, load(zinv, 1, 0));
  store(a, n, i, v);
}

// -- the power tables --------------------------------------------------------
//
// out[i] = c base^e(i), from squares[m] = base^(2^m).  Each value is read
// off a source index x whose bit m stands for the factor base^(2^pos(m)):
// bit-reversed mode, x = i and pos(m) = k - 1 - m (so the exponent is
// bitrev(i)); stage mode, x = j < n / 2 and pos(m) = m (so the value is the
// top segment's tw[n/2 + j] = c base^j).  A lower segment of the stage
// table is a stride of the top one, tw[h + j'] = tw[n/2 + j' n / 2h], so
// value x of stage mode is written at n/2 + x and at (n >> (z + 1)) + (x
// >> z) for every z in 1 .. k - 1 with 2^z | x, and x = 0 at 0 as well:
// every element once, and n / 2 products for the n elements.
//
// A CTA takes a tile of 2^(s + t) consecutive x, x = x0 + a 2^s + b, and
// writes out[.] = H(a) L(b), one product an element, stored in natural
// order (a warp's 32 stores of each word plane contiguous):
// - L(b) = c times the factors of b's s bits, the same for every CTA;
// - H(a) = G Hp(a): Hp(a) the factors of a's t bits (the same for every
//   CTA), G those of x0's bits from s + t up (the CTA's own).
// Each table is built on chip, so that no chain of dependent products is
// long (a product is ~300 dependent instructions): phase 1, the leaves LA
// (c and the low sa = ceil(s / 2) bits), LB (the other s - sa) and Hp, an
// entry a thread, at most max(sa, t - 1) products each, while the last warp
// multiplies G's factors in a shuffle tree, ceil(log2 popcount) levels;
// phase 2, L(b) = LA LB and H(a) = G Hp(a), one product each; phase 3, the
// elements.  Stage mode stages its even values in shared memory, and then
// writes each level z of strides as one contiguous run, a warp's 32
// stores at once, not a divergent loop over z an element.  At k = 18
// that is at most 5 products deep, against up to 17
// square-and-multiply steps a thread before; the tables take 9 warp-wide
// products (3 for the leaves, 3 for G's tree, 3 for L and H) beside the 32
// of a tile of 2^10's elements.  s = min(kPowLowLog, bits), t as large as
// kPowHighLog allows with at least 2^kPowMinCtaLog tiles (bits = log2 of
// the count of x: k, or k - 1 in stage mode), so that a table at 2^17 or
// 2^18 fills the SMs in one wave (pow_tile).

constexpr int kPowThreads = 256;
constexpr int kPowLowLog = 6;     // s at most: a tile's low bits, the table L
constexpr int kPowHighLog = 5;    // t at most: a tile's runs, the table H
constexpr int kPowMinCtaLog = 8;  // t shrinks until the grid has 2^8 tiles
constexpr int kPowLA = 1 << ((kPowLowLog + 1) / 2);
constexpr int kPowLB = 1 << (kPowLowLog / 2);
constexpr int kPowLeaves = kPowLA + kPowLB + (1 << kPowHighLog);
constexpr int kPowTile = 1 << (kPowLowLog + kPowHighLog);
static_assert(kPowLeaves <= kPowThreads - 32, "the leaves' threads overlap the last warp");

// R' mod r: the Montgomery form of 1
__constant__ u32 c_onew[kW] = {0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
                               0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

__device__ __forceinline__ Fr plane_at(u32 (*p)[kW], int j) {
  Fr v;
#pragma unroll
  for (int k = 0; k < kW; ++k) v.w[k] = p[j][k];
  return v;
}

__device__ __forceinline__ void plane_put(u32 (*p)[kW], int j, const Fr& v) {
#pragma unroll
  for (int k = 0; k < kW; ++k) p[j][k] = v.w[k];
}

__device__ __forceinline__ void column_put(u32 (*p)[1 << kPowLowLog], int j, const Fr& v) {
#pragma unroll
  for (int k = 0; k < kW; ++k) p[k][j] = v.w[k];
}

// base^(2^pos(m)) for source bit m
__device__ __forceinline__ Fr pow_factor(const u32* __restrict__ squares, int m, int log_n,
                                         int stage) {
  return load(squares, kMaxLog, stage ? m : log_n - 1 - m);
}

__global__ void __launch_bounds__(kPowThreads)
fr_powers_kernel(u32* __restrict__ out, const u32* __restrict__ squares,
                 const u32* __restrict__ c, int n, int log_n, int stage, int s, int t) {
  __shared__ u32 leaf[kPowLeaves][kW];            // LA, LB, Hp
  __shared__ u32 lt[kW][1 << kPowLowLog];         // L, as planes: a warp reads 32 b
  __shared__ u32 ht[1 << kPowHighLog][kW];        // H, each read by a whole warp
  __shared__ u32 gt[1][kW];                       // G
  __shared__ u32 staged[kW][kPowTile / 2 + kPowTile / 64];  // stage mode: even e's values
  const int sa = (s + 1) / 2;
  const int na = 1 << sa, nb = 1 << (s - sa), nh = 1 << t, count = 1 << (s + t);
  const unsigned x0 = blockIdx.x << (s + t);
  const int q = threadIdx.x;
  // leaf q: LA entry q (from c), LB entry q - na, Hp entry q - na - nb
  const bool la = q < na;
  Fr v = la ? load(c, 1, 0) : constant(c_onew);
  if (q < na + nb + nh) {
    const int first = la ? 0 : q < na + nb ? sa : s;
    const unsigned x = q - (la ? 0 : q < na + nb ? na : na + nb);
    bool have = la;
    for (unsigned rest = x; rest; rest &= rest - 1) {
      const Fr f = pow_factor(squares, first + __ffs(rest) - 1, log_n, stage);
      if (have)
        mont(v, v, f);
      else
        v = f;
      have = true;
    }
    plane_put(leaf, q, v);
  }
  if (q >= kPowThreads - 32) {
    // G: lane l takes the factor of x0's l-th set bit from s + t, the
    // others 1; round `step` multiplies by the lane step apart
    const int lane = q & 31;
    const unsigned hi = x0 >> (s + t);
    const int p = __popc(hi);
    if (lane < p) {
      unsigned rest = hi;
      for (int l = 0; l < lane; ++l) rest &= rest - 1;
      v = pow_factor(squares, s + t + __ffs(rest) - 1, log_n, stage);
    }
    for (int step = 1; step < p; step <<= 1) {
      Fr o;
#pragma unroll
      for (int k = 0; k < kW; ++k) o.w[k] = __shfl_xor_sync(0xffffffffu, v.w[k], step);
      mont(v, v, o);
    }
    if (lane == 0) plane_put(gt, 0, v);
  }
  __syncthreads();
  for (int j = q; j < (1 << s) + nh; j += kPowThreads) {
    if (j < (1 << s)) {
      mont(v, plane_at(leaf, j & (na - 1)), plane_at(leaf, na + (j >> sa)));
      column_put(lt, j, v);
    } else {
      mont(v, plane_at(gt, 0), plane_at(leaf, na + nb + j - (1 << s)));
      plane_put(ht, j - (1 << s), v);
    }
  }
  __syncthreads();
  const int low = (1 << s) - 1;
  for (int e = q; e < count; e += kPowThreads) {
    Fr l;
#pragma unroll
    for (int k = 0; k < kW; ++k) l.w[k] = lt[k][e & low];
    mont(v, plane_at(ht, e >> s), l);
    if (!stage) {
      store(out, n, x0 + e, v);
      continue;
    }
    store(out, n, (n >> 1) + x0 + e, v);
    const int h = e >> 1;
    if (!(e & 1)) {
#pragma unroll
      for (int k = 0; k < kW; ++k) staged[k][h + (h >> 5)] = v.w[k];
    }
  }
  if (!stage) return;
  // the strides: level z takes the count >> z values with 2^z | e (x0 is a
  // multiple of count) to (n >> (z + 1)) + (x0 >> z) + u, a warp's 32 u
  // contiguous; even e's value sits at h + (h >> 5), h = e / 2, which
  // keeps a warp's reads at stride 2^(z - 1) on 32 banks up to z = 6
  __syncthreads();
  for (int z = 1; z <= s + t; ++z) {
    for (int u = q; u < count >> z; u += kPowThreads) {
      const int h = u << (z - 1);
#pragma unroll
      for (int k = 0; k < kW; ++k) v.w[k] = staged[k][h + (h >> 5)];
      store(out, n, (n >> (z + 1)) + (x0 >> z) + u, v);
    }
  }
  if (q == 0) {
    // the levels above s + t hold x0's value alone, where 2^z | x0
#pragma unroll
    for (int k = 0; k < kW; ++k) v.w[k] = staged[k][0];
    const int zmax = x0 ? min(__ffs(x0) - 1, log_n - 1) : log_n - 1;
    for (int z = s + t + 1; z <= zmax; ++z) store(out, n, (n >> (z + 1)) + (x0 >> z), v);
    if (!x0) store(out, n, 0, v);
  }
}

// fr_powers_kernel's tile: s low bits, t run bits of `bits` = log2 of the
// count of source indices
void pow_tile(int bits, int& s, int& t) {
  s = bits < kPowLowLog ? bits : kPowLowLog;
  t = bits - s - kPowMinCtaLog;
  t = t < 0 ? 0 : t > kPowHighLog ? kPowHighLog : t;
}

int blocks(long work) { return static_cast<int>((work + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// Every entry runs on the given stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes it does not take.  Planes are (8, n)
// uint32 (int32 tensors); rows (n, 4) u64, 16-byte aligned.

int fr_to_mont_launch(const void* rows, u32* out, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long per_block = static_cast<long>(kEntryThreads) * kEntryPer;
  fr_to_mont_kernel<<<static_cast<int>((n + per_block - 1) / per_block), kEntryThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(rows), out, n);
  return static_cast<int>(cudaGetLastError());
}

// n = 2^log_n: row bitrev(i) <- element i; a CTA a tile of 2^2s elements
int fr_from_mont_launch(const u32* x, void* rows, int n, int log_n, void* stream) {
  if (log_n < 1 || log_n > 30 || n != 1 << log_n) return static_cast<int>(cudaErrorInvalidValue);
  const int s = log_n / 2 < kExitSideLog ? log_n / 2 : kExitSideLog;
  fr_from_mont_kernel<<<1 << (log_n - 2 * s), kExitThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, static_cast<uint4*>(rows), n,
                                                             log_n, s);
  return static_cast<int>(cudaGetLastError());
}

// row_ptr (nrows + 1,), cols and vals (8, nnz) of a row-sorted CSR matrix;
// z (8, nz); out (8, n_out), every word written; order (n_out,) a
// permutation of the rows of out, its first n_long the rows one CTA each
int fr_spmv_launch(const int* row_ptr, const int* cols, const u32* vals, int nnz, const u32* z,
                   int nz, u32* out, int n_out, int nrows, int ncopy, const int* order,
                   int n_long, void* stream) {
  if (nnz < 0 || nz < 1 || nrows < 0 || n_out < nrows || ncopy < 0 || ncopy > nz ||
      nrows + ncopy > n_out || n_long < 0 || n_long > nrows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_out - n_long + kSpmvThreads - 1) / kSpmvThreads + n_long;
  if (grid == 0) return static_cast<int>(cudaSuccess);
  fr_spmv_kernel<<<grid, kSpmvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      row_ptr, cols, vals, nnz, z, nz, out, n_out, nrows, ncopy, order, n_long);
  return static_cast<int>(cudaGetLastError());
}

// x (nvec, 8, n) in place, n = 2^log_n >= 2; the stages of span <= 2^log_t,
// log_t = min(log_n, 10), of each vector; tw (8, n) the stage twiddles
// (the DIF ones where dif); scale (8, n) or null (DIF only); tw_dit (8, n)
// or null: with dif, the DIT stages over it after the scale, in the same
// pass (the round trip)
int fr_ntt_tile_launch(u32* x, const u32* tw, const u32* scale, const u32* tw_dit, int n,
                       int log_t, int dif, int nvec, void* stream) {
  if (n < 2 || (n & (n - 1)) || log_t < 1 || log_t > kTileLog || (1 << log_t) > n ||
      ((1 << log_t) < n && log_t != kTileLog) || nvec < 1 ||
      static_cast<long>(nvec) * (n >> log_t) > 0x7fffffffL || (!dif && (scale || tw_dit)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = nvec * (n >> log_t);
  const int threads = log_t > kPerLog ? 1 << (log_t - kPerLog) : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dif)
    fr_ntt_tile_kernel<kFormDit><<<tiles, threads, 0, s>>>(x, tw, nullptr, nullptr, n, log_t);
  else if (tw_dit)
    fr_ntt_tile_kernel<kFormRoundTrip><<<tiles, threads, 0, s>>>(x, tw, tw_dit, scale, n, log_t);
  else
    fr_ntt_tile_kernel<kFormDif><<<tiles, threads, 0, s>>>(x, tw, nullptr, scale, n, log_t);
  return static_cast<int>(cudaGetLastError());
}

// one stage of span 2^(lh + 1) over x (8, n), 2^lh >= 1024
int fr_ntt_stage_launch(u32* x, const u32* tw, int n, int lh, int dif, void* stream) {
  if (n < 2 || (n & (n - 1)) || lh < kTileLog || (2 << lh) > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dif)
    fr_ntt_stage_kernel<true><<<blocks(n / 2), kThreads, 0, s>>>(x, tw, n, lh);
  else
    fr_ntt_stage_kernel<false><<<blocks(n / 2), kThreads, 0, s>>>(x, tw, n, lh);
  return static_cast<int>(cudaGetLastError());
}

// a = (a b - c) zinv in place; zinv (8, 1)
int fr_quotient_launch(u32* a, const u32* b, const u32* c, const u32* zinv, int n,
                       void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  fr_quotient_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, zinv, n);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = c base^e(i), n = 2^log_n; squares (8, 32): base^(2^k) at column
// k; c (8, 1); stage 0 e = bitrev(i), 1 the stage twiddle exponent
int fr_powers_launch(u32* out, const u32* squares, const u32* c, int n, int log_n, int stage,
                     void* stream) {
  if (log_n < 1 || log_n > 30 || n != 1 << log_n || stage < 0 || stage > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int s, t;
  pow_tile(log_n - stage, s, t);
  fr_powers_kernel<<<1 << (log_n - stage - s - t), kPowThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(out, squares, c, n, log_n, stage, s,
                                                          t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
