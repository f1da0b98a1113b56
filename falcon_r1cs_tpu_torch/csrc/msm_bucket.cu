// The G1 MSM's bucket reduction, one merge level a launch, for Hopper
// (sm_90a): a plain C entry point loaded with ctypes by
// falcon_r1cs_tpu_torch/ops/_build.py and wrapped by ops/msm_bucket.py.
//
// bucket_level_kernel has no Pallas counterpart of its own: it is the glue
// of the wide tree around the point adds, which the JAX package leaves to
// XLA (falcon_r1cs_tpu/snark/tpu_msm_blocks.py _bucket_reduce_flat, its
// `_sel` selects and its `_scatter` into the "limb" bucket bank), and
// which the plain version (ops/msm_bucket.py bucket_level) runs as torch
// selects and index writes of the valid lanes.
//
// The tree (snark/gpu_msm.py _bucket_reduce_flat): each node of W windows
// x c lanes summarises its range of key-sorted, bit-reversed leaves by
// (H, T, kf, kl), the sums of its first and last segments and their keys.
// A merge level pairs lane j with lane j + c/2 (the two contiguous
// halves): the bridge T_left + H_right (K5, or K6 at level 1) is given;
// from it and the level's H, T, kf, kl this kernel writes, for each
// window w and lane j < c/2,
//   same = lkl == rkf, ls = lkf == lkl, rs = rkf == rkl,
//   H' = same & ls ? bridge : lH,   T' = same & rs ? bridge : rT,
//   kf' = lkf, kl' = rkl,
// and the totals of the segments that the merge closes, into the bucket
// planes at column w nb + key:
//   same ? bridge : lT at lkl, where !ls and !(same & rs);
//   rH at rkf, where !same and !rs;
// at the last level (c = 2) also the root's H' at kf' and its T' at kl'
// where kl' != kf'.  Each bucket's total is written once over the whole
// tree, so a lane that closes nothing writes nothing to the planes.
// Level 1 passes the affine leaves as both H and T with no Z (the
// Montgomery one, compiled in below) and the keys as both kf and kl:
// then ls and rs hold and nothing is emitted.
//
// Layout: limb-major.  H, T: (35, W, c) int32 per coordinate, inf (W, c);
// bridge (35, W, c/2), inf (W, c/2); the output one (2, 3, 35, W, c/2)
// int32 block (H' then T', X Y Z each), inf (2, W, c/2), keys (2, W, c/2)
// (kf' then kl'); the bank X, Y, Z (35, W nb) int32 and inf (W nb).  The
// infinity flags are torch.bool tensors, read and written here as bytes
// of 0 or 1.
//
// What bounds it on an H100: bytes.  A lane reads one of (bridge, lH) and
// one of (bridge, rT) a limb, 2 x 105 words, its four keys and flags, and
// writes 2 x 105 words and its keys and flags: ~1.7 kB a lane, ~4.9 GB
// over the levels of a 22-window group at 2^17 points.  The bucket writes
// are few (W nb columns over the tree, 105 words each) and scattered, 4
// bytes to a sector of the bank's planes.  But a level of c lanes a
// window has W c/2 lanes in all, from 45,056 at level 6 of a 2^17 group
// down to 22 at the root, fewer than the card holds at once, and from
// level 7 on most of them close a segment: there the time is the round
// trips of the threads that do the work and the sectors of the bucket
// writes, not the bytes.
//
// What the design does about it: one launch a level, CTAs of 256 threads
// that each take L consecutive lanes (L 256, or 32 down to 1: a form of
// the kernel each; a 64-lane form won one level of a 2^17 group by 3 %
// and lost the others, 128 lost all), in three phases.
// 1. Copy: every thread reads the keys of its lane (lane t mod L), picks
//    the sources of H' and T' (the bridge or its own half) and copies
//    limbs t / L, t / L + 256 / L, ... of each coordinate, the lane
//    fastest, so a warp reads and writes one line of a limb plane wherever
//    L >= 32; no barrier before it.  At L = 256 a thread copies its lane
//    alone, 10 independent loads in flight; past the last limb a thread
//    reloads limb 34 and stores nothing, so no load waits behind a branch.
// 2. Decide: a thread a lane lists the segments the merge closes as
//    records (source, offset, column w nb + key), up to four a lane,
//    compacted with __ballot_sync / __popc and a prefix over the warps into
//    one dense list a CTA.  Where c <= nb (a window's nodes at most half
//    its buckets: the narrow levels) the CTA takes its L nodes in key order
//    (node m of a window is lane brev(m)), so that neighbouring records
//    close neighbouring keys and a warp's stores of a limb share the
//    sectors of a plane; at the wide levels its own lanes, whose closed
//    segments are few and, in key order, would gather in the CTAs of a
//    window's nonzero keys.
// 3. Write the buckets: all threads sweep (limb, record) of the CTA's
//    list, the record fastest, each loading kBatch words before it stores
//    them, so a record's 105 words go out in parallel, not as one thread's
//    chain of load-store round trips.
// The entry picks L from W c/2 (kSplit, lanes = 0), the split measured in
// turns; a caller (the tuner, the tests) may force a form.  Level 1 is its
// own instantiation (kAffine), whose Z is the compiled-in one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // 32 warps an SM: at most 64 registers a thread
constexpr int kNL = 35;
constexpr int kWords = 3 * kNL;  // a point's limbs
constexpr int kMaxRecords = 4;   // bucket writes a lane: emit_a, emit_b, the root's two
constexpr int kBatch = 8;        // words a thread loads before it stores them (phase 3)
constexpr int kCopyUnroll = 5;   // limbs of a coordinate a thread loads at once in the copy
// The entry's choice of lanes a CTA (lanes = 0), by the level's lanes W
// c/2 (the first row it reaches): 256 while the grid still has 352 CTAs,
// then 32 down to 8 lanes a CTA, and 4, 2, 1 at the last levels.  At each
// level of a random 22-window 2^17 group it is the fastest form or within
// 5 % of it, timed in turns (ops/tune_msm_bucket.py, PERF.md section 6);
// a witness's sparse digits prefer 16 or 8 lanes at levels 7-9, by at most
// 2.6 us a level
constexpr int kSplit[][2] = {{90112, 256}, {11264, 32}, {5632, 16}, {704, 8},
                             {352, 4},     {44, 2},     {0, 1}};

// The canonical 12-bit limbs of the Montgomery one, 2^408 mod q
// (ops/fq_mont.py ONE_MONT_LIMBS; tests/test_torch_msm_bucket.py parses
// this table and holds it against that one).
__constant__ int kOneMont[kNL] = {
    2234, 2697, 2062, 52,   466,  2298, 2344, 636,  892,  3179, 1351, 2798,
    3154, 3776, 2950, 3549, 1542, 3411, 1315, 1545, 3780, 823,  3753, 2957,
    4000, 1811, 1727, 2234, 2947, 3829, 972,  396,  0,    0,    0};

// A point of the tree: X, Y, Z limb planes (Z null: affine, Z = one) and
// its infinity bytes.
struct Pt {
  const int* c[3];
  const uint8_t* inf;
};

struct Bank {
  int* c[3];
  uint8_t* inf;
};

// The sources of a lane's copies and bucket writes.
enum Src : uint8_t { kBridge = 0, kH = 1, kT = 2 };

// Limb l of a coordinate of a lane's source: its plane from `src` at
// `off`, planes `stride` apart, or the Montgomery one where `one` (the Z
// of an affine leaf).
__device__ __forceinline__ int limb(const int* __restrict__ src, size_t off, size_t stride,
                                    int l, bool one) {
  return one ? kOneMont[l] : __ldg(src + off + l * stride);
}

template <bool kAffine, int kLanes>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bucket_level_kernel(const Pt h, const Pt t, const int* __restrict__ kf,
                    const int* __restrict__ kl, const Pt b, int* __restrict__ out,
                    uint8_t* __restrict__ out_inf, int* __restrict__ out_keys, const Bank bank,
                    int W, int c, int nb, bool key_order) {
  constexpr int kRows = kThreads / kLanes;  // threads a lane in the copy
  __shared__ const int* s_src[3][3];        // [Src][coordinate]
  __shared__ const uint8_t* s_src_inf[3];
  __shared__ int s_col[kMaxRecords * kLanes], s_off[kMaxRecords * kLanes];
  __shared__ uint8_t s_id[kMaxRecords * kLanes];
  __shared__ int s_warp[kThreads / 32];

  const int tid = threadIdx.x;
  const int c2 = c >> 1;
  const int m2 = W * c2;
  const size_t in_s = static_cast<size_t>(W) * c;
  const size_t out_s = m2;
  const int lane0 = blockIdx.x * kLanes;
  if (tid == 0) {
    for (int k = 0; k < 3; ++k) {
      s_src[kBridge][k] = b.c[k];
      s_src[kH][k] = h.c[k];
      s_src[kT][k] = t.c[k];
    }
    s_src_inf[kBridge] = b.inf;
    s_src_inf[kH] = h.inf;
    s_src_inf[kT] = t.inf;
  }

  // 1. the copy: the selects of the lane this thread copies (lane t mod
  // L), from its keys; its row-0 thread writes kf', kl' and the flags.
  // No barrier before it: a thread starts as soon as its keys are in
  const int rho = kRows == 1 ? 0 : tid / kLanes;
  int i = lane0 + (kRows == 1 ? tid : tid & (kLanes - 1));
  int il = 0, ir = 0, lkf = 0, rkf = 0, lkl = 0, rkl = 0;
  if (i < m2) {
    il = i + i / c2 * c2;  // w c + j: the left lane
    ir = il + c2;          // and its right partner
    lkf = kf[il], rkf = kf[ir], lkl = kl[il], rkl = kl[ir];
    const bool same = lkl == rkf;
    const bool h_br = same && lkf == lkl;  // the left node is one segment
    const bool t_br = same && rkf == rkl;  // and the right one
    if (rho == 0) {
      out_keys[i] = lkf;
      out_keys[m2 + i] = rkl;
      out_inf[i] = h_br ? b.inf[i] : h.inf[il];
      out_inf[m2 + i] = t_br ? b.inf[i] : t.inf[ir];
    }
    // H' and T': limbs t / L + s 256 / L of each coordinate (at L = 256 a
    // thread its own lane, limbs 0..34: the limb indices fold to constants)
    if (rho < kNL) {
      const size_t h_off = h_br ? i : il, h_str = h_br ? out_s : in_s;
      const size_t t_off = t_br ? i : ir, t_str = t_br ? out_s : in_s;
      constexpr int kIter = (kNL + kRows - 1) / kRows;
      constexpr int kUnroll = kIter < kCopyUnroll ? kIter : kCopyUnroll;
#pragma unroll
      for (int k = 0; k < 3; ++k) {  // unrolled: the point structs are indexed by constants
        const bool h_one = kAffine && k == 2 && !h_br;
        const bool t_one = kAffine && k == 2 && !t_br;
        const int* hs = h_br ? b.c[k] : h.c[k];
        const int* ts = t_br ? b.c[k] : t.c[k];
        int* oh = out + static_cast<size_t>(k) * kNL * out_s + i;
        int* ot = out + static_cast<size_t>(3 + k) * kNL * out_s + i;
#pragma unroll (kUnroll)
        for (int s = 0; s < kIter; ++s) {
          // past the last limb a thread loads limb 34 again and stores
          // nothing: no branch around a load, so a thread's loads of a
          // coordinate are all in flight at once
          const int l = rho + s * kRows;
          const int lc = kNL % kRows == 0 || l < kNL ? l : kNL - 1;
          const int hv = limb(hs, h_off, h_str, lc, h_one);
          const int tv = limb(ts, t_off, t_str, lc, t_one);
          if (kNL % kRows == 0 || l < kNL) {
            oh[l * out_s] = hv;
            ot[l * out_s] = tv;
          }
        }
      }
    }
  }

  // 2. decide the bucket writes, a thread a lane (threads t < L, row 0 of
  // the copy).  In key order the CTA takes its L nodes instead: node m of
  // window w is lane w c/2 + brev(m), so the records of neighbouring
  // threads close neighbouring keys and a warp's stores of a limb share
  // the sectors of the bank's planes; else its own lanes, whose keys the
  // thread holds from the copy
  bool emit_a = false, emit_b = false, root = false, emit_t = false;
  bool same = false, h_br = false, t_br = false;
  int w = 0;
  if (tid < kLanes && lane0 + tid < m2) {
    if (key_order && c2 > 1) {
      const int node = lane0 + tid;
      w = node / c2;
      i = w * c2 + static_cast<int>(__brev(node - w * c2) >> (33 - __ffs(c2)));
      il = i + w * c2;
      ir = il + c2;
      lkf = kf[il], rkf = kf[ir], lkl = kl[il], rkl = kl[ir];
    }
    w = i / c2;
    same = lkl == rkf;
    const bool ls = lkf == lkl;
    const bool rs = rkf == rkl;
    h_br = same && ls;
    t_br = same && rs;
    emit_a = !ls && !t_br;
    emit_b = !same && !rs;
    root = c2 == 1;
    emit_t = root && rkl != lkf;
  }

  // its records, kind by kind, compacted over the CTA
  const unsigned ma = __ballot_sync(~0u, emit_a), mb = __ballot_sync(~0u, emit_b);
  const unsigned mh = __ballot_sync(~0u, root), mt = __ballot_sync(~0u, emit_t);
  const int wl = tid & 31, wid = tid >> 5;
  if (wl == 0) s_warp[wid] = __popc(ma) + __popc(mb) + __popc(mh) + __popc(mt);
  __syncthreads();
  int n_rec = 0, at = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    at += k < wid ? s_warp[k] : 0;
    n_rec += s_warp[k];
  }
  if (!n_rec) return;  // n_rec is the CTA's: every thread leaves here, or none
  const unsigned below = (1u << wl) - 1;
  const int base = w * nb;
  const auto put = [&](bool on, unsigned mask, Src id, int off, int key) {
    if (on) {
      const int p = at + __popc(mask & below);
      s_col[p] = base + key;
      s_off[p] = off;
      s_id[p] = id;
    }
    at += __popc(mask);
  };
  put(emit_a, ma, same ? kBridge : kT, same ? i : il, lkl);
  put(emit_b, mb, kH, ir, rkf);
  put(root, mh, h_br ? kBridge : kH, h_br ? i : il, lkf);
  put(emit_t, mt, t_br ? kBridge : kT, t_br ? i : ir, rkl);
  __syncthreads();

  // 3. write the buckets: (limb, record), the record fastest; each thread
  // loads kBatch words, then stores them
  const size_t bank_s = static_cast<size_t>(W) * nb;
  for (int q = tid; q < n_rec; q += kThreads) bank.inf[s_col[q]] = s_src_inf[s_id[q]][s_off[q]];
  const int dq = kThreads / n_rec, dr = kThreads - dq * n_rec;
  int rec = tid % n_rec, r = tid / n_rec;
  while (r < kWords) {
    int v[kBatch];
    int* dst[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      dst[u] = nullptr;
      v[u] = 0;
      if (r < kWords) {
        const int k = r / kNL, l = r - k * kNL;
        const int id = s_id[rec];
        v[u] = limb(s_src[id][k], s_off[rec], id == kBridge ? out_s : in_s, l,
                    kAffine && k == 2 && id != kBridge);
        dst[u] = (k == 0 ? bank.c[0] : k == 1 ? bank.c[1] : bank.c[2]) + l * bank_s + s_col[rec];
      }
      rec += dr;
      r += dq;
      if (rec >= n_rec) {
        rec -= n_rec;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (dst[u]) *dst[u] = v[u];
  }
}

// Grid and launch of one form.
template <bool kAffine, int kLanes>
void launch_form(const Pt& h, const Pt& t, const int* kf, const int* kl, const Pt& b, int* out,
                 uint8_t* out_inf, int* out_keys, const Bank& bank, int w, int c, int nb,
                 bool key_order, cudaStream_t st) {
  const int m2 = w * (c / 2);
  bucket_level_kernel<kAffine, kLanes><<<(m2 + kLanes - 1) / kLanes, kThreads, 0, st>>>(
      h, t, kf, kl, b, out, out_inf, out_keys, bank, w, c, nb, key_order);
}

template <bool kAffine>
bool launch_lanes(int lanes, const Pt& h, const Pt& t, const int* kf, const int* kl,
                  const Pt& b, int* out, uint8_t* out_inf, int* out_keys, const Bank& bank,
                  int w, int c, int nb, bool key_order, cudaStream_t st) {
#define FORM(L)                                                                          \
  case L:                                                                                \
    launch_form<kAffine, L>(h, t, kf, kl, b, out, out_inf, out_keys, bank, w, c, nb,    \
                            key_order, st);                                              \
    return true;
  switch (lanes) {
    FORM(256)
    FORM(32)
    FORM(16)
    FORM(8)
    FORM(4)
    FORM(2)
    FORM(1)
  }
#undef FORM
  return false;
}

}  // namespace

extern "C" {

// Runs on the given stream and returns cudaGetLastError().  h*, t*: the
// level's H and T (hz and tz both null: the affine leaves of level 1);
// b*: the bridge; out: (2, 3, 35, W, c/2) int32, out_inf (2, W, c/2)
// bytes, out_keys (2, W, c/2) int32, every word written; bank*: the
// planes, written only at the columns the level closes.  c is a power of
// two >= 2, every key in [0, nb).  lanes: the lanes a CTA, 256 or a power
// of two from 1 to 32, or 0 for the entry's own choice from W c/2.
int bucket_level_launch(const int* hx, const int* hy, const int* hz, const uint8_t* hinf,
                        const int* tx, const int* ty, const int* tz, const uint8_t* tinf,
                        const int* kf, const int* kl, const int* bx, const int* by,
                        const int* bz, const uint8_t* binf, int* out, uint8_t* out_inf,
                        int* out_keys, int* bank_x, int* bank_y, int* bank_z,
                        uint8_t* bank_inf, int w, int c, int nb, int lanes, void* stream) {
  if (w < 1 || c < 2 || (c & (c - 1)) || nb < 1 || (hz == nullptr) != (tz == nullptr) ||
      static_cast<int64_t>(w) * c > INT32_MAX || static_cast<int64_t>(w) * nb > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m2 = w * (c / 2);
  for (int k = 0; lanes == 0; ++k)
    if (m2 >= kSplit[k][0]) lanes = kSplit[k][1];
  const Pt h{{hx, hy, hz}, hinf}, t{{tx, ty, tz}, tinf}, b{{bx, by, bz}, binf};
  const Bank bank{{bank_x, bank_y, bank_z}, bank_inf};
  // key order once a window's c/2 nodes are at most half its nb buckets:
  // then most lanes close a segment (PERF.md section 6)
  const bool key_order = c <= nb;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool ok = hz == nullptr ? launch_lanes<true>(lanes, h, t, kf, kl, b, out, out_inf,
                                                     out_keys, bank, w, c, nb, key_order, st)
                                : launch_lanes<false>(lanes, h, t, kf, kl, b, out, out_inf,
                                                      out_keys, bank, w, c, nb, key_order, st);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
