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
// over the levels of a 22-window group at 2^17 points.  The emissions are
// few (at most W nb columns over the tree) and scattered.
//
// What the design does about it: one thread per (window, lane), j the
// fastest index, so every read and write of H, T, bridge and the output
// is one coalesced line per limb across a warp.  Each lane picks its
// source for H' and for T' (the bridge or its own half) once, from its
// keys, so a limb of each is one load and one store, and the 35 limbs of
// a coordinate run as an unrolled loop of independent loads; at most 64
// registers a thread (4 blocks of 256 an SM) keep 32 warps of loads in
// flight.  The closed segments are few (at most W nb lanes over the whole
// tree): a second pass writes them, re-reading their sources, limb by
// limb with 4-byte stores 4 W nb bytes apart.  Level 1 is its own
// instantiation (kAffine), whose Z is the compiled-in one.  Nothing is
// shared between threads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // 32 warps an SM: at most 64 registers a thread
constexpr int kNL = 35;

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

// Limb l of a coordinate of a lane's source: its plane from `src` at
// `off`, planes `stride` apart, or the Montgomery one where `one` (the Z
// of an affine leaf).
__device__ __forceinline__ int limb(const int* src, size_t off, size_t stride, int l, bool one) {
  return one ? kOneMont[l] : __ldg(src + off + l * stride);
}

template <bool kAffine>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bucket_level_kernel(const Pt h, const Pt t, const int* __restrict__ kf,
                    const int* __restrict__ kl, const Pt b, int* __restrict__ out,
                    uint8_t* __restrict__ out_inf, int* __restrict__ out_keys, const Bank bank,
                    int W, int c, int nb) {
  const int c2 = c >> 1;
  const int m2 = W * c2;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m2) return;
  const int w = i / c2;
  const int il = i + w * c2;  // w c + j: the left lane
  const int ir = il + c2;     // and its right partner
  const int lkf = kf[il], rkf = kf[ir], lkl = kl[il], rkl = kl[ir];
  const bool same = lkl == rkf;
  const bool ls = lkf == lkl;  // the left node is one segment
  const bool rs = rkf == rkl;
  const bool h_br = same && ls;
  const bool t_br = same && rs;
  const bool emit_a = !ls && !t_br;
  const bool emit_b = !same && !rs;
  const bool root = c2 == 1;
  const bool emit_t = root && rkl != lkf;

  const size_t in_s = static_cast<size_t>(W) * c;
  const size_t out_s = m2;

  out_keys[i] = lkf;
  out_keys[m2 + i] = rkl;
  const uint8_t h_inf = h_br ? b.inf[i] : h.inf[il];
  const uint8_t t_inf = t_br ? b.inf[i] : t.inf[ir];
  out_inf[i] = h_inf;
  out_inf[m2 + i] = t_inf;

  // H' and T': each lane copies one source a node, chosen once; a warp's
  // loads of a limb hit the bridge or the level's plane at consecutive
  // lanes, its stores are one line
  const size_t h_off = h_br ? i : il, h_str = h_br ? out_s : in_s;
  const size_t t_off = t_br ? i : ir, t_str = t_br ? out_s : in_s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // unrolled: the point structs are indexed by constants
    const bool h_one = kAffine && k == 2 && !h_br;
    const bool t_one = kAffine && k == 2 && !t_br;
    const int* hs = h_br ? b.c[k] : h.c[k];
    const int* ts = t_br ? b.c[k] : t.c[k];
    int* oh = out + static_cast<size_t>(k) * kNL * out_s + i;
    int* ot = out + static_cast<size_t>(3 + k) * kNL * out_s + i;
#pragma unroll 5
    for (int l = 0; l < kNL; ++l) {
      oh[l * out_s] = limb(hs, h_off, h_str, l, h_one);
      ot[l * out_s] = limb(ts, t_off, t_str, l, t_one);
    }
  }
  if (!(emit_a || emit_b || root)) return;

  // the segments this merge closes (few lanes: at most W nb over the
  // tree), each written at its bucket's column
  const size_t bank_s = static_cast<size_t>(W) * nb;
  const int base = w * nb;
  if (emit_a) bank.inf[base + lkl] = same ? b.inf[i] : t.inf[il];
  if (emit_b) bank.inf[base + rkf] = h.inf[ir];
  if (root) bank.inf[base + lkf] = h_inf;
  if (emit_t) bank.inf[base + rkl] = t_inf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool one = kAffine && k == 2;
    int* bank_k = bank.c[k];
    for (int l = 0; l < kNL; ++l) {
      int* col = bank_k + l * bank_s + base;
      if (emit_a)
        col[lkl] = same ? __ldg(b.c[k] + i + l * out_s) : limb(t.c[k], il, in_s, l, one);
      if (emit_b) col[rkf] = limb(h.c[k], ir, in_s, l, one);
      if (root) {
        col[lkf] = h_br ? __ldg(b.c[k] + i + l * out_s) : limb(h.c[k], il, in_s, l, one);
        if (emit_t) col[rkl] = t_br ? __ldg(b.c[k] + i + l * out_s) : limb(t.c[k], ir, in_s, l, one);
      }
    }
  }
}

}  // namespace

extern "C" {

// Runs on the given stream and returns cudaGetLastError().  h*, t*: the
// level's H and T (hz and tz both null: the affine leaves of level 1);
// b*: the bridge; out: (2, 3, 35, W, c/2) int32, out_inf (2, W, c/2)
// bytes, out_keys (2, W, c/2) int32, every word written; bank*: the
// planes, written only at the columns the level closes.  c is a power of
// two >= 2, every key in [0, nb).
int bucket_level_launch(const int* hx, const int* hy, const int* hz, const uint8_t* hinf,
                        const int* tx, const int* ty, const int* tz, const uint8_t* tinf,
                        const int* kf, const int* kl, const int* bx, const int* by,
                        const int* bz, const uint8_t* binf, int* out, uint8_t* out_inf,
                        int* out_keys, int* bank_x, int* bank_y, int* bank_z,
                        uint8_t* bank_inf, int w, int c, int nb, void* stream) {
  if (w < 1 || c < 2 || (c & (c - 1)) || nb < 1 || (hz == nullptr) != (tz == nullptr) ||
      static_cast<int64_t>(w) * c > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m2 = w * (c / 2);
  const Pt h{{hx, hy, hz}, hinf}, t{{tx, ty, tz}, tinf}, b{{bx, by, bz}, binf};
  const Bank bank{{bank_x, bank_y, bank_z}, bank_inf};
  const dim3 grid((m2 + kThreads - 1) / kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  if (hz == nullptr)
    bucket_level_kernel<true><<<grid, kThreads, 0, st>>>(h, t, kf, kl, b, out, out_inf,
                                                         out_keys, bank, w, c, nb);
  else
    bucket_level_kernel<false><<<grid, kThreads, 0, st>>>(h, t, kf, kl, b, out, out_inf,
                                                          out_keys, bank, w, c, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
