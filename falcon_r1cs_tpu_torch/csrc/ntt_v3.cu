// Semi-carry limb NTT kernel for Hopper (sm_90a), plain C entry point
// loaded with ctypes by falcon_r1cs_tpu_torch/ops/_build.py.
//
// ntt_semi_kernel replaces the Pallas TPU kernel
//   tools/pallas_ntt_v3.py::kernel (built by _build, entry
//   ntt_with_hints_pallas_v3)
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
// the carry out of limb 11 dropped.  Every limb's incoming carry comes from
// the values before the round, so the state equals the plain version
// (ops/ntt_limb.ntt_semi) limb by limb, not only in value.  The output is
// the semi state (12, B, n); the exact normalisation and the divmod by q
// run outside the kernel (ops/ntt_v3.py), as they do outside the TPU one.
//
// What bounds it on an H100: integer ALU work.  A row reads n int32 and
// writes 12 n (48 KB at n = 1024); per butterfly pair and stage a thread
// does 12 multiplies, three rounds of 12 mask-shift-adds and 36 adds or
// subtracts, ~150 int32 operations, log_n times.  All 12 limbs take part
// in every stage, as in the TPU kernel: no active-limb trim.
//
// What the design does about it: one CTA owns one row, one thread per
// butterfly pair, as in ntt_hints.cu.  The 12 x n state is 49,152 B at
// n = 1024, past the 48 KB static limit, so it lives in dynamic shared
// memory with the bound limbs behind it (49,680 B); the launcher raises
// the kernel's dynamic limit with cudaFuncSetAttribute.  A thread loads its
// pair's 24 limbs into registers, runs the three rounds there and stores
// both slots back in place; no other thread touches that pair in the
// stage, so one __syncthreads() a stage is the only barrier.  Each round
// walks the limbs from the top down, so limb k reads limb k-1 before limb
// k-1 is rewritten: the carries are parallel, not a sequential chain.
//
// Integer bounds: limbs stay in about [-3, 2^16 + 2] and s < q < 2^14, so
// |limb * s| < 2^31 and u + (c - v) is far inside int32.  Every add,
// subtract and multiply still wraps through unsigned helpers (signed
// overflow is undefined in CUDA C++), so the kernel equals torch's int32
// arithmetic bit for bit even outside those bounds; >> of a negative limb
// is one arithmetic-shift helper, as torch's >> is.  No float.

#include <cuda_runtime.h>

namespace {

constexpr int kSemiLimbs = 12;
constexpr int kLimbBits = 16;
constexpr int kLimbMask = 0xFFFF;

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

// One parallel carry round in place, top limb down: limb k reads limb k-1
// before it is rewritten, so every carry comes from the pre-round values.
__device__ __forceinline__ void semi(int (&x)[kSemiLimbs]) {
#pragma unroll
  for (int k = kSemiLimbs - 1; k > 0; --k)
    x[k] = wadd(x[k] & kLimbMask, asr(x[k - 1], kLimbBits));
  x[0] &= kLimbMask;
}

// The pair owned by thread i at a stage with the given half width.
__device__ __forceinline__ int lo_slot(int i, int half) {
  return (i / half) * 2 * half + (i % half);
}

template <int LOG_N>
__global__ void __launch_bounds__((1 << LOG_N) / 2)
ntt_semi_kernel(const int* __restrict__ x, const int* __restrict__ tw,
                const int* __restrict__ bounds, int* __restrict__ semi_out,
                int batch) {
  constexpr int N = 1 << LOG_N;
  extern __shared__ int smem[];
  int (*st)[N] = reinterpret_cast<int (*)[N]>(smem);
  int* s_bounds = smem + kSemiLimbs * N;
  const int row = blockIdx.x;
  const int i = threadIdx.x;
  for (int idx = i; idx < (LOG_N + 1) * kSemiLimbs; idx += N / 2)
    s_bounds[idx] = bounds[idx];
  for (int jj = i; jj < N; jj += N / 2) {
    st[0][jj] = x[(size_t)row * N + jj];
    for (int k = 1; k < kSemiLimbs; ++k) st[k][jj] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LOG_N; ++l) {
    const int half = N >> (l + 1);
    const int j = lo_slot(i, half);
    const int jh = j + half;
    const int s = __ldg(tw + l * N + j);
    const int* c = s_bounds + (l + 1) * kSemiLimbs;
    int u[kSemiLimbs], v[kSemiLimbs], h[kSemiLimbs];
#pragma unroll
    for (int k = 0; k < kSemiLimbs; ++k) {
      u[k] = st[k][j];
      v[k] = wmul(st[k][jh], s);
    }
    semi(v);
#pragma unroll
    for (int k = 0; k < kSemiLimbs; ++k) {
      h[k] = wadd(u[k], wsub(c[k], v[k]));
      u[k] = wadd(u[k], v[k]);
    }
    semi(u);
    semi(h);
#pragma unroll
    for (int k = 0; k < kSemiLimbs; ++k) {
      st[k][j] = u[k];
      st[k][jh] = h[k];
    }
    __syncthreads();
  }
  for (int jj = i; jj < N; jj += N / 2) {
#pragma unroll
    for (int k = 0; k < kSemiLimbs; ++k)
      semi_out[((size_t)k * batch + row) * N + jj] = st[k][jj];
  }
}

template <int LOG_N>
int launch_semi(const int* x, const int* tw, const int* bounds,
                int* semi_out, int batch, cudaStream_t s) {
  // the 12 x n state, then the (log_n + 1) x 12 bound limbs
  constexpr size_t smem =
      sizeof(int) * (kSemiLimbs * (1 << LOG_N) + (LOG_N + 1) * kSemiLimbs);
  const cudaError_t err = cudaFuncSetAttribute(
      ntt_semi_kernel<LOG_N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_semi_kernel<LOG_N><<<batch, (1 << LOG_N) / 2, smem, s>>>(
      x, tw, bounds, semi_out, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on the given stream and returns the CUDA error code (0 if the
// attribute was set and the launch accepted).
int ntt_semi_launch(const int* x, const int* tw, const int* bounds12,
                    int* semi_out, int batch, int log_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_n == 10) return launch_semi<10>(x, tw, bounds12, semi_out, batch, s);
  if (log_n == 9) return launch_semi<9>(x, tw, bounds12, semi_out, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
