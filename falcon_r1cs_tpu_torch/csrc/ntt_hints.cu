// Bound-tracked limb NTT hint kernels for Hopper (sm_90a), plain C entry
// points loaded with ctypes by falcon_r1cs_tpu_torch/ops/_build.py.
//
// ntt_hints_kernel replaces the Pallas TPU kernel
//   falcon_r1cs_tpu/ops/pallas_ntt.py::_make_kernel
// intt_ntt_hints_kernel replaces
//   falcon_r1cs_tpu/ops/pallas_ntt.py::_make_kernel_vchain
// add_one_kernel replaces the capability probe
//   falcon_r1cs_tpu/ops/pallas_support.py::pallas_available
// and is the build's self-test.
//
// What they compute, per batch row of n coefficients in [0, q):
//   a forward NTT over exact 11 x 16-bit limbs (176 bits; every value stays
//   below 2^log_n * q^(log_n+1) < 2^164).  Stage l pairs j with j + half
//   inside each group, v = x[j+half] * s with s = ntt_table[m + group], and
//   writes u + v to the lo slot and u + (c_{l+1} - v) to the hi slot, where
//   c_{l+1} = 2^l * q^(l+2) is the stage bound.  Only the active limbs of
//   stage l (host schedule, pallas_ntt._active_limbs) are touched; the rows
//   above stay zero.  Then an exact divmod by q gives the quotient-hint
//   limbs t (11, B, n) and b = NTT(x) mod q (B, n).
//
// What bounds it on an H100: integer ALU work and shared-memory traffic.
// A row reads n int32 and writes 12 n int32 (48 KB at n = 1024), while its
// limb sweep issues ~sum(act) = 65 limb iterations of ~15 int32 ops per
// butterfly pair, plus 11 divmod steps per coefficient.  The byte traffic
// to device memory is small next to that work.
//
// What the design does about it: one CTA owns one row and keeps its whole
// 11 x n limb state in shared memory (45,056 B at n = 1024, under the 48 KB
// static limit), so device memory sees one read of x and one write of t, b.
// Each of the n/2 threads owns one butterfly pair (j, j + half) per stage:
// it runs the shared v carry chain and both output chains in one sweep over
// k and writes both slots back in place; since no other thread touches that
// pair in the stage, one __syncthreads() between stages is the only
// barrier.  The divmod writes t in the (11, B, n) layout, coalesced over j.
//
// Integer bounds (signed overflow is undefined in CUDA C++): limbs are
// masked to [0, 2^16) after every stage, so limb * s < 2^16 * 2^14 = 2^30;
// carries stay below 2^15 in magnitude; the divmod numerator r * 2^16 +
// limb < 2^30.  The INTT prologue keeps its state lazy in [0, 2q): products
// (u - v + 2q) * s' < 4q^2 < 2^29.2 and p + m q < 2^30.5.  The quotient
// estimate is floor(fl(fl(cur) * fl(1/q))) with round-to-nearest, fixed up
// by +-1, exactly as pallas_ntt.py and ops/modq.py compute it; build
// without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 11;
constexpr int kLimbBits = 16;
constexpr int kLimbMask = 0xFFFF;
constexpr int kQ = 12289;
constexpr int kMaxLogN = 10;

// Exact divmod of cur in [0, 2^30) by q, float-reciprocal estimate plus
// the two predicated fixups of ops/modq.divmod_q.
__device__ __forceinline__ int divmod_q(int cur, float inv_q, int* rem_out) {
  int t = static_cast<int>(floorf(__fmul_rn(static_cast<float>(cur), inv_q)));
  int rem = cur - t * kQ;
  if (rem >= kQ) { t += 1; rem -= kQ; }
  if (rem < 0) { t -= 1; rem += kQ; }
  *rem_out = rem;
  return t;
}

// 16-bit Montgomery reduction: p in [0, 2^30.5) -> p * 2^-16 mod q in
// [0, 2q).  m = (p mod 2^16) * (-q^-1) mod 2^16 with -q^-1 split into
// 8-bit halves, so every product stays below 2^24.
__device__ __forceinline__ int mont(int p, int qinv_lo, int qinv_hi) {
  const int a = p & 0xFFFF;
  const int m = (a * qinv_lo + (((a * qinv_hi) & 0xFF) << 8)) & 0xFFFF;
  return (p + m * kQ) >> 16;
}

// The pair owned by thread i at a stage with the given half width.
__device__ __forceinline__ int lo_slot(int i, int half) {
  return (i / half) * 2 * half + (i % half);
}

// Load the bound limbs (log_n + 1, 11) and the active-limb schedule
// (log_n,) into shared memory.
template <int LOG_N>
__device__ __forceinline__ void load_schedule(
    const int* __restrict__ bounds, const int* __restrict__ act,
    int* s_bounds, int* s_act) {
  for (int idx = threadIdx.x; idx < (LOG_N + 1) * kLimbs; idx += blockDim.x)
    s_bounds[idx] = bounds[idx];
  if (threadIdx.x < LOG_N) s_act[threadIdx.x] = act[threadIdx.x];
}

// The forward bound-tracked limb NTT over the seeded shared state, then
// the divmod by q from the top limb.  Shared by both hint kernels.
template <int LOG_N>
__device__ void limb_sweep_divmod(
    int (*st)[1 << LOG_N], const int* __restrict__ tw,
    const int* s_bounds, const int* s_act, int* __restrict__ t_out,
    int* __restrict__ b_out, int row, int batch, float inv_q) {
  constexpr int N = 1 << LOG_N;
  const int i = threadIdx.x;
#pragma unroll
  for (int l = 0; l < LOG_N; ++l) {
    const int half = N >> (l + 1);
    const int j = lo_slot(i, half);
    const int jh = j + half;
    const int s = __ldg(tw + l * N + j);
    const int* c = s_bounds + (l + 1) * kLimbs;
    const int act = s_act[l];
    int cv = 0, co_lo = 0, co_hi = 0;
    for (int k = 0; k < act; ++k) {
      const int uk = st[k][j];
      const int tv = st[k][jh] * s + cv;
      const int vk = tv & kLimbMask;
      cv = tv >> kLimbBits;
      const int lo = uk + vk + co_lo;
      const int hi = uk + (c[k] - vk) + co_hi;
      st[k][j] = lo & kLimbMask;
      st[k][jh] = hi & kLimbMask;
      co_lo = lo >> kLimbBits;
      co_hi = hi >> kLimbBits;
    }
    __syncthreads();
  }
  for (int jj = i; jj < N; jj += N / 2) {
    int r = 0;
    for (int k = kLimbs - 1; k >= 0; --k) {
      const int cur = (r << kLimbBits) + st[k][jj];
      t_out[((size_t)k * batch + row) * N + jj] = divmod_q(cur, inv_q, &r);
    }
    b_out[(size_t)row * N + jj] = r;
  }
}

template <int LOG_N>
__global__ void __launch_bounds__((1 << LOG_N) / 2)
ntt_hints_kernel(const int* __restrict__ x, const int* __restrict__ tw,
                 const int* __restrict__ bounds, const int* __restrict__ act,
                 int* __restrict__ t_out, int* __restrict__ b_out,
                 int batch, float inv_q) {
  constexpr int N = 1 << LOG_N;
  __shared__ int st[kLimbs][N];
  __shared__ int s_bounds[(kMaxLogN + 1) * kLimbs];
  __shared__ int s_act[kMaxLogN];
  const int row = blockIdx.x;
  load_schedule<LOG_N>(bounds, act, s_bounds, s_act);
  for (int jj = threadIdx.x; jj < N; jj += N / 2) {
    st[0][jj] = x[(size_t)row * N + jj];
    for (int k = 1; k < kLimbs; ++k) st[k][jj] = 0;
  }
  __syncthreads();
  limb_sweep_divmod<LOG_N>(st, tw, s_bounds, s_act, t_out, b_out, row,
                           batch, inv_q);
}

template <int LOG_N>
__global__ void __launch_bounds__((1 << LOG_N) / 2)
intt_ntt_hints_kernel(const int* __restrict__ w, const int* __restrict__ tw,
                      const int* __restrict__ itw,
                      const int* __restrict__ bounds,
                      const int* __restrict__ act, int* __restrict__ t_out,
                      int* __restrict__ b_out, int* __restrict__ v_out,
                      int batch, float inv_q, int qinv_lo, int qinv_hi,
                      int n_inv_mont) {
  constexpr int N = 1 << LOG_N;
  __shared__ int st[kLimbs][N];
  __shared__ int s_bounds[(kMaxLogN + 1) * kLimbs];
  __shared__ int s_act[kMaxLogN];
  const int row = blockIdx.x;
  const int i = threadIdx.x;
  load_schedule<LOG_N>(bounds, act, s_bounds, s_act);
  // limb row 0 holds the INTT state, then v
  int* x = st[0];
  for (int jj = i; jj < N; jj += N / 2) {
    x[jj] = w[(size_t)row * N + jj];
    for (int k = 1; k < kLimbs; ++k) st[k][jj] = 0;
  }
  __syncthreads();
  // clear INTT, levels log_n-1 .. 0 (intt_jax order), lazy in [0, 2q):
  // the sum folds with one conditional 2q subtract, the difference is
  // reduced by the Montgomery step against 2^16-premultiplied twiddles
#pragma unroll
  for (int l = LOG_N - 1; l >= 0; --l) {
    const int half = N >> (l + 1);
    const int j = lo_slot(i, half);
    const int jh = j + half;
    const int s = __ldg(itw + l * N + j);
    const int u = x[j];
    const int vv = x[jh];
    int sum = u + vv;
    if (sum >= 2 * kQ) sum -= 2 * kQ;
    x[j] = sum;
    x[jh] = mont((u - vv + 2 * kQ) * s, qinv_lo, qinv_hi);
    __syncthreads();
  }
  // n^-1 scale (2^16-premultiplied) and canonicalization to [0, q)
  for (int jj = i; jj < N; jj += N / 2) {
    int y = mont(x[jj] * n_inv_mont, qinv_lo, qinv_hi);
    if (y >= kQ) y -= kQ;
    x[jj] = y;
    v_out[(size_t)row * N + jj] = y;
  }
  __syncthreads();
  limb_sweep_divmod<LOG_N>(st, tw, s_bounds, s_act, t_out, b_out, row,
                           batch, inv_q);
}

__global__ void add_one_kernel(const int* __restrict__ x,
                               int* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = x[i] + 1;
}

}  // namespace

extern "C" {

// Each entry launches on the given stream and returns cudaGetLastError().

int ntt_hints_launch(const int* x, const int* tw, const int* bounds,
                     const int* act, int* t_out, int* b_out, int batch,
                     int log_n, float inv_q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_n == 10) {
    ntt_hints_kernel<10><<<batch, 512, 0, s>>>(x, tw, bounds, act, t_out,
                                               b_out, batch, inv_q);
  } else if (log_n == 9) {
    ntt_hints_kernel<9><<<batch, 256, 0, s>>>(x, tw, bounds, act, t_out,
                                              b_out, batch, inv_q);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int intt_ntt_hints_launch(const int* w, const int* tw, const int* itw,
                          const int* bounds, const int* act, int* t_out,
                          int* b_out, int* v_out, int batch, int log_n,
                          float inv_q, int qinv_lo, int qinv_hi,
                          int n_inv_mont, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log_n == 10) {
    intt_ntt_hints_kernel<10><<<batch, 512, 0, s>>>(
        w, tw, itw, bounds, act, t_out, b_out, v_out, batch, inv_q,
        qinv_lo, qinv_hi, n_inv_mont);
  } else if (log_n == 9) {
    intt_ntt_hints_kernel<9><<<batch, 256, 0, s>>>(
        w, tw, itw, bounds, act, t_out, b_out, v_out, batch, inv_q,
        qinv_lo, qinv_hi, n_inv_mont);
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
