// The G1 MSM's signed-digit recode for Hopper (sm_90a), a plain C entry
// point loaded with ctypes by falcon_r1cs_tpu_torch/ops/_build.py and
// wrapped by ops/msm_recode.py.
//
// signed_digits_kernel has no Pallas counterpart: the JAX package recodes
// on the host (falcon_r1cs_tpu/snark/tpu_msm.py _window_digits_signed),
// and the port did too, with the same numpy loop
// (snark/gpu_msm.py _window_digits_signed), before it uploaded the digits.
//
// What it computes, for MSM k < K and point i < n_pad, from the scalar s
// (4 little-endian u64 limbs, zeroed where point i is infinite or i >= n):
// the nw signed window digits of the standard carry recode,
// v = ((s >> (j w)) & (2^w - 1)) + carry, and v > 2^(w-1) emits v - 2^w
// and carries 1; each digit is written packed as |digit| | (digit < 0) << w
// at digits[(j K + k) n_pad + i] (window-major, the layout
// gpu_msm._window_sums takes).  The caller picks nw: ceil(255 / w), the
// windows of the JAX package's recode, or 255 / w + 1 (one more where w
// divides 255), whose top window covers bits 255 and up, zero below 2^255,
// so its digit is the carry in and no scalar below 2^255 carries out.  A
// scalar whose final carry is 1 does not fit the windows; the kernel sets
// *overflow to 1, and the host reads it where the MSM synchronises anyway.
//
// What bounds it on an H100: bytes.  It reads 32 B of scalar and 1 B of
// the infinity flag a point and writes 4 nw B of digits (88 B at w = 12);
// the integer work is a few shifts, adds and selects a digit.  At
// n_pad = 2^17, 15.7 MB: ~4.7 us at 3.35 TB/s.
//
// What the design does about it: one thread per (point, MSM), the four
// limbs in registers, loaded as two 16-byte reads; the windows run
// serially over them, each digit's bits taken from the limb it starts in
// and the next (a window that straddles a 64-bit boundary), the limbs
// chosen by selects so that nothing is indexed at run time and nothing
// spills to local memory.  Digit j of neighbouring threads lands on
// neighbouring words, so every store of a warp is one coalesced 128-byte
// line.  Nothing is shared between threads; the overflow flag is a plain
// store of 1, the same value from every thread that writes it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t limb_at(int j, uint64_t l0, uint64_t l1, uint64_t l2,
                                            uint64_t l3) {
  return j == 0 ? l0 : j == 1 ? l1 : j == 2 ? l2 : j == 3 ? l3 : 0;
}

__global__ void __launch_bounds__(kThreads)
signed_digits_kernel(const ulonglong2* __restrict__ scalars, const bool* __restrict__ inf,
                     int* __restrict__ digits, int* __restrict__ overflow, int n, int n_pad,
                     int window, int nw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= n_pad) return;
  uint64_t l0 = 0, l1 = 0, l2 = 0, l3 = 0;
  if (i < n && !inf[i]) {
    const size_t at = 2 * (static_cast<size_t>(k) * n + i);
    const ulonglong2 a = __ldg(scalars + at);
    const ulonglong2 b = __ldg(scalars + at + 1);
    l0 = a.x;
    l1 = a.y;
    l2 = b.x;
    l3 = b.y;
  }
  const uint64_t mask = (uint64_t{1} << window) - 1;
  const int half = 1 << (window - 1);
  const int full = 1 << window;
  const size_t stride = static_cast<size_t>(gridDim.y) * n_pad;  // one window's K rows
  int* out = digits + static_cast<size_t>(k) * n_pad + i;
  int carry = 0;
  for (int w = 0; w < nw; ++w) {
    const int bit = w * window;
    const int j = bit >> 6;
    const int r = bit & 63;
    uint64_t v = limb_at(j, l0, l1, l2, l3) >> r;
    // the bits above the limb come from the next one (a shift by 64 is
    // undefined, so r = 0 takes none; bits past the window are masked)
    if (r) v |= limb_at(j + 1, l0, l1, l2, l3) << (64 - r);
    const int d = static_cast<int>(v & mask) + carry;
    carry = d > half;
    const int sv = carry ? d - full : d;
    out[w * stride] = sv < 0 ? (-sv) | (1 << window) : sv;
  }
  if (carry) *overflow = 1;
}

}  // namespace

extern "C" {

// Runs on the given stream and returns cudaGetLastError().  scalars:
// (K, n, 4) u64, 16-byte aligned; inf: (n,) bool; digits: (nw K, n_pad)
// int32, every word written; overflow: one int32, zeroed by the caller;
// nw: ceil(255 / w) or 255 / w + 1.
int signed_digits_launch(const void* scalars, const bool* inf, int* digits, int* overflow,
                         int n, int n_pad, int k, int window, int nw, void* stream) {
  if (n < 0 || n_pad < 1 || n > n_pad || k < 1 || k > 65535 || window < 1 || window > 30 ||
      (nw != (255 + window - 1) / window && nw != 255 / window + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_pad + kThreads - 1) / kThreads, k);
  signed_digits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ulonglong2*>(scalars), inf, digits, overflow, n, n_pad, window, nw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
