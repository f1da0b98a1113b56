// The schoolbook circuit's negacyclic product block for Hopper (sm_90a),
// a plain C entry point loaded with ctypes by
// falcon_r1cs_tpu_torch/ops/_build.py.
//
// schoolbook_prods_kernel replaces the Pallas TPU kernel
//   falcon_r1cs_tpu/ops/pallas_schoolbook.py::_make_kernel
//
// What it computes, per batch row b, from sig and pk (B, n) in [0, q):
//   prods[b, i, j] = sig[b, j] * buf[b, n-1-i+j]   with buf = flip([q-pk || pk])
//   H[b, i], L[b, i]: the exact base-2^16 split of the row sum over j,
//     H = hi + (lo >> 16), L = lo & 0xFFFF, where lo sums the low 16 bits
//     and hi the high bits of every product.
// Index algebra: buf[n-1-i+j] = ext[n+i-j] with ext = [q-pk || pk], i.e.
// pk[i-j] for j <= i and q - pk[n+i-j] for j > i, so the kernel reads pk
// directly and never builds buf.
//
// What bounds it on an H100: the prods write, 4 n^2 bytes per batch row
// (537 MB at B = 128, n = 1024: ~0.16 ms at 3.35 TB/s).  Reads (2 n ints
// per row) and the integer work (one multiply and a few adds per product)
// are small next to it.
//
// What the design does about it: the TPU kernel slid one window along a
// sequential grid axis; CTAs on Hopper run in no order, so every CTA
// starts from its own rows.  One CTA owns kRows consecutive rows i of one
// batch row; each of its n/4 threads owns 4 consecutive columns j.  A
// thread's 4 sig values and its (kRows + 3)-wide window of ext are loaded
// once into registers, so each row costs it 4 multiplies and one
// coalesced 16-byte store: every product is written once and never read
// back.  The row sums reduce in the same pass: per-thread partials, a
// warp shuffle, then one shared-memory step across warps after the last
// row.  Nothing is carried between CTAs.
//
// Integer bounds (signed overflow is undefined in CUDA C++): sig < q and
// ext <= q, so each product < q^2 < 2^28; the lo sums < n 2^16 <= 2^26 and
// the hi sums < n 2^12 <= 2^22.  Every sum is exact in int32, in any order,
// so the results are bit-equal to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kQ = 12289;
constexpr int kRows = 16;       // rows i per CTA
constexpr int kMaxN = 1024;
constexpr int kMaxWarps = kMaxN / 4 / 32;

__global__ void __launch_bounds__(kMaxN / 4)
schoolbook_prods_kernel(const int* __restrict__ sig,
                        const int* __restrict__ pk, int* __restrict__ prods,
                        int* __restrict__ h_out, int* __restrict__ l_out,
                        int n) {
  __shared__ int s_lo[kRows][kMaxWarps];
  __shared__ int s_hi[kRows][kMaxWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tiles = n / kRows;
  const size_t b = blockIdx.x / tiles;
  const int i0 = (blockIdx.x % tiles) * kRows;
  const int* pk_row = pk + b * n;

  // columns j = 4t .. 4t+3; row i0 + r, column 4t + k reads
  // ext[n + i0 + r - 4t - k] = w[r + 3 - k]
  const int4 s = reinterpret_cast<const int4*>(sig + b * n)[t];
  const int base = n + i0 - 4 * t - 3;  // in [1, 2n - kRows - 3]
  int w[kRows + 3];
#pragma unroll
  for (int k = 0; k < kRows + 3; ++k) {
    const int m = base + k;
    w[k] = m < n ? kQ - __ldg(pk_row + m) : __ldg(pk_row + m - n);
  }

  int4* out = reinterpret_cast<int4*>(prods + (b * n + i0) * n) + t;
  const int row_vecs = n / 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int4 p;
    p.x = s.x * w[r + 3];
    p.y = s.y * w[r + 2];
    p.z = s.z * w[r + 1];
    p.w = s.w * w[r];
    out[(size_t)r * row_vecs] = p;
    int lo = (p.x & 0xFFFF) + (p.y & 0xFFFF) + (p.z & 0xFFFF) + (p.w & 0xFFFF);
    int hi = (p.x >> 16) + (p.y >> 16) + (p.z >> 16) + (p.w >> 16);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
      hi += __shfl_xor_sync(0xffffffffu, hi, off);
    }
    if (lane == 0) {
      s_lo[r][warp] = lo;
      s_hi[r][warp] = hi;
    }
  }
  __syncthreads();
  if (t < kRows) {
    int lo = 0, hi = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
      lo += s_lo[t][k];
      hi += s_hi[t][k];
    }
    h_out[b * n + i0 + t] = hi + (lo >> 16);
    l_out[b * n + i0 + t] = lo & 0xFFFF;
  }
}

}  // namespace

extern "C" {

// Launches on the given stream and returns cudaGetLastError().  n must be
// a multiple of 128 (whole warps of 4-column threads) and at most 1024.
int schoolbook_prods_launch(const int* sig, const int* pk, int* prods,
                            int* h_out, int* l_out, int batch, int n,
                            void* stream) {
  if (n <= 0 || n > kMaxN || n % 128 != 0 || batch <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = static_cast<long long>(batch) * (n / kRows);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  schoolbook_prods_kernel<<<static_cast<unsigned>(blocks), n / 4, 0, s>>>(
      sig, pk, prods, h_out, l_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
