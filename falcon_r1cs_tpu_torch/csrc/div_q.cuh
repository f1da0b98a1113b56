// The exact divmod by q of the NTT kernels for Hopper (sm_90a), shared by
// ntt_hints.cu (the hint kernels K1, K2) and ntt_v3.cu (the semi-carry
// kernel K8's hints epilogue): floor(cur / q) of any cur < 2^30 as one
// multiply-high and a shift, the step of a base-2^16 long division whose
// remainder stays below q.

#pragma once

#include <cstdint>

namespace {

using u32 = uint32_t;

constexpr u32 kQ = 12289;

// floor(cur / q) = umulhi(cur, kDivMagic) >> kDivShift for every cur <
// 2^30: kDivMagic = ceil(2^44 / q) and kDivMagic q - 2^44 <= 2^14
constexpr u32 kDivMagic = 1431539267u;
constexpr int kDivShift = 12;

__device__ __forceinline__ u32 div_q(u32 cur) { return __umulhi(cur, kDivMagic) >> kDivShift; }

}  // namespace
