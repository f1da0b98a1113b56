// PTX carry-chain steps on 32-bit words for Hopper (sm_90a), shared by the
// word arithmetic of fq_mont.cu (the Fq kernels) and ntt_hints.cu (the hint
// NTT kernels).
//
// Each helper is one PTX instruction in its own `asm volatile` statement.
// A chain is a run of them joined by the carry flag: the first step writes
// the flag (.cc), the middle steps read and write it (c ... .cc), the last
// reads it (c ...).  Nothing between two steps of a chain may write the
// flag; only PTX instructions with .cc do, and the compiler emits none for
// the caller's C++ arithmetic, while `volatile` keeps the steps in order.

#pragma once

#include <cstdint>

namespace {

using u32 = uint32_t;

// d += lo(a b), carry out
__device__ __forceinline__ void mad_lo_cc(u32& d, u32 a, u32 b) {
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b));
}
// d += lo(a b) + carry, carry out
__device__ __forceinline__ void madc_lo_cc(u32& d, u32 a, u32 b) {
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(d) : "r"(a), "r"(b));
}
// d = c + hi(a b) (+ carry), d need not be c's register
__device__ __forceinline__ void mad_hi_cc(u32& d, u32 a, u32 b, u32 c) {
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
}
__device__ __forceinline__ void madc_hi_cc(u32& d, u32 a, u32 b, u32 c) {
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
}
__device__ __forceinline__ void madc_hi(u32& d, u32 a, u32 b, u32 c) {
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
}
// d += carry
__device__ __forceinline__ void addc_zero(u32& d) {
  asm volatile("addc.u32 %0, %0, 0;" : "+r"(d));
}
// d = a + b (+ carry); d may be a's or b's register
__device__ __forceinline__ void add_cc(u32& d, u32 a, u32 b) {
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
}
__device__ __forceinline__ void addc_cc(u32& d, u32 a, u32 b) {
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
}
__device__ __forceinline__ void addc(u32& d, u32 a, u32 b) {
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
}
// d = a - b (- borrow); d may be a's or b's register
__device__ __forceinline__ void sub_cc(u32& d, u32 a, u32 b) {
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
}
__device__ __forceinline__ void subc_cc(u32& d, u32 a, u32 b) {
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
}
__device__ __forceinline__ void subc(u32& d, u32 a, u32 b) {
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
}

}  // namespace
