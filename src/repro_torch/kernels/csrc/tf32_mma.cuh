// Split-precision f32 products on the tf32 tensor cores, shared by
// lm_attention.cu (the f32 score chunks: to_tf32, split2, split3, mma_tf32)
// and grouped_matmul.cu (the f32 mode's 3xTF32 chunks: split_tf32,
// mma_tf32_zero, mma_tf32): f32 values cut into tf32 pieces rounded as
// cvt.rna rounds (10-bit mantissa, ties away from zero), and
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
//
// The pieces are exact: hi = rna(x) and x - hi is exact in f32, so hi + lo
// leaves O(2^-22 |x|) (2^-21 with lo truncated) and hi + mid + lo leaves
// nothing while the pieces are normal numbers. An m16n8k8 product's
// element (r, n) depends only on row r of A, column n of B and element
// (r, n) of C, so a sum formed chunk by chunk in one order gives a row the
// same bits wherever it sits in the tile.
#pragma once

#include <cstdint>

namespace repro {
namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), hi and lo tf32
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + mid + lo exactly, each tf32 (each difference is exact in f32, and
// what is left after two 11-bit pieces has at most 2 significant bits)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = to_tf32(x);
  const float r = x - __uint_as_float(hi);
  mid = to_tf32(r);
  lo = to_tf32(r - __uint_as_float(mid));
}

// x = hi + lo, both fed to the MMA: hi is x rounded to tf32 as cvt.rna
// rounds (half an ulp of the 10-bit mantissa added to the magnitude, then
// the 13 low bits cleared: nearest, ties away from zero) in two integer
// ops; lo = x - hi is exact in f32 and goes to the MMA as it is, which
// reads a tf32 operand's upper 19 bits (lo truncated to tf32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) . b (8 x 8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16 x 8, row) . b (8 x 8, col), tf32 in, from zero
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

}  // namespace tf32
}  // namespace repro
