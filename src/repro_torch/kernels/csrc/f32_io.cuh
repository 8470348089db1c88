// f32 arithmetic over f32 or bf16 storage: widen on load, round once on
// store (the plain versions compute in f32 and cast the result to x's type).
#pragma once

#include <cuda_bf16.h>

namespace repro {

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ inline T narrow(float v);
template <>
__device__ inline float narrow<float>(float v) { return v; }
template <>
__device__ inline __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace repro
