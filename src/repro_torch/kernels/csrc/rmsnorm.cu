// RMSNorm over the last dim: for every row of x [rows, D] (f32 or bf16;
// rows ld elements apart, so a strided view such as x[:, -1:] needs no copy),
//   y = x * rsqrt(mean(x^2) + eps) * (1 + gamma),   gamma [D] f32 or bf16,
// the sum taken in f32 and y written in x's dtype.
//
// Replaces: src/repro/models/layers.py:21, rmsnorm (plain XLA in the
// reference, not a Pallas kernel). In the port it was a chain of torch
// reductions and element-wise kernels whose row reduction chose its
// summation order by the tensor's shape: a row summed among 8 rows (a decode
// tick) and among 512 (a packed prefill) could differ in the last bit, and
// an int8 activation code downstream could then land on the other side of
// a rounding boundary.
//
// Bound on the H100: one read of x and one write of y (plus gamma). An
// OLMoE-1B-7B decode tick normalises 8 rows of 2048 (64 KB each way), a
// 512-token packed prefill 512 rows of 2048 (4.2 MB each way, ~2.5 us at
// 3.35 TB/s) and its qk-norms 8192 rows of 128; the f32 work, a few
// operations an element, is far below the bytes: bound by bytes, and at
// the tick's sizes by one launch's latency.
//
// Design: one launch a call (the torch chain was seven kernels). W warps
// share a row, W = min(8, ceil(D / 512)) from the width alone (a qk-norm
// row of 128: one warp; OLMoE's 2048: four; falcon-mamba's 4096: eight),
// so that a lane loads at most four 16-byte runs and an 8-row decode tick
// still spreads over 8 W warps. Lane l of warp w sums the elements c + 4 L
// + j (L = 32 w + l, c a multiple of 128 W, j = 0..3) in that order, each
// square rounded on its own; a fixed xor butterfly adds a warp's 32
// partial sums and the W warp sums are added in warp order through shared
// memory. The order depends on D alone, never on the number of rows, the
// block or the alignment, so a row gives the same bits in a tensor of any
// shape. Rows whose pointers are aligned (16 bytes for f32, 8 for bf16; y
// and gamma too) and D a multiple of 4 load and store four elements at
// once; the others one at a time in the same order. Where a lane's runs
// are at most RMS_MAX_RUNS (D <= 4096: every width of the port's
// configurations) they stay in registers from the sum to the store, so x is read
// once; wider rows read x again for the second pass. y = (x * r) *
// (1 + gamma), each product rounded on its own as in the plain version,
// r = 1 / sqrt(sum / D + eps) with IEEE division and square root.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "f32_io.cuh"

namespace {

using repro::narrow;
using repro::widen;

constexpr int RMS_MAX_WARPS = 8;  // warps of a row, and of a block at most
constexpr int RMS_MIN_WARPS = 4;  // warps of a block at least
constexpr int RMS_MAX_RUNS = 4;   // four-element runs a lane keeps in registers

// elements e..e+3 of a row (zeros past D); VEC: one aligned 16- or 8-byte load
template <bool VEC, typename T>
__device__ inline void load4(const T* __restrict__ row, int e, int D, float v[4]) {
  if constexpr (VEC) {
    if (e < D) {  // D % 4 == 0: the four are all in the row or all past it
      if constexpr (sizeof(T) == 4) {
        const float4 t = *reinterpret_cast<const float4*>(row + e);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else {
        const uint2 t = *reinterpret_cast<const uint2*>(row + e);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
        v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
      }
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = e + j < D ? widen(row[e + j]) : 0.f;
  }
}

// elements e..e+3 of a row that are < D, rounded to T; VEC: one store
template <bool VEC, typename T>
__device__ inline void store4(T* __restrict__ row, int e, int D, const float v[4]) {
  if constexpr (VEC) {
    if (e >= D) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(row + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 t;
      t.x = *reinterpret_cast<const unsigned*>(&lo);
      t.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(row + e) = t;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < D) row[e + j] = narrow<T>(v[j]);
  }
}

// 1 + gamma as the plain version rounds it: in gamma's own type
template <typename G>
__device__ inline float one_plus(float g) {
  const float s = __fadd_rn(1.f, g);
  if constexpr (sizeof(G) == 4) return s;
  else return __bfloat162float(__float2bfloat16_rn(s));
}

// y[e..e+3] = (x * inv) * (1 + gamma) for the four elements v of x at e
template <bool VEC, typename T, typename G>
__device__ inline void scale_store(T* __restrict__ yr, const G* __restrict__ gamma, int e,
                                   int D, float inv, const float v[4]) {
  float g[4], o[4];
  load4<VEC>(gamma, e, D, g);
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = __fmul_rn(__fmul_rn(v[j], inv), one_plus<G>(g[j]));
  store4<VEC>(yr, e, D, o);
}

// RUNS: a lane's four-element runs, ceil(D / (128 W)), kept in registers
// (1..RMS_MAX_RUNS); 0: any number, x read again for the second pass
template <typename T, typename G, bool VEC, int RUNS>
__global__ void __launch_bounds__(RMS_MAX_WARPS * 32)
    rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                   T* __restrict__ y, int rows, int D, int64_t ld, int W, float eps) {
  __shared__ float part[RMS_MAX_WARPS];  // the block's warp sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int first = warp - warp % W;  // the row's first warp in the block
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32 / W) + warp / W;
  const bool live = r < rows;  // warp-uniform
  const int L = (warp % W) * 32 + lane;
  const int step = 128 * W;
  const T* xr = x + r * ld;
  float v[RUNS > 0 ? RUNS : 1][4];
  float s = 0.f;
  if (live) {
    if constexpr (RUNS > 0) {
#pragma unroll
      for (int k = 0; k < RUNS; ++k) load4<VEC>(xr, k * step + 4 * L, D, v[k]);
#pragma unroll
      for (int k = 0; k < RUNS; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) s = __fadd_rn(s, __fmul_rn(v[k][j], v[k][j]));
    } else {
#pragma unroll 4
      for (int c = 0; c < D; c += step) {
        load4<VEC>(xr, c + 4 * L, D, v[0]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s = __fadd_rn(s, __fmul_rn(v[0][j], v[0][j]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (!live) return;
  float tot = part[first];
  for (int k = 1; k < W; ++k) tot = __fadd_rn(tot, part[first + k]);
  const float inv =
      __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(tot, static_cast<float>(D)), eps)));
  T* yr = y + r * D;
  if constexpr (RUNS > 0) {
#pragma unroll
    for (int k = 0; k < RUNS; ++k) scale_store<VEC>(yr, gamma, k * step + 4 * L, D, inv, v[k]);
  } else {
#pragma unroll 4
    for (int c = 0; c < D; c += step) {
      load4<VEC>(xr, c + 4 * L, D, v[0]);
      scale_store<VEC>(yr, gamma, c + 4 * L, D, inv, v[0]);
    }
  }
}

template <typename T, typename G, bool VEC>
void launch_vec(const T* x, const G* gamma, T* y, int rows, int D, int64_t ld, int W,
                float eps, cudaStream_t stream) {
  const int warps = std::max(RMS_MIN_WARPS, W);
  const dim3 grid((rows + warps / W - 1) / (warps / W));
  const int runs = (D + 128 * W - 1) / (128 * W);
  switch (runs <= RMS_MAX_RUNS ? runs : 0) {
#define RMS_CASE(R)                                                                      \
  case R:                                                                                \
    rmsnorm_kernel<T, G, VEC, R><<<grid, warps * 32, 0, stream>>>(x, gamma, y, rows, D, \
                                                                  ld, W, eps);           \
    break;
    RMS_CASE(1) RMS_CASE(2) RMS_CASE(3) RMS_CASE(4) RMS_CASE(0)
#undef RMS_CASE
  }
}

template <typename T, typename G>
void launch(const void* x, const void* gamma, void* y, int rows, int D, int64_t ld,
            float eps, bool vec, cudaStream_t stream) {
  const int W = std::min(RMS_MAX_WARPS, std::max(1, (D + 511) / 512));  // D alone
  const T* xp = static_cast<const T*>(x);
  const G* gp = static_cast<const G*>(gamma);
  T* yp = static_cast<T*>(y);
  if (vec) launch_vec<T, G, true>(xp, gp, yp, rows, D, ld, W, eps, stream);
  else launch_vec<T, G, false>(xp, gp, yp, rows, D, ld, W, eps, stream);
}

}  // namespace

// x_bf16 / gamma_bf16: 0 for f32, 1 for bf16; ld: x's row stride in
// elements (y is written densely). The four-at-once loads and stores are
// taken when D and ld are multiples of 4 and x, y and gamma are aligned to
// four elements.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* y, int rows,
                              int D, long long ld, int x_bf16, int gamma_bf16, float eps,
                              cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  auto al = [](const void* p, int elem) { return reinterpret_cast<uintptr_t>(p) % (4 * elem) == 0; };
  const int xe = x_bf16 ? 2 : 4;
  const bool vec = D % 4 == 0 && ld % 4 == 0 && al(x, xe) && al(y, xe) &&
                   al(gamma, gamma_bf16 ? 2 : 4);
  if (x_bf16) {
    if (gamma_bf16) launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, y, rows, D, ld, eps, vec, stream);
    else launch<__nv_bfloat16, float>(x, gamma, y, rows, D, ld, eps, vec, stream);
  } else {
    if (gamma_bf16) launch<float, __nv_bfloat16>(x, gamma, y, rows, D, ld, eps, vec, stream);
    else launch<float, float>(x, gamma, y, rows, D, ld, eps, vec, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
