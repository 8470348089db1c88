// W8A8 GEMM: int8 x[M, K] @ int8 w[K, N] -> f32 out[M, N],
//   out = float(acc) * (x_scale * w_scale[n]) (+ bias[n]).
//
// Replaces: src/repro/kernels/int8_matmul.py, int8_matmul / _int8_mm_kernel.
//
// Bound on the H100: at the M3ViT-S shapes (M = 197 B, K in {384, 1536},
// N in {16, 384, 1000, 1536}) the work is 2MNK int8 operations, ~1.9 GOP at
// the largest, under a microsecond at the tensor-core int8 rate, while the
// f32 output alone is 4MN bytes (9.7 MB at M = 1576, N = 1536), ~3 us at
// 3.35 TB/s: the kernel is bound by the bytes it writes.
//
// Design: one 64 x 64 output tile per block, int8 operands staged through
// shared memory and multiplied with __dp4a into int32 registers
// (int8_tile.cuh), so no int32 or f32 copy of an operand ever reaches device
// memory and each output is written once, as f32, by the flush. The flush
// applies the single product-of-scales rescale of Eq. 9 in the reference's
// order with the rounding intrinsics (no FMA contraction), so the result is
// bit-equal to the plain version. tensor-core MMA (mma.sync / wgmma) and TMA
// staging are later work.
#include <cuda_runtime.h>

#include "int8_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::I8_THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int M, int N, int K) {
  __shared__ repro::I8Smem sm;
  const int n0 = blockIdx.x * repro::I8_BN;
  const int m0 = blockIdx.y * repro::I8_BM;
  int acc[4][4] = {};
  repro::i8_tile_mainloop(x, w, K, N, m0, 0, M, n0, sm, acc);
  const float xs = *x_scale;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float y = __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(xs, w_scale[col]));
      if (bias != nullptr) y = __fadd_rn(y, bias[col]);
      out[(size_t)row * N + col] = y;
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const int8_t* x, const int8_t* w,
                                  const float* x_scale, const float* w_scale,
                                  const float* bias, float* out, int M, int N,
                                  int K, cudaStream_t stream) {
  if (M > 0 && N > 0) {
    dim3 grid((N + repro::I8_BN - 1) / repro::I8_BN,
              (M + repro::I8_BM - 1) / repro::I8_BM);
    int8_matmul_kernel<<<grid, repro::I8_THREADS, 0, stream>>>(
        x, w, x_scale, w_scale, bias, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
