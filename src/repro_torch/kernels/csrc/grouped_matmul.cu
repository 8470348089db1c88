// Grouped matmul over expert-sorted rows: y[t] = x[t] @ w[g(t)], for the
// rows t of each group g given by group_sizes (MoE expert fc1/fc2).
//   int8 mode: int8 x, int8 w -> (float(acc) * w_scale[g, n]) * a_scale
//   f32 mode:  f32 x, f32 w   -> f32 FMA sum
//
// Replaces: src/repro/kernels/expert_linear.py, grouped_matmul / _gmm_kernel
// (fp32 and int8 modes; the W4A8 nibble-packed mode is not ported yet).
//
// Bound on the H100: at M3ViT-S (T = 2 * 197 B routed rows, G = 16 experts,
// 384 -> 1536 and 1536 -> 384) the int8 work, 2 T Din Dout operations, is
// ~3.7 GOP at B = 8, ~2 us at the int8 tensor-core rate, against ~9.4 MB of
// expert weights plus ~19 MB of f32 output, ~8.5 us at 3.35 TB/s: bound by
// bytes. The f32 mode (calibration) is bound by f32 operations.
//
// Design: the work table (one item per (group, 64-row tile) pair that holds
// rows of the group, padded to the static length ceil(T/64) + G) is built
// on the device by the wrapper, so the launch needs no host sync. One block
// owns one (work item, 64-column tile): it reads the expert's weight tile
// once for all of the group's rows in its row tile, masks the rows of other
// groups to zero on the way into shared memory and writes only its group's
// rows. Every output row belongs to exactly one group, so each output
// element is written by exactly one block, with no accumulator carried
// between blocks (the TPU kernel's cross-step VMEM accumulator is not
// needed). Padding items and T = 0 launch nothing that writes.
#include <cuda_runtime.h>

#include "int8_tile.cuh"

namespace {

constexpr int F_BM = repro::I8_BM;  // the work table's row tile is shared
constexpr int F_BN = 64;
constexpr int F_BK = 16;
constexpr int F_THREADS = 256;

struct WorkItem {
  int g, row_lo, row_hi, m0;
};

// The rows [row_lo, row_hi) of one work item: its group's rows inside its
// 64-row tile. Empty for the padding items.
__device__ inline WorkItem work_item(const int* g_ids, const int* m_ids,
                                     const int* row_start, const int* row_end,
                                     int block_m) {
  const int wk = blockIdx.x;
  WorkItem it;
  it.g = g_ids[wk];
  it.m0 = m_ids[wk] * block_m;
  it.row_lo = max(row_start[wk], it.m0);
  it.row_hi = min(row_end[wk], it.m0 + block_m);
  return it;
}

__global__ void __launch_bounds__(repro::I8_THREADS)
    gmm_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const int* __restrict__ g_ids, const int* __restrict__ m_ids,
                  const int* __restrict__ row_start,
                  const int* __restrict__ row_end,
                  const float* __restrict__ w_scale,
                  const float* __restrict__ a_scale, float* __restrict__ out,
                  int Din, int Dout) {
  __shared__ repro::I8Smem sm;
  const WorkItem it = work_item(g_ids, m_ids, row_start, row_end, repro::I8_BM);
  if (it.row_lo >= it.row_hi) return;  // block-uniform
  const int n0 = blockIdx.y * repro::I8_BN;
  int acc[4][4] = {};
  repro::i8_tile_mainloop(x, w + (size_t)it.g * Din * Dout, Din, Dout, it.m0,
                          it.row_lo, it.row_hi, n0, sm, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = it.m0 + ty + 16 * i;
    if (row < it.row_lo || row >= it.row_hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= Dout) continue;
      float y = __int2float_rn(acc[i][j]);
      if (w_scale != nullptr) y = __fmul_rn(y, w_scale[(size_t)it.g * Dout + col]);
      if (a_scale != nullptr) y = __fmul_rn(y, *a_scale);
      out[(size_t)row * Dout + col] = y;
    }
  }
}

__global__ void __launch_bounds__(F_THREADS)
    gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ g_ids, const int* __restrict__ m_ids,
                   const int* __restrict__ row_start,
                   const int* __restrict__ row_end, float* __restrict__ out,
                   int Din, int Dout) {
  __shared__ float xs[F_BK][F_BM + 1];  // X tile transposed: k-major
  __shared__ float ws[F_BK][F_BN];
  const WorkItem it = work_item(g_ids, m_ids, row_start, row_end, F_BM);
  if (it.row_lo >= it.row_hi) return;  // block-uniform
  const int n0 = blockIdx.y * F_BN;
  const float* wg = w + (size_t)it.g * Din * Dout;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Din; k0 += F_BK) {
    for (int e = tid; e < F_BM * F_BK; e += F_THREADS) {
      const int r = e / F_BK, kk = e % F_BK;
      const int row = it.m0 + r, k = k0 + kk;
      xs[kk][r] = (row >= it.row_lo && row < it.row_hi && k < Din)
                      ? x[(size_t)row * Din + k]
                      : 0.f;
    }
    for (int e = tid; e < F_BK * F_BN; e += F_THREADS) {
      const int kk = e / F_BN, c = e % F_BN;
      const int k = k0 + kk, col = n0 + c;
      ws[kk][c] = (k < Din && col < Dout) ? wg[(size_t)k * Dout + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = it.m0 + ty + 16 * i;
    if (row < it.row_lo || row >= it.row_hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Dout) out[(size_t)row * Dout + col] = acc[i][j];
    }
  }
}

}  // namespace

// block_m must be the row tile the work table was built with; any other
// value is refused (cudaErrorInvalidValue) rather than computed wrongly.
extern "C" int grouped_matmul_i8_launch(
    const int8_t* x, const int8_t* w, const int* g_ids, const int* m_ids,
    const int* row_start, const int* row_end, const float* w_scale,
    const float* a_scale, float* out, int Din, int Dout, int n_work,
    int block_m, cudaStream_t stream) {
  if (block_m != repro::I8_BM) return static_cast<int>(cudaErrorInvalidValue);
  if (n_work > 0 && Dout > 0) {
    dim3 grid(n_work, (Dout + repro::I8_BN - 1) / repro::I8_BN);
    gmm_i8_kernel<<<grid, repro::I8_THREADS, 0, stream>>>(
        x, w, g_ids, m_ids, row_start, row_end, w_scale, a_scale, out, Din,
        Dout);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grouped_matmul_f32_launch(const float* x, const float* w,
                                         const int* g_ids, const int* m_ids,
                                         const int* row_start,
                                         const int* row_end, float* out,
                                         int Din, int Dout, int n_work,
                                         int block_m, cudaStream_t stream) {
  if (block_m != F_BM) return static_cast<int>(cudaErrorInvalidValue);
  if (n_work > 0 && Dout > 0) {
    dim3 grid(n_work, (Dout + F_BN - 1) / F_BN);
    gmm_f32_kernel<<<grid, F_THREADS, 0, stream>>>(
        x, w, g_ids, m_ids, row_start, row_end, out, Din, Dout);
  }
  return static_cast<int>(cudaGetLastError());
}
