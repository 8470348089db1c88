// Grouped weight gradient over expert-sorted rows, the backward of the
// grouped matmul's f32 mode with respect to its weight stack:
//   dw[g] = x[rows of g]^T @ dy[rows of g]
// x [T, Din] and dy [T, Dout] f32, rows sorted by group, group_sizes [G]
// int32 (sum == T) -> dw [G, Din, Dout] f32; a group with no rows gets
// zeros.
//
// Replaces: no Pallas kernel. The reference differentiates
// src/repro/kernels/ops.py:grouped_matmul (jax.lax.ragged_dot) with XLA's
// transpose rule of ragged_dot; the port needs a kernel because a loop of
// per-group matmuls must read the group sizes on the host every MoE layer,
// and a one-hot form materializes T x Din x Dout.
//
// Bound on the H100: 2 T Din Dout f32 operations. At M3ViT-S's training
// batch of 64 (T = 64 x 197 x 2 = 25216 routed rows over 16 experts, fc1
// 384 -> 1536 and fc2 1536 -> 384) that is 29.7 GFLOP a call, 0.44 ms at
// the 67 TFLOP/s f32 rate; its bytes (x, dy and dw once) take 0.069 ms, so
// it is bound by operations.
//
// Design (simple first; a wgmma version is later speed work): one block of
// 256 threads per (output tile of 64 x 64, group), tiles fastest, so the
// blocks of one group run together and its rows come from L2 after the
// first read. The block finds its group's first row by summing the sizes
// before it (integer, exact), then walks the group's rows in order, 32 a
// step: the step's rows of x and dy (64 columns each) are staged in shared
// memory and every thread adds its 4 x 4 outputs' products with FMAs, row
// after row. Each output is one thread's sum in row order: the result does
// not depend on the launch, no float atomics, so a training step repeats
// bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int WG_TILE = 64;      // output tile: 64 (Din) x 64 (Dout)
constexpr int WG_ROWS = 32;      // rows of x and dy staged a step
constexpr int WG_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(WG_THREADS)
grouped_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const int* __restrict__ sizes, float* __restrict__ dw, int T,
                     int Din, int Dout, int tiles_n) {
  __shared__ __align__(16) float xs[WG_ROWS][WG_TILE];
  __shared__ __align__(16) float ds[WG_ROWS][WG_TILE];
  __shared__ int first_row;
  const int g = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_n) * WG_TILE;  // first Din row of the tile
  const int j0 = (blockIdx.x % tiles_n) * WG_TILE;  // first Dout column
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  if (tid == 0) first_row = 0;
  __syncthreads();
  int part = 0;
  for (int e = tid; e < g; e += WG_THREADS) part += sizes[e];
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((tid & 31) == 0 && part != 0) atomicAdd(&first_row, part);  // integer: exact
  __syncthreads();
  const int start = min(first_row, T);
  const int end = min(start + sizes[g], T);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = start; r0 < end; r0 += WG_ROWS) {
    // stage WG_ROWS rows x 64 columns of x and of dy; rows past the group
    // and columns past the widths are zeros (an FMA of zeros adds nothing)
    for (int e = tid; e < WG_ROWS * WG_TILE; e += WG_THREADS) {
      const int r = e / WG_TILE, c = e % WG_TILE;
      const int row = r0 + r;
      const bool in = row < end;
      xs[r][c] = (in && i0 + c < Din) ? x[static_cast<size_t>(row) * Din + i0 + c] : 0.f;
      ds[r][c] = (in && j0 + c < Dout) ? dy[static_cast<size_t>(row) * Dout + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < WG_ROWS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ds[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= Din) continue;
    float* out = dw + (static_cast<size_t>(g) * Din + row) * Dout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx * 4 + j;
      if (col < Dout) out[col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int grouped_wgrad_launch(const float* x, const float* dy, const int* sizes,
                                    float* dw, int T, int G, int Din, int Dout,
                                    cudaStream_t stream) {
  if (G < 1 || G > 65535 || T < 0 || Din < 0 || Dout < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Din == 0 || Dout == 0) return static_cast<int>(cudaSuccess);
  const int tiles_m = (Din + WG_TILE - 1) / WG_TILE;
  const int tiles_n = (Dout + WG_TILE - 1) / WG_TILE;
  grouped_wgrad_kernel<<<dim3(tiles_m * tiles_n, G), WG_THREADS, 0, stream>>>(
      x, dy, sizes, dw, T, Din, Dout, tiles_n);
  return static_cast<int>(cudaGetLastError());
}
