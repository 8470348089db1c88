// Grouped weight gradient over expert-sorted rows, the backward of the
// grouped matmul's f32 mode with respect to its weight stack:
//   dw[g] = x[rows of g]^T @ dy[rows of g]
// x [T, Din] and dy [T, Dout] f32, rows sorted by group, group_sizes [G]
// int32 (sum == T) -> dw [G, Din, Dout] f32; a group with no rows gets
// zeros. Two variants, chosen per call by expert_linear.choose_wgrad_variant:
// variant 1, mma (3xTF32 on the tensor cores, the heaviest group first;
// Din % 4 == 0, Dout % 4 == 0, every operand on the 16-byte grid: the
// training path), and variant 2, fma
// (the first design, f32 FMAs on the CUDA cores: any width).
//
// Replaces: src/repro/kernels/ops.py:233, which is no Pallas kernel: the
// reference differentiates ops.grouped_matmul (jax.lax.ragged_dot) with
// XLA's transpose rule of ragged_dot. The port needs a kernel because a loop
// of per-group matmuls must read the group sizes on the host every MoE
// layer, and a one-hot form materializes T x Din x Dout.
//
// Bound on the H100: 2 T Din Dout operations. At M3ViT-S's training batch
// of 64 (T = 64 x 197 x 2 = 25216 routed rows over 16 experts, fc1 384 ->
// 1536 and fc2 1536 -> 384) that is 29.7 GFLOP a call: 0.44 ms at the 67
// TFLOP/s of f32 FMAs, 0.18 ms as three tf32 passes at 495 TFLOP/s; its
// bytes (x, dy and dw once) take 0.069 ms, so it is bound by operations.
//
// Variant 1, mma (the training path):
//   Bound on the H100: 3 x 2 T Din Dout tf32 operations at 495 TFLOP/s
//   (0.18 ms at the M3ViT-S shapes). The mma.sync route is held by the
//   issue rate of m16n8k8.tf32 and the splits around it: on an H100 it ran
//   those shapes at ~175 TFLOP/s of tf32 work, 0.51 ms a call, 2.8x this
//   bound (and 87% of the 0.44 ms f32 FMA bound; PERF.md); wgmma is the way
//   to the rest.
//   Design: a (Din, Dout) output tile of 64 x 64 per block of 4 warps (32 x
//   32 each), the rows of its group as the contraction. The rows stream
//   through a 3-stage cp.async ring of 32-row stages (x and dy, 64 columns
//   each, rows padded to 72 floats so that every 16-byte fragment load of
//   a phase touches 32 distinct banks), the next stages loading while the
//   current one multiplies. K is the row axis, so both operands lie K-major
//   only as stored transposed: the fragments are read as they lie (a lane
//   reads x[row][4 g .. 4 g + 3] and dy[row][4 g .. 4 g + 3] as one float4
//   each, the warp's 32 Din indices permuted so that these four are rows g
//   and g + 8 of its two m16 tiles, and its 32 Dout indices so that they
//   are column g of its four n8 tiles), a layout wgmma does not take for
//   tf32 without a transposing copy in shared memory, hence mma.sync. Each
//   value is cut into tf32 hi + lo (tf32_mma.cuh's split_tf32) and a
//   stage's products are the m16n8k8 MMAs lo.hi + hi.lo + hi.hi over its
//   four k8 chunks, accumulated from zero in the MMA and added to the f32
//   sum with __fadd_rn (lo.lo, ~2^-22 of a product, is dropped), stage
//   after stage in row order.
//   Schedule: one block per (output tile, group), the group's rows summed
//   in row order, stage after stage, and written straight to dw: no float
//   atomics and no scratch, so the same inputs give the same bits and a
//   training step repeats bit for bit. The grid is (tiles, G), tiles
//   fastest, and row y of blocks takes the group of rank y in heaviest-
//   first order (sizes descending, ties by index), which each block derives
//   from group_sizes in shared memory (G <= MW_RANKED; beyond, group y):
//   the card hands out blocks in that order, so the longest items start
//   first and the short ones fill in behind them. At M3ViT-S's routing (one
//   expert at ~4.3x the mean, 6745 of 25216 rows, chip_smoke._wgrad_sizes)
//   the skewed expert's 144 fc1 blocks are the first 144 of the grid: they
//   run from the start beside the rest, so it does not set the tail (on an
//   H100 fc1 took 0.51 ms a call so, 0.54-0.56 ms with the groups in index
//   order; PERF.md). An empty group's blocks stage nothing and write zeros.
//
// Variant 2, fma (ragged or misaligned widths: WGRAD_RAGGED's 100 x 70):
//   Bound on the H100: as the call, 2 T Din Dout f32 operations at the 67
//   TFLOP/s of f32 FMAs.
//   Design: the first design, kept for the shapes variant 1 does not take:
//   one block of 256 threads per (output tile of 64 x 64, group), tiles
//   fastest, so the blocks of one group run together and its rows come from
//   L2 after the first read. The block finds its group's first row by
//   summing the sizes before it (integer, exact), then walks the group's
//   rows in order, 32 a step: the step's rows of x and dy (64 columns each)
//   are staged in shared memory and every thread adds its 4 x 4 outputs'
//   products with FMAs, row after row. Each output is one thread's sum in
//   row order (its skewed group's blocks walk all of its rows, and set the
//   tail: 1.2 ms at the M3ViT-S shapes on an H100, PERF.md).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "int8_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using repro::mma8::cp_async;
using repro::mma8::cp_async_commit;
using repro::mma8::cp_async_wait;
using repro::mma8::smem_u32;
using namespace repro::tf32;

// ---------------------------------------------------------------------------
// variant 2, fma: the first design
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// variant 1, mma: 3xTF32 tiles, heaviest group first
// ---------------------------------------------------------------------------

constexpr int MW_TILE = 64;     // output tile: 64 (Din) x 64 (Dout)
constexpr int MW_ROWS = 32;     // rows a stage: four k8 chunks
constexpr int MW_LD = MW_TILE + 8;  // a staged row, padded: 288 bytes
constexpr int MW_THREADS = 128;     // 2 x 2 warps of 32 x 32 outputs
constexpr int MW_STAGES = 3;
constexpr int MW_BLOCKS = 4;  // blocks an SM: 54 KB of ring and <= 128 registers each
constexpr int MW_STAGE_FLOATS = 2 * MW_ROWS * MW_LD;  // x then dy
constexpr int MW_SMEM = MW_STAGES * MW_STAGE_FLOATS * 4;  // 55,296 bytes
constexpr int MW_RANKED = 256;  // groups ordered heaviest first (expert_linear.WGRAD_RANKED)

// Rows [r0, r0 + 32) of x (64 columns from i0) and dy (64 from j0) into a
// stage; rows at or past hi and columns past the widths are zero-filled.
__device__ __forceinline__ void wgrad_load_stage(uint32_t st, const float* __restrict__ x,
                                                 const float* __restrict__ dy, int Din,
                                                 int Dout, int i0, int j0, int r0, int hi) {
  constexpr int COPIES = MW_ROWS * (MW_TILE / 4);  // 16-byte copies an operand
#pragma unroll
  for (int i = 0; i < COPIES / MW_THREADS; ++i) {
    const int e = threadIdx.x + i * MW_THREADS;
    const int r = e >> 4, c = e & 15;
    const int row = r0 + r;
    const uint32_t at = 4 * (r * MW_LD + 4 * c);
    const bool okx = row < hi && i0 + 4 * c < Din;
    cp_async<16>(st + at, okx ? x + static_cast<size_t>(row) * Din + i0 + 4 * c : x, okx);
    const bool okd = row < hi && j0 + 4 * c < Dout;
    cp_async<16>(st + 4 * MW_ROWS * MW_LD + at,
                 okd ? dy + static_cast<size_t>(row) * Dout + j0 + 4 * c : dy, okd);
  }
}

// One stage for a warp: its 2 x 4 tiles' products over the stage's 32 rows,
// lo.hi + hi.lo + hi.hi a k8 chunk, from zero, then added to the sums. Lane
// (g, t) reads x[8 kk + t (+ 4)][32 wm + 4 g .. + 3]: element 2 i + h is Din
// row g + 8 h of m16 tile i; and dy[8 kk + t (+ 4)][32 wn + 4 g .. + 3]:
// element j is Dout column g of n8 tile j.
__device__ __forceinline__ void wgrad_stage(float (&acc)[2][4][4], const float* xs,
                                            const float* ds, int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* xa = xs + t * MW_LD + wm * 32 + 4 * g;
  const float* db = ds + t * MW_LD + wn * 32 + 4 * g;
  float c[2][4][4];
#pragma unroll
  for (int kk = 0; kk < MW_ROWS / 8; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(xa + 8 * kk * MW_LD);
    const float4 a1 = *reinterpret_cast<const float4*>(xa + (8 * kk + 4) * MW_LD);
    const float4 b0 = *reinterpret_cast<const float4*>(db + 8 * kk * MW_LD);
    const float4 b1 = *reinterpret_cast<const float4*>(db + (8 * kk + 4) * MW_LD);
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
    split_tf32(a0.x, ah[0][0], al[0][0]);
    split_tf32(a0.y, ah[0][1], al[0][1]);
    split_tf32(a1.x, ah[0][2], al[0][2]);
    split_tf32(a1.y, ah[0][3], al[0][3]);
    split_tf32(a0.z, ah[1][0], al[1][0]);
    split_tf32(a0.w, ah[1][1], al[1][1]);
    split_tf32(a1.z, ah[1][2], al[1][2]);
    split_tf32(a1.w, ah[1][3], al[1][3]);
    split_tf32(b0.x, bh[0][0], bl[0][0]);
    split_tf32(b0.y, bh[1][0], bl[1][0]);
    split_tf32(b0.z, bh[2][0], bl[2][0]);
    split_tf32(b0.w, bh[3][0], bl[3][0]);
    split_tf32(b1.x, bh[0][1], bl[0][1]);
    split_tf32(b1.y, bh[1][1], bl[1][1]);
    split_tf32(b1.z, bh[2][1], bl[2][1]);
    split_tf32(b1.w, bh[3][1], bl[3][1]);
    // pass by pass, so that the eight tiles' MMA chains overlap
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kk == 0) mma_tf32_zero(c[i][j], al[i], bh[j][0], bh[j][1]);
        else mma_tf32(c[i][j], al[i], bh[j][0], bh[j][1]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(c[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(c[i][j], ah[i], bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], c[i][j][e]);
}

__global__ void __launch_bounds__(MW_THREADS, MW_BLOCKS)
grouped_wgrad_mma_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         const int* __restrict__ sizes, float* __restrict__ dw, int T,
                         int G, int Din, int Dout, int tiles_n) {
  extern __shared__ __align__(128) float smem[];
  __shared__ int ranked[MW_RANKED];
  __shared__ int warp_rows[MW_THREADS / 32];
  const int i0 = (blockIdx.x / tiles_n) * MW_TILE;  // first Din row of the tile
  const int j0 = (blockIdx.x % tiles_n) * MW_TILE;  // first Dout column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;

  // the group of rank blockIdx.y, heaviest first (ties: the lower index)
  int g = blockIdx.y;
  if (G <= MW_RANKED) {
    for (int e = threadIdx.x; e < G; e += MW_THREADS) ranked[e] = sizes[e];
    __syncthreads();
    for (int e = threadIdx.x; e < G; e += MW_THREADS) {
      const int n = ranked[e];
      int rank = 0;
      for (int f = 0; f < G; ++f) rank += ranked[f] > n || (ranked[f] == n && f < e);
      if (rank == g) warp_rows[0] = e;  // one thread a block: the ranks are a permutation
    }
    __syncthreads();
    g = warp_rows[0];
    __syncthreads();
  }
  // the group's first row: the sum of the sizes before it (integer, exact)
  int before = 0;
  for (int e = threadIdx.x; e < g; e += MW_THREADS) before += sizes[e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  if (lane == 0) warp_rows[warp] = before;
  __syncthreads();
  int lo = 0;
#pragma unroll
  for (int w = 0; w < MW_THREADS / 32; ++w) lo += warp_rows[w];
  lo = min(lo, T);
  const int hi = min(lo + sizes[g], T);
  const int stages = (hi - lo + MW_ROWS - 1) / MW_ROWS;

  const uint32_t s0 = smem_u32(smem);
  float acc[2][4][4] = {};
#pragma unroll
  for (int s = 0; s < MW_STAGES - 1; ++s) {
    if (s < stages)
      wgrad_load_stage(s0 + 4 * s * MW_STAGE_FLOATS, x, dy, Din, Dout, i0, j0,
                       lo + s * MW_ROWS, hi);
    cp_async_commit();
  }
  for (int kt = 0; kt < stages; ++kt) {
    cp_async_wait<MW_STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    const int nxt = kt + MW_STAGES - 1;
    if (nxt < stages)
      wgrad_load_stage(s0 + 4 * (nxt % MW_STAGES) * MW_STAGE_FLOATS, x, dy, Din, Dout, i0,
                       j0, lo + nxt * MW_ROWS, hi);
    cp_async_commit();
    const float* xs = smem + (kt % MW_STAGES) * MW_STAGE_FLOATS;
    wgrad_stage(acc, xs, xs + MW_ROWS * MW_LD, wm, wn);
  }
  cp_async_wait<0>();

  // accumulator e of tiles (i, j) is Din row 32 wm + 4 g + 2 i + (e >> 1),
  // Dout column 32 wn + 8 t + 4 (e & 1) + j: a lane writes two float4 a Din
  // row (Dout % 4 == 0: all four columns or none)
  const int g4 = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + wm * 32 + 4 * g4 + 2 * i + h;
      if (row >= Din) continue;
      float* out = dw + (static_cast<size_t>(g) * Din + row) * Dout;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = j0 + wn * 32 + 8 * t + 4 * p;
        if (col < Dout)
          *reinterpret_cast<float4*>(out + col) =
              make_float4(acc[i][0][2 * h + p], acc[i][1][2 * h + p], acc[i][2][2 * h + p],
                          acc[i][3][2 * h + p]);
      }
    }
}

}  // namespace

extern "C" int grouped_wgrad_launch(const float* x, const float* dy, const int* sizes,
                                    float* dw, int T, int G, int Din, int Dout, int variant,
                                    cudaStream_t stream) {
  if (G < 1 || G > 65535 || T < 0 || Din < 0 || Dout < 0 || variant < 1 || variant > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Din == 0 || Dout == 0) return static_cast<int>(cudaSuccess);
  const int tiles_m = (Din + WG_TILE - 1) / WG_TILE;
  const int tiles_n = (Dout + WG_TILE - 1) / WG_TILE;
  if (variant == 2) {
    grouped_wgrad_kernel<<<dim3(tiles_m * tiles_n, G), WG_THREADS, 0, stream>>>(
        x, dy, sizes, dw, T, Din, Dout, tiles_n);
    return static_cast<int>(cudaGetLastError());
  }
  if (Din % 4 != 0 || Dout % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_wgrad_mma_kernel<<<dim3(tiles_m * tiles_n, G), MW_THREADS, MW_SMEM, stream>>>(
      x, dy, sizes, dw, T, G, Din, Dout, tiles_n);
  return static_cast<int>(cudaGetLastError());
}
