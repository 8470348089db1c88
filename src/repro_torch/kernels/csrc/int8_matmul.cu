// W8A8 GEMM: int8 x[M, K] @ int8 w[K, N] -> f32 out[M, N],
//   out = float(acc) * (x_scale * w_scale[n]) (+ bias[n]).
//
// Replaces: src/repro/kernels/int8_matmul.py, int8_matmul / _int8_mm_kernel.
//
// Three variants of the same function, chosen per call by the wrapper
// (kernels/int8_matmul.py) from M, K, N and the operands' alignment. Each
// accumulates exactly in int32 (127^2 * K < 2^31 for K < 133,000, so any
// summation order gives the same integer) and flushes with the rounding
// intrinsics in the plain version's order (no FMA contraction), so every
// variant is bit-equal to kernels/ref.py:int8_matmul_ref.
//
// Variant 1, mma (M > 16: prefill, vision, calibration):
//   Bound on the H100: 2MNK int8 operations at 1,979 TOP/s against
//   MK + KN + 4MN bytes at 3.35 TB/s. At the M3ViT-S shapes (M = 197 B,
//   K in {384, 1536}, N in {16, 384, 1536}) the f32 output dominates the
//   bytes (9.7 MB at M = 1576, N = 1536, ~3 us; 1.9 GOP is ~1 us): bound by
//   the bytes it writes. At an OLMoE prefill ([512, 2048, 2048]) the bytes
//   (9.4 MB, ~2.8 us) still outweigh the 4.3 GOP (~2.2 us); the 512-row LM
//   head ([512, 2048, 50304]: 105 GOP, 53 us; 206 MB, 62 us) is close to
//   both.
//   Design: int8_mma.cuh. A BM x BN output tile per block (128 x 128, 64 x 64
//   or 32 x 64, the largest that still gives one block per SM), warps of
//   m16n8k32 s8 tensor-core MMAs; x and w staged 64 k-bytes at a time by
//   16-byte (8 when N % 16 == 8) cp.async into a ring of 4 stages in dynamic
//   shared memory, so loads overlap the MMAs with one __syncthreads a stage.
//   The weight is staged N-major, as it lies in the tree, and transposed to
//   the MMA's k-contiguous columns as fragments are read (ldmatrix.trans
//   over a permuted set of k rows, then two byte_perm per pair of words; the
//   header explains it), so no transposed copy of the weight exists. The
//   accumulators of an even and an odd n8 tile are 4 adjacent columns, so the
//   flush writes one 16-byte store per row and 4 columns. Blocks walk M
//   fastest, so the M tiles that share a weight tile run together and the
//   weight is read from device memory about once.
//
// Variant 2, stream (M <= 16: the OLMoE decode tick, bucket-1 and the
// M3ViT-S head, every LM head of an admission):
//   Bound on the H100: the weight bytes. A decode call reads K N bytes of
//   weight for 2MNK operations with M <= 16: 4.2 MB for an OLMoE q/k/v/o
//   projection (1.25 us at 3.35 TB/s), 103 MB for its LM head (31 us); the
//   int8 rate would take a fraction of a microsecond.
//   Design: a block of 8 warps streams a 64-column strip of w over a range
//   of k through a ring of 8 stages (16-byte cp.async, 28 KB in flight a
//   block, several blocks a SM), with the <= 16 rows of x staged beside each
//   stage. Each warp multiplies one 16-column slice over one half of each
//   stage (M padded to 16 rows, the same MMA fragments as variant 1), and the
//   two halves are summed in shared memory. When the strips alone would not
//   fill the card, k is split over blocks (gridDim.y): each block adds its
//   int32 partial sums into a workspace with atomics (exact), and the last
//   block of a strip to arrive (a counter) reads the totals back while
//   zeroing them, flushes, and resets the counter. One launch, no memset:
//   the workspace is zero again when the kernel ends.
//
// Variant 3, dp4a (what neither takes: K % 16 != 0, N % 8 != 0, or an
// operand not 16-byte aligned; never on the serving paths):
//   Bound on the H100: as variant 1; on CUDA cores the dp4a tiles stay many
//   times above it (PERF.md's table), which is why the serving paths avoid
//   them.
//   Design: one 64 x 64 output tile per block, int8 operands staged through
//   shared memory a byte at a time and multiplied with __dp4a into int32
//   registers (int8_tile.cuh); each output written once by the flush.
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "int8_tile.cuh"

namespace {

using namespace repro::mma8;

constexpr int MMA_STAGES = 4;
constexpr int STREAM_STAGES = 8;
constexpr int STREAM_BN = 64;
constexpr int STREAM_THREADS = 256;

// ---------------------------------------------------------------------------
// variant 1
// ---------------------------------------------------------------------------

template <int BM, int BN, int WM, int WN, int CW>
__global__ void __launch_bounds__(WM * WN * 32, WM * WN * 32 == 256 ? 2 : 4)
    int8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ x_scale,
                    const float* __restrict__ w_scale,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int N, int K) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  constexpr int MT = TM / 16, NS = TN / 16;  // m16 tiles, 16-column slices
  constexpr int A_BYTES = BM * BK, STAGE = A_BYTES + BK * BN;
  extern __shared__ __align__(128) int8_t smem[];
  const uint32_t s0 = smem_u32(smem);
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ktiles = (K + BK - 1) / BK;
  int acc[MT][NS][8] = {};

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < ktiles) {
      load_x<BM, THREADS>(s0 + s * STAGE, x, M, K, m0, s * BK);
      load_w<BN, CW, THREADS>(s0 + s * STAGE + A_BYTES, w, N, K, n0, s * BK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free for reuse
    const int next = kt + MMA_STAGES - 1;
    if (next < ktiles) {
      const uint32_t sn = s0 + (next % MMA_STAGES) * STAGE;
      load_x<BM, THREADS>(sn, x, M, K, m0, next * BK);
      load_w<BN, CW, THREADS>(sn + A_BYTES, w, N, K, n0, next * BK);
    }
    cp_async_commit();
    const uint32_t sa = s0 + (kt % MMA_STAGES) * STAGE, sb = sa + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4], b[NS][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) frag_a(sa, wm * TM + 16 * i, kk, a[i]);
#pragma unroll
      for (int j = 0; j < NS; ++j) frag_b<BN>(sb, wn * NS + j, kk, b[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j) mma_slice(acc[i][j], a[i], b[j]);
    }
  }

  const float xs = *x_scale;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int col = n0 + wn * TN + 16 * j + 4 * t;
    if (col >= N) continue;
    const float4 ws = *reinterpret_cast<const float4*>(w_scale + col);
    const bool has_bias = bias != nullptr;
    const float4 bv = has_bias ? *reinterpret_cast<const float4*>(bias + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = m0 + wm * TM + 16 * i + g;
      const int* c = acc[i][j];
      if (row < M) flush4(out, row, col, N, c[0], c[4], c[1], c[5], xs, ws, has_bias, bv);
      if (row + 8 < M)
        flush4(out, row + 8, col, N, c[2], c[6], c[3], c[7], xs, ws, has_bias, bv);
    }
  }
}

// ---------------------------------------------------------------------------
// variant 2
// ---------------------------------------------------------------------------

template <int CW>
__global__ void __launch_bounds__(STREAM_THREADS)
    int8_stream_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int* __restrict__ work, int* __restrict__ arrivals, int M,
                       int N, int K, int splits, int kt_per_split) {
  constexpr int A_BYTES = 16 * BK, STAGE = A_BYTES + BK * STREAM_BN;
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int is_last;
  const uint32_t s0 = smem_u32(smem);
  const int warp = threadIdx.x >> 5, slice = warp & 3, half = warp >> 2;
  const int n0 = blockIdx.x * STREAM_BN;
  const int ktiles = (K + BK - 1) / BK;
  const int kt0 = blockIdx.y * kt_per_split;
  const int steps = max(0, min(kt_per_split, ktiles - kt0));
  int acc[8] = {};

#pragma unroll
  for (int s = 0; s < STREAM_STAGES - 1; ++s) {
    if (s < steps) {
      load_x<16, STREAM_THREADS>(s0 + s * STAGE, x, M, K, 0, (kt0 + s) * BK);
      load_w<STREAM_BN, CW, STREAM_THREADS>(s0 + s * STAGE + A_BYTES, w, N, K, n0,
                                            (kt0 + s) * BK);
    }
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STREAM_STAGES - 2>();
    __syncthreads();
    const int next = st + STREAM_STAGES - 1;
    if (next < steps) {
      const uint32_t sn = s0 + (next % STREAM_STAGES) * STAGE;
      load_x<16, STREAM_THREADS>(sn, x, M, K, 0, (kt0 + next) * BK);
      load_w<STREAM_BN, CW, STREAM_THREADS>(sn + A_BYTES, w, N, K, n0,
                                            (kt0 + next) * BK);
    }
    cp_async_commit();
    const uint32_t sa = s0 + (st % STREAM_STAGES) * STAGE;
    uint32_t a[4], b[4];
    frag_a(sa, 0, 32 * half, a);
    frag_b<STREAM_BN>(sa + A_BYTES, slice, 32 * half, b);
    mma_slice(acc, a, b);
  }

  // the two k halves of each slice meet in shared memory
  cp_async_wait<0>();
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);
  const int lane = threadIdx.x & 31;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red[i * 128 + slice * 32 + lane] = acc[i];
  }
  __syncthreads();
  const int g = lane >> 2, t = lane & 3;
  const int col = n0 + 16 * slice + 4 * t;
  const bool live = half == 0 && col < N;
  if (half == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += red[i * 128 + slice * 32 + lane];
  }
  // accumulator i of this lane lies at row g + 8 ((i >> 1) & 1) and column
  // col + ((i >> 2) & 1) + 2 (i & 1) (even tile d0..d3, then odd tile d0..d3)
  auto cell = [&](int i) { return work + (size_t)(g + 8 * ((i >> 1) & 1)) * N + col
                                  + ((i >> 2) & 1) + 2 * (i & 1); };
  if (splits > 1) {
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (g + 8 * ((i >> 1) & 1) < M) atomicAdd(cell(i), acc[i]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(arrivals + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (g + 8 * ((i >> 1) & 1) < M) acc[i] = atomicExch(cell(i), 0);
    }
    if (threadIdx.x == 0) arrivals[blockIdx.x] = 0;
  }
  if (!live) return;
  const float xs = *x_scale;
  const float4 ws = *reinterpret_cast<const float4*>(w_scale + col);
  const bool has_bias = bias != nullptr;
  const float4 bv = has_bias ? *reinterpret_cast<const float4*>(bias + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < M) flush4(out, g, col, N, acc[0], acc[4], acc[1], acc[5], xs, ws, has_bias, bv);
  if (g + 8 < M)
    flush4(out, g + 8, col, N, acc[2], acc[6], acc[3], acc[7], xs, ws, has_bias, bv);
}

// ---------------------------------------------------------------------------
// variant 3
// ---------------------------------------------------------------------------

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

// Dynamic shared memory above 48 KB must be allowed per kernel and device;
// `done` is the caller's (one per kernel instantiation).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, bool (&done)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int BM, int BN, int WM, int WN, int CW>
cudaError_t launch_mma(const int8_t* x, const int8_t* w, const float* xs,
                       const float* ws, const float* bias, float* out, int M, int N,
                       int K, cudaStream_t stream) {
  auto* kernel = int8_mma_kernel<BM, BN, WM, WN, CW>;
  const int smem = MMA_STAGES * (BM * BK + BK * BN);
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, WM * WN * 32, smem, stream>>>(x, w, xs, ws, bias, out, M, N, K);
  return cudaGetLastError();
}

template <int CW>
cudaError_t launch_mma_config(int config, const int8_t* x, const int8_t* w,
                              const float* xs, const float* ws, const float* bias,
                              float* out, int M, int N, int K, cudaStream_t stream) {
  switch (config) {
    case 0: return launch_mma<128, 128, 2, 4, CW>(x, w, xs, ws, bias, out, M, N, K, stream);
    case 1: return launch_mma<64, 64, 2, 2, CW>(x, w, xs, ws, bias, out, M, N, K, stream);
    case 2: return launch_mma<32, 64, 2, 2, CW>(x, w, xs, ws, bias, out, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int CW>
cudaError_t launch_stream(const int8_t* x, const int8_t* w, const float* xs,
                          const float* ws, const float* bias, float* out, int* work,
                          int* arrivals, int M, int N, int K, int splits,
                          int kt_per_split, cudaStream_t stream) {
  auto* kernel = int8_stream_kernel<CW>;
  const int smem = STREAM_STAGES * (16 * BK + BK * STREAM_BN);
  static bool done[64] = {};
  const cudaError_t err = allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + STREAM_BN - 1) / STREAM_BN, splits);
  kernel<<<grid, STREAM_THREADS, smem, stream>>>(x, w, xs, ws, bias, out, work, arrivals,
                                                 M, N, K, splits, kt_per_split);
  return cudaGetLastError();
}

}  // namespace

// Variant 1. config: 0 = 128 x 128 tiles, 1 = 64 x 64, 2 = 32 x 64. Needs
// K % 16 == 0, N % 8 == 0 and 16-byte aligned x, w, w_scale, bias, out.
extern "C" int int8_matmul_mma_launch(const int8_t* x, const int8_t* w,
                                      const float* x_scale, const float* w_scale,
                                      const float* bias, float* out, int M, int N,
                                      int K, int config, cudaStream_t stream) {
  if (K % 16 != 0 || N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err =
      N % 16 == 0
          ? launch_mma_config<16>(config, x, w, x_scale, w_scale, bias, out, M, N, K, stream)
          : launch_mma_config<8>(config, x, w, x_scale, w_scale, bias, out, M, N, K, stream);
  return static_cast<int>(err);
}

// Variant 2 (M <= 16). work: int32 [M, N] and arrivals: int32 [ceil(N / 64)],
// both zero on entry and on exit (used only when splits > 1); the k tiles of
// 64 are split in `splits` ranges of kt_per_split.
extern "C" int int8_matmul_stream_launch(const int8_t* x, const int8_t* w,
                                         const float* x_scale, const float* w_scale,
                                         const float* bias, float* out, int* work,
                                         int* arrivals, int M, int N, int K,
                                         int splits, int kt_per_split,
                                         cudaStream_t stream) {
  if (M > 16 || K % 16 != 0 || N % 8 != 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err =
      N % 16 == 0 ? launch_stream<16>(x, w, x_scale, w_scale, bias, out, work, arrivals,
                                      M, N, K, splits, kt_per_split, stream)
                  : launch_stream<8>(x, w, x_scale, w_scale, bias, out, work, arrivals,
                                     M, N, K, splits, kt_per_split, stream);
  return static_cast<int>(err);
}

// Variant 3: any M, N, K.
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
