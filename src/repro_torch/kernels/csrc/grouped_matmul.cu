// Grouped matmul over expert-sorted rows: y[t] = x[t] @ w[g(t)], for the
// rows t of each group g given by group_sizes (MoE expert fc1/fc2).
//   int8 mode: int8 x, int8 w -> (float(acc) * w_scale[g, n]) * a_scale
//   W4A8 mode: int8 x, nibble-packed int4 w (uint8 [G, ceil(Din/2), Dout],
//              low nibble = even input row, value v - 16 (v >> 3)) -> the
//              int8 mode's epilogue
//   f32 mode:  f32 x, f32 w   -> f32 sum (3xTF32 tensor-core chunks)
//
// Replaces: src/repro/kernels/expert_linear.py, grouped_matmul / _gmm_kernel
// with _route_metadata (fp32, int8 and the int4_packed W4A8 modes).
//
// Every call is one kernel launch. Each block derives its own work item
// from group_sizes (a block-wide prefix sum in shared memory; G is at most
// a few hundred), so no work table is built before the launch. Three
// variants compute the integer modes bit for bit alike, chosen per call by
// the wrapper (kernels/expert_linear.py:choose_variant): each accumulates
// exactly in int32 (127^2 * Din < 2^31) and flushes in the plain version's
// order, __int2float_rn(acc), then x w_scale[g, n], then x a_scale, each
// rounded (no FMA contraction).
//
// Variant 1, mma (groups of many rows: prefill, vision; int8 and W4A8):
//   Bound on the H100: 2 T Din Dout int8 operations at 1,979 TOP/s against
//   the active experts' weights plus T Din + 4 T Dout bytes at 3.35 TB/s. At
//   an OLMoE-1B-7B prefill of 512 tokens (T = 4096 routed rows, 64 experts,
//   fc1 2048 -> 2048) the 268 MB int8 stack (134 MB W4A8) outweighs the 34
//   GOP: bound by bytes, 0.09 ms (W4A8 0.05); M3ViT-S fc1 at B = 8 ([3152,
//   16, 384, 1536]) is bound by its bytes too (9 us).
//   Design: the work table of the reference (one item per (group, 64-row
//   tile) pair that holds rows of the group; ceil(T/64) + G items, the
//   surplus empty) is derived in the block: a scan of the group sizes gives
//   each group's first row, a scan of its tile counts each group's first
//   item, and the thread whose group holds item blockIdx.x publishes it. A
//   block owns one item and one 64-column tile: a 64 x 64 tile of s8
//   m16n8k32 tensor-core MMAs (4 warps of 32 x 32) fed by a 4-stage
//   cp.async ring (int8_mma.cuh: the N-major weight transposed in registers
//   by ldmatrix.trans + byte_perm). Rows of other groups are masked in the
//   cp.async predicate, so they are zero-filled and never read, and the
//   flush writes only the item's rows: each output element is written once.
//   Blocks walk the items fastest, so the two or so items that share an
//   expert's weight tile run together and the weight comes from device
//   memory about once a layer.
//
// Variant 2, stream (decode: groups of at most a few rows):
//   Bound on the H100: the active experts' weight bytes. An OLMoE decode
//   tick (8 slots x top 8 = 64 rows over 64 experts) reads the fc1 weights
//   of ~40 experts, ~170 MB int8 or ~85 MB W4A8 a layer, against 0.5 GOP:
//   bound by bytes, ~0.05 ms int8 and ~0.026 ms W4A8 with every expert cold.
//   Design: one block per (expert, 64-column strip), ~40 x 32 = 1280 blocks
//   at OLMoE decode, so k is not split. An expert with no rows returns at
//   once and reads nothing; the others find their first row by a block-wide
//   sum of the sizes before them. The block streams its strip of the
//   expert's weight once through an 8-stage cp.async ring, with the
//   group's rows padded to one m16 tile staged beside each stage; each warp
//   multiplies one 16-column slice over one half of each 64-deep stage and
//   the halves meet in shared memory. A group of more than 16 rows is taken
//   16 rows at a time, the strip read again (from L2) for each.
//
// Variant 3, dp4a (what neither takes: Din % 16 != 0, Dout % 8 != 0, or an
// operand off the 16-byte grid; never on the serving paths):
//   Bound on the H100: as variant 1; the __dp4a tiles on CUDA cores stay
//   many times above it (PERF.md), which is why the serving paths avoid it.
//   Design: the first port's tiles (int8_tile.cuh), one 64 x 64 output tile
//   a block over the derived work item, operands staged a byte at a time
//   (W4A8 nibbles unpacked as they are staged) and multiplied with __dp4a.
//
// W4A8 in variants 1 and 2: the packed stack is copied as it lies, half the
// bytes of int8. A stage holds two 64-deep sub-tiles (64 packed rows x 64
// columns, the bytes of one int8 stage), so a block walks half the stages of
// int8 and waits, synchronizes and unpacks once a stage; the rings hold 3
// and 6 such stages. Once a stage has landed, the block unpacks each of its
// sub-tiles into an s8 tile laid out and swizzled as int8_mma.cuh's B tiles
// are: each thread turns 16 packed bytes into the 16
// bytes of the even row and the 16 of the odd one (low nibbles, high
// nibbles; a byte with bit 3 set gets 0xF0 ORed in, which is v - 16). A
// thread whose packed row is even writes its even row first, an odd one its
// odd row first, so every 8-thread phase of the 16-byte stores covers all
// 32 banks. The MMA, the fragments and the flush are the int8 mode's, so
// W4A8 reads half the bytes for the same arithmetic.
//
// f32 mode: f32 x against the f32 expert stack, what launch/serve.py serves
// from an fp tree (every expert fc1 and fc2 of a packed admission and of a
// decode tick: 32 calls an OLMoE-1B-7B forward) and what calibration runs.
// Three variants, chosen per call like the integer ones
// (choose_variant(..., f32=True)). Variants 1 and 2 run one arithmetic,
// 3xTF32 chunk by chunk: x and w are each cut into hi + lo (hi rounded to
// tf32 as cvt.rna rounds, lo = x - hi, which the MMA truncates to tf32),
// and a k8 chunk is the m16n8k8 tf32 MMAs lo.w_hi + hi.w_lo + hi.w_hi from
// zero (the small terms first; lo.lo, ~2^-22 of the product, is dropped),
// added to the f32 sum with __fadd_rn, chunk after chunk in k order. A chunk never holds more than 8 products, so the
// tensor cores' truncating accumulation works on a sum ~sqrt(Din / 8)
// times smaller than the row's: the result stays within 1e-5 of the f32
// plain version at Din = 2048. An output element depends only on its x
// row and its expert's weight column, never on the tile or the other rows:
// variants 1 and 2 give a row the same bits.
//
// f32 variant 1, mma (groups of many rows: a packed admission, both
// calibrations):
//   Bound on the H100: the larger of the bytes (each f32 operand read once,
//   the active experts' weights only, the output written once, at 3.35
//   TB/s) and 3 x 2 T Din Dout tf32 operations at 495 TFLOP/s. An OLMoE
//   512-token admission's fc1 ([4096, 64, 2048, 2048]) moves 1.14 GB
//   against 34 GFLOP: bound by bytes, 0.34 ms; M3ViT-S calibration's fc1
//   ([3152, 16, 384, 1536]) by operations, 0.022 ms (0.055 ms at the 67
//   TFLOP/s of f32 FMAs).
//   Design: a block owns one work item and one 64-column strip: 4 warps of
//   32 x 32 over a 64 x 64 tile, fed by a 3-stage cp.async ring of 32-deep
//   stages (x 64 x 32 and w 32 x 64, 16 KB a stage, both swizzled at
//   16 bytes so that every ldmatrix phase, every 16-byte fragment load and
//   every cp.async phase touches 32 distinct banks). The items start at
//   each group's first row (find_item's group-aligned table), so a group
//   of 70 rows takes a 64-row and a 6-row item, and a warp skips each m16
//   tile that holds none of its item's rows: the MMAs follow the rows, not
//   the 64-row grid. A lane loads the four n8 B fragments of a k8 chunk as
//   two 16-byte words (column 4g + j of the warp's 32 is column g of n8
//   tile j), so the flush writes eight adjacent columns a row per lane.
//   The tiles' three MMA passes are issued pass by pass, the next chunk's
//   fragments read meanwhile, and each live-tile pattern is straight-line
//   code; at most 128 registers, so 4 blocks share an SM. On an H100 the
//   variant runs at ~115-120 TFLOP/s of tf32 MMA work on the M3ViT-S
//   calibration and the OLMoE admission shapes alike, a quarter of the
//   dense tf32 rate: the issue rate of mma.sync m16n8k8.tf32 holds it, not
//   memory (PERF.md); wgmma is the way to the rest.
//
// f32 variant 2, stream (decode: groups of at most a few rows):
//   Bound on the H100: the active experts' weight bytes. An OLMoE decode
//   tick's fc1 (64 routed rows over 64 experts) reads the f32 weights of
//   ~40 experts, ~0.67 GB a call, against 0.5 GFLOP: ~0.20 ms, every
//   expert cold (each layer's experts come after the other layers').
//   Design: one block per (expert, 64-column strip); an expert with no rows
//   returns at once. The block streams its strip once through a 4-stage
//   cp.async ring of 32-deep stages (8 KB of weight and the group's rows
//   padded to one m16 tile, 10 KB a stage); each of the 8 warps owns one
//   n8 tile of the strip and walks every k in order, so no partial sums
//   meet across warps and a row gets variant 1's bits. A group of more
//   than 16 rows is taken 16 rows at a time, the strip read again (L2).
//
// f32 variant 3, fma (what neither takes: Din % 8 != 0, Dout % 8 != 0, or
// an operand off the 16-byte grid; never on the serving paths):
//   Bound on the H100: as variant 1.
//   Design: the first port's tiles (64 x 64 outputs a block, 16-deep k
//   steps, f32 FMA on the CUDA cores, 2.3 TFLOP/s at calibration), over the
//   reference's work table derived in the block. Its sums run in another
//   order, so it agrees with variants 1 and 2 to f32 rounding, not in bits.
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "int8_tile.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace repro::mma8;

constexpr int BM = 64;  // row tile of the work items, every variant
constexpr int FMA_BN = 64;  // f32 variant 3: the first port's tiles
constexpr int FMA_BK = 16;
constexpr int FMA_THREADS = 256;
constexpr int TILE_N = 64;  // columns of a variant 1 tile and a variant 2 strip
constexpr int MMA_THREADS = 128;
constexpr int MMA_STAGES = 4;
constexpr int MMA_STAGES_W4 = 3;  // W4A8: stages of two 64-deep sub-tiles
constexpr int STREAM_THREADS = 256;
constexpr int STREAM_STAGES = 8;
constexpr int STREAM_STAGES_W4 = 6;  // W4A8: stages of two 64-deep sub-tiles

// ---------------------------------------------------------------------------
// work items, derived in the block
// ---------------------------------------------------------------------------

// Exclusive prefix of v over the block's threads in order; total gets the
// sum over all of them. Every thread of the block must call it.
template <int THREADS>
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    const int s = warp_sums[i];
    before += i < warp ? s : 0;
    all += s;
  }
  __syncthreads();  // warp_sums is free again
  total = all;
  return before + incl - v;
}

struct Item {
  int g, m0, lo, hi;  // rows [lo, hi) of group g inside the tile at m0
};

// Work item w of the reference's table (_route_metadata): items walk the
// groups in order, and group g holds one item per 64-row tile that its rows
// [start, start + size) touch. With GROUP_ALIGNED (the f32 mma variant) the
// tiles start at each group's first row instead: group g holds
// ceil(size / 64) items, rows [start + 64 i, start + 64 (i + 1)). Either
// table has at most ceil(T / 64) + G items. Past the last item, an empty
// range.
template <int THREADS, bool GROUP_ALIGNED = false>
__device__ Item find_item(const int* __restrict__ sizes, int G, int T, int w) {
  __shared__ int warp_sums[THREADS / 32];
  __shared__ Item found;
  if (threadIdx.x == 0) found = Item{0, 0, 0, 0};
  int rows_before = 0, items_before = 0;
  for (int c0 = 0; c0 < G; c0 += THREADS) {
    const int g = c0 + threadIdx.x;
    const int size = g < G ? max(sizes[g], 0) : 0;
    int rows_total, items_total;
    const int start = rows_before + block_scan<THREADS>(size, warp_sums, rows_total);
    const int first = start / BM;
    const int items = size <= 0      ? 0
                      : GROUP_ALIGNED ? (size + BM - 1) / BM
                                      : (start + size - 1) / BM - first + 1;
    const int i0 = items_before + block_scan<THREADS>(items, warp_sums, items_total);
    if (w >= i0 && w < i0 + items) {  // one thread of the block at most
      const int m0 = GROUP_ALIGNED ? start + (w - i0) * BM : (first + w - i0) * BM;
      found = Item{g, m0, max(start, m0), min(min(start + size, m0 + BM), T)};
    }
    rows_before += rows_total;
    items_before += items_total;
  }
  __syncthreads();
  return found;
}

// First row of group g: the sum of the sizes before it.
template <int THREADS>
__device__ int rows_before(const int* __restrict__ sizes, int g) {
  __shared__ int warp_sums[THREADS / 32];
  int part = 0;
  for (int i = threadIdx.x; i < g; i += THREADS) part += max(sizes[i], 0);
  int total;
  block_scan<THREADS>(part, warp_sums, total);
  return total;
}

// ---------------------------------------------------------------------------
// staging and flush of variants 1 and 2
// ---------------------------------------------------------------------------

// Rows [m0, m0 + ROWS) x k [k0, k0 + BK) of x[T, K] (K % 16 == 0) into an
// A tile (int8_mma.cuh layout); rows outside [lo, hi) are zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t s, const int8_t* __restrict__ x,
                                          int K, int m0, int lo, int hi, int k0) {
  constexpr int COPIES = ROWS * 4;
#pragma unroll
  for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (COPIES % THREADS != 0 && e >= COPIES) break;
    const int r = e >> 2, c = e & 3;
    const int row = m0 + r, k = k0 + 16 * c;
    const bool ok = row >= lo && row < hi && k < K;
    cp_async<16>(s + r * BK + 16 * swz_a(r, c), ok ? x + (size_t)row * K + k : x, ok);
  }
}

// The weight of a stage: int8 rows k [k0, k0 + 64) into a B tile (N-major,
// swizzled), or packed rows [k0 / 2, k0 / 2 + 32) as they lie (64-byte rows).
template <bool PACKED, int CW, int THREADS>
__device__ __forceinline__ void load_weight(uint32_t s, const int8_t* __restrict__ w,
                                            int N, int K, int n0, int k0) {
  if constexpr (!PACKED) {
    load_w<TILE_N, CW, THREADS>(s, w, N, K, n0, k0);
  } else {
    constexpr int PER_ROW = TILE_N / CW, COPIES = (BK / 2) * PER_ROW;
    const int kp_rows = K / 2;
#pragma unroll
    for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (COPIES % THREADS != 0 && e >= COPIES) break;
      const int r = e / PER_ROW, b = (e % PER_ROW) * CW;
      const int kp = k0 / 2 + r, col = n0 + b;
      const bool ok = kp < kp_rows && col < N;
      cp_async<CW>(s + r * TILE_N + b, ok ? w + (size_t)kp * N + col : w, ok);
    }
  }
}

// Low and high nibbles of four packed bytes as four s8 each.
__device__ __forceinline__ void unpack_word(uint32_t b, uint32_t& lo, uint32_t& hi) {
  const uint32_t l = b & 0x0F0F0F0Fu, h = (b >> 4) & 0x0F0F0F0Fu;
  lo = l | (((l & 0x08080808u) >> 3) * 0xF0u);
  hi = h | (((h & 0x08080808u) >> 3) * 0xF0u);
}

// A landed packed stage (32 rows x 64 bytes at `packed`) into the s8 B tile
// at `dst` (64 rows x 64 bytes, swz_b<64>): packed row p -> rows 2p, 2p + 1.
template <int THREADS>
__device__ __forceinline__ void unpack_stage(const int8_t* packed, int8_t* dst) {
  constexpr int CHUNKS = (BK / 2) * (TILE_N / 16);
  for (int e = threadIdx.x; e < CHUNKS; e += THREADS) {
    const int p = e >> 2, c = e & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(packed + p * TILE_N + 16 * c);
    uint4 lo, hi;
    unpack_word(v.x, lo.x, hi.x);
    unpack_word(v.y, lo.y, hi.y);
    unpack_word(v.z, lo.z, hi.z);
    unpack_word(v.w, lo.w, hi.w);
    const int r0 = 2 * p + (p & 1), r1 = 2 * p + 1 - (p & 1);
    *reinterpret_cast<uint4*>(dst + r0 * TILE_N + 16 * swz_b<TILE_N>(r0, c)) =
        (p & 1) ? hi : lo;
    *reinterpret_cast<uint4*>(dst + r1 * TILE_N + 16 * swz_b<TILE_N>(r1, c)) =
        (p & 1) ? lo : hi;
  }
}

// Four accumulators of one row to columns col .. col + 3 in the plain
// version's order: f32(acc), x w_scale[g, n], x a_scale, one 16-byte store.
__device__ __forceinline__ void flush_row(float* __restrict__ out, int row, int col,
                                          int N, int v0, int v1, int v2, int v3,
                                          float4 ws, float as) {
  float4 y;
  y.x = __fmul_rn(__fmul_rn(__int2float_rn(v0), ws.x), as);
  y.y = __fmul_rn(__fmul_rn(__int2float_rn(v1), ws.y), as);
  y.z = __fmul_rn(__fmul_rn(__int2float_rn(v2), ws.z), as);
  y.w = __fmul_rn(__fmul_rn(__int2float_rn(v3), ws.w), as);
  *reinterpret_cast<float4*>(out + (size_t)row * N + col) = y;
}

// w_scale[g, col .. col + 3] and a_scale; a missing scale is 1, and a
// product with 1 is exact, so the result is the plain version's.
__device__ __forceinline__ float4 col_scales(const float* __restrict__ w_scale,
                                             int g, int N, int col) {
  return w_scale != nullptr
             ? *reinterpret_cast<const float4*>(w_scale + (size_t)g * N + col)
             : make_float4(1.f, 1.f, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// variant 1
// ---------------------------------------------------------------------------

template <bool PACKED, int CW>
__global__ void __launch_bounds__(MMA_THREADS)
    gmm_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int* __restrict__ sizes, const float* __restrict__ w_scale,
                   const float* __restrict__ a_scale, float* __restrict__ out, int T,
                   int G, int Din, int Dout) {
  constexpr int WN = 2, TM = 32, TN = 32, MT = TM / 16, NS = TN / 16;
  constexpr int SUB = PACKED ? 2 : 1;  // 64-deep sub-tiles a stage
  constexpr int A_BYTES = BM * BK, W_SUB = PACKED ? (BK / 2) * TILE_N : BK * TILE_N;
  constexpr int STAGE = SUB * (A_BYTES + W_SUB);
  constexpr int STAGES = PACKED ? MMA_STAGES_W4 : MMA_STAGES;
  extern __shared__ __align__(128) int8_t smem[];
  const Item it = find_item<MMA_THREADS>(sizes, G, T, blockIdx.x);
  if (it.lo >= it.hi) return;  // block-uniform
  const uint32_t s0 = smem_u32(smem);
  int8_t* unpacked = smem + STAGES * STAGE;  // PACKED: the stage's s8 B tiles
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.y * TILE_N;
  const size_t w_rows = PACKED ? (size_t)Din / 2 : (size_t)Din;
  const int8_t* wg = w + (size_t)it.g * w_rows * Dout;
  const int ktiles = (Din + SUB * BK - 1) / (SUB * BK);
  int acc[MT][NS][8] = {};
  auto issue = [&](int kt) {
    const uint32_t st = s0 + (kt % STAGES) * STAGE;
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
      const int k0 = (SUB * kt + sub) * BK;
      load_rows<BM, MMA_THREADS>(st + sub * A_BYTES, x, Din, it.m0, it.lo, it.hi, k0);
      load_weight<PACKED, CW, MMA_THREADS>(st + SUB * A_BYTES + sub * W_SUB, wg, Dout, Din,
                                           n0, k0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 and the s8 tiles are free
    if (kt + STAGES - 1 < ktiles) issue(kt + STAGES - 1);
    cp_async_commit();
    const uint32_t sa = s0 + (kt % STAGES) * STAGE;
    uint32_t sb = sa + SUB * A_BYTES;
    if constexpr (PACKED) {
#pragma unroll
      for (int sub = 0; sub < SUB; ++sub)
        unpack_stage<MMA_THREADS>(smem + (kt % STAGES) * STAGE + SUB * A_BYTES + sub * W_SUB,
                                  unpacked + sub * BK * TILE_N);
      __syncthreads();
      sb = smem_u32(unpacked);
    }
#pragma unroll
    for (int sub = 0; sub < SUB; ++sub) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t a[MT][4], b[NS][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) frag_a(sa + sub * A_BYTES, wm * TM + 16 * i, kk, a[i]);
#pragma unroll
        for (int j = 0; j < NS; ++j) frag_b<TILE_N>(sb + sub * BK * TILE_N, wn * NS + j, kk, b[j]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NS; ++j) mma_slice(acc[i][j], a[i], b[j]);
      }
    }
  }
  cp_async_wait<0>();

  const float as = a_scale != nullptr ? *a_scale : 1.f;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int col = n0 + wn * TN + 16 * j + 4 * t;
    if (col >= Dout) continue;
    const float4 ws = col_scales(w_scale, it.g, Dout, col);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int row = it.m0 + wm * TM + 16 * i + g;
      const int* c = acc[i][j];
      if (row >= it.lo && row < it.hi)
        flush_row(out, row, col, Dout, c[0], c[4], c[1], c[5], ws, as);
      if (row + 8 >= it.lo && row + 8 < it.hi)
        flush_row(out, row + 8, col, Dout, c[2], c[6], c[3], c[7], ws, as);
    }
  }
}

// ---------------------------------------------------------------------------
// variant 2
// ---------------------------------------------------------------------------

template <bool PACKED, int CW>
__global__ void __launch_bounds__(STREAM_THREADS)
    gmm_stream_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      const int* __restrict__ sizes, const float* __restrict__ w_scale,
                      const float* __restrict__ a_scale, float* __restrict__ out,
                      int T, int Din, int Dout) {
  constexpr int SUB = PACKED ? 2 : 1;  // 64-deep sub-tiles a stage
  constexpr int A_BYTES = 16 * BK, W_SUB = PACKED ? (BK / 2) * TILE_N : BK * TILE_N;
  constexpr int STAGE = SUB * (A_BYTES + W_SUB);
  constexpr int STAGES = PACKED ? STREAM_STAGES_W4 : STREAM_STAGES;
  extern __shared__ __align__(128) int8_t smem[];
  const int g = blockIdx.y;
  const int size = sizes[g];
  if (size <= 0) return;  // an expert with no rows reads nothing
  const int start = rows_before<STREAM_THREADS>(sizes, g);
  const int end = min(start + size, T);
  const uint32_t s0 = smem_u32(smem);
  int8_t* unpacked = smem + STAGES * STAGE;
  const int warp = threadIdx.x >> 5, slice = warp & 3, half = warp >> 2;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TILE_N;
  const size_t w_rows = PACKED ? (size_t)Din / 2 : (size_t)Din;
  const int8_t* wg = w + (size_t)g * w_rows * Dout;
  const int ktiles = (Din + SUB * BK - 1) / (SUB * BK);
  const int col = n0 + 16 * slice + 4 * t;
  const float as = a_scale != nullptr ? *a_scale : 1.f;

  for (int lo = start; lo < end; lo += 16) {  // 16 rows of the group at a time
    const int hi = min(end, lo + 16);
    int acc[8] = {};
    auto issue = [&](int kt) {
      const uint32_t st = s0 + (kt % STAGES) * STAGE;
#pragma unroll
      for (int sub = 0; sub < SUB; ++sub) {
        const int k0 = (SUB * kt + sub) * BK;
        load_rows<16, STREAM_THREADS>(st + sub * A_BYTES, x, Din, lo, lo, hi, k0);
        load_weight<PACKED, CW, STREAM_THREADS>(st + SUB * A_BYTES + sub * W_SUB, wg, Dout,
                                                Din, n0, k0);
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) issue(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < ktiles) issue(kt + STAGES - 1);
      cp_async_commit();
      const uint32_t sa = s0 + (kt % STAGES) * STAGE;
      uint32_t sb = sa + SUB * A_BYTES;
      if constexpr (PACKED) {
#pragma unroll
        for (int sub = 0; sub < SUB; ++sub)
          unpack_stage<STREAM_THREADS>(
              smem + (kt % STAGES) * STAGE + SUB * A_BYTES + sub * W_SUB,
              unpacked + sub * BK * TILE_N);
        __syncthreads();
        sb = smem_u32(unpacked);
      }
#pragma unroll
      for (int sub = 0; sub < SUB; ++sub) {
        uint32_t a[4], b[4];
        frag_a(sa + sub * A_BYTES, 0, 32 * half, a);
        frag_b<TILE_N>(sb + sub * BK * TILE_N, slice, 32 * half, b);
        mma_slice(acc, a, b);
      }
    }

    // the two k halves of each slice meet in shared memory
    cp_async_wait<0>();
    __syncthreads();
    int* red = reinterpret_cast<int*>(smem);
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) red[i * 128 + slice * 32 + lane] = acc[i];
    }
    __syncthreads();
    if (half == 0 && col < Dout) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += red[i * 128 + slice * 32 + lane];
      const float4 ws = col_scales(w_scale, g, Dout, col);
      // accumulator i lies at row lo + gr + 8 ((i >> 1) & 1) and column
      // col + ((i >> 2) & 1) + 2 (i & 1)
      if (lo + gr < hi)
        flush_row(out, lo + gr, col, Dout, acc[0], acc[4], acc[1], acc[5], ws, as);
      if (lo + gr + 8 < hi)
        flush_row(out, lo + gr + 8, col, Dout, acc[2], acc[6], acc[3], acc[7], ws, as);
    }
    __syncthreads();  // red and the ring are reused by the next 16 rows
  }
}

// ---------------------------------------------------------------------------
// variant 3, and f32 variant 3 (fma)
// ---------------------------------------------------------------------------

template <bool PACKED>
__global__ void __launch_bounds__(repro::I8_THREADS)
    gmm_dp4a_kernel(const int8_t* __restrict__ x, const void* __restrict__ w,
                    const int* __restrict__ sizes, const float* __restrict__ w_scale,
                    const float* __restrict__ a_scale, float* __restrict__ out, int T,
                    int G, int Din, int Dout) {
  __shared__ repro::I8Smem sm;
  const Item it = find_item<repro::I8_THREADS>(sizes, G, T, blockIdx.x);
  if (it.lo >= it.hi) return;  // block-uniform
  const int n0 = blockIdx.y * repro::I8_BN;
  int acc[4][4] = {};
  const size_t w_rows = PACKED ? (size_t)(Din + 1) / 2 : (size_t)Din;
  const void* wg = static_cast<const int8_t*>(w) + (size_t)it.g * w_rows * Dout;
  repro::i8_tile_mainloop<PACKED>(x, wg, Din, Dout, it.m0, it.lo, it.hi, n0, sm, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = it.m0 + ty + 16 * i;
    if (row < it.lo || row >= it.hi) continue;
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

__global__ void __launch_bounds__(FMA_THREADS)
    gmm_f32_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ sizes, float* __restrict__ out, int T,
                   int G, int Din, int Dout) {
  __shared__ float xs[FMA_BK][BM + 1];  // X tile transposed: k-major
  __shared__ float ws[FMA_BK][FMA_BN];
  const Item it = find_item<FMA_THREADS>(sizes, G, T, blockIdx.x);
  if (it.lo >= it.hi) return;  // block-uniform
  const int n0 = blockIdx.y * FMA_BN;
  const float* wg = w + (size_t)it.g * Din * Dout;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Din; k0 += FMA_BK) {
    for (int e = tid; e < BM * FMA_BK; e += FMA_THREADS) {
      const int r = e / FMA_BK, kk = e % FMA_BK;
      const int row = it.m0 + r, k = k0 + kk;
      xs[kk][r] = (row >= it.lo && row < it.hi && k < Din) ? x[(size_t)row * Din + k]
                                                           : 0.f;
    }
    for (int e = tid; e < FMA_BK * FMA_BN; e += FMA_THREADS) {
      const int kk = e / FMA_BN, c = e % FMA_BN;
      const int k = k0 + kk, col = n0 + c;
      ws[kk][c] = (k < Din && col < Dout) ? wg[(size_t)k * Dout + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FMA_BK; ++kk) {
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
    if (row < it.lo || row >= it.hi) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Dout) out[(size_t)row * Dout + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 variants 1 and 2: 3xTF32 chunks
// ---------------------------------------------------------------------------

using namespace repro::tf32;

constexpr int F_BK = 32;  // k of a stage: four k8 chunks, 128 bytes of an x row
constexpr int F_ROW_BYTES = F_BK * 4;
constexpr int F_W_BYTES = F_BK * TILE_N * 4;  // a stage's weight: 32 x 64 f32
constexpr int F_MMA_THREADS = 128;
constexpr int F_MMA_STAGES = 3;
constexpr int F_MMA_BLOCKS = 4;  // blocks an SM: 48 KB of ring and <= 128 registers each
constexpr int F_STREAM_THREADS = 256;
constexpr int F_STREAM_STAGES = 4;

// Physical 16-byte chunk of logical chunk c in row r of an x tile (128-byte
// rows) and of a weight tile (256-byte rows).
__device__ __forceinline__ int swz_fx(int r, int c) { return c ^ (r & 7); }
__device__ __forceinline__ int swz_fw(int r, int c) { return c ^ ((r & 3) << 1); }

// Rows [m0, m0 + ROWS) x k [k0, k0 + 32) of x[T, K] (K % 4 == 0); rows
// outside [lo, hi) and k >= K are zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows_f32(uint32_t s, const float* __restrict__ x,
                                              int K, int m0, int lo, int hi, int k0) {
  constexpr int COPIES = ROWS * 8;
#pragma unroll
  for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (COPIES % THREADS != 0 && e >= COPIES) break;
    const int r = e >> 3, c = e & 7;
    const int row = m0 + r, k = k0 + 4 * c;
    const bool ok = row >= lo && row < hi && k < K;
    cp_async<16>(s + r * F_ROW_BYTES + 16 * swz_fx(r, c),
                 ok ? x + (size_t)row * K + k : x, ok);
  }
}

// Rows k [k0, k0 + 32) x columns [n0, n0 + 64) of one expert's w[K, N]
// (N % 4 == 0); the rest is zero-filled.
template <int THREADS>
__device__ __forceinline__ void load_strip_f32(uint32_t s, const float* __restrict__ w,
                                               int N, int K, int n0, int k0) {
  constexpr int COPIES = F_BK * (TILE_N / 4);
#pragma unroll
  for (int i = 0; i < COPIES / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e >> 4, c = e & 15;
    const int k = k0 + r, col = n0 + 4 * c;
    const bool ok = k < K && col < N;
    cp_async<16>(s + r * TILE_N * 4 + 16 * swz_fw(r, c),
                 ok ? w + (size_t)k * N + col : w, ok);
  }
}

// The A fragment of rows [r0, r0 + 16) and k8 chunk kk of a stage.
__device__ __forceinline__ void frag_a_f32(uint32_t s, int r0, int kk, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  ldsm_x4(s + row * F_ROW_BYTES + 16 * swz_fx(row, 2 * kk + (lane >> 4)), a);
}

// One stage of variant 1 for a warp: NK k8 chunks over the m16 tiles whose
// bits are set in LIVE (a warp skips the tiles its item leaves empty), in
// straight-line code. The fragments of chunk kk + 1 are read while chunk
// kk's MMAs run. B: column 4g + j of the warp's 32 is column g of n8 tile
// j, so rows 8kk + t and 8kk + t + 4 hold the four tiles' fragments in
// one 16-byte word each.
template <int LIVE, int NK>
__device__ __forceinline__ void mma_stage(float (&acc)[2][4][4], uint32_t sa, const int8_t* sb,
                                          int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float4 braw[2];
  uint32_t araw[2][4];
  auto load = [&](int kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * kk + t + 4 * h;
      braw[h] = *reinterpret_cast<const float4*>(sb + r * TILE_N * 4 +
                                                 16 * swz_fw(r, wn * 8 + g));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (LIVE >> i & 1) frag_a_f32(sa, wm * 32 + 16 * i, kk, araw[i]);
  };
  load(0);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t bh[4][2], bl[4][2], ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split_tf32(braw[h].x, bh[0][h], bl[0][h]);
      split_tf32(braw[h].y, bh[1][h], bl[1][h]);
      split_tf32(braw[h].z, bh[2][h], bl[2][h]);
      split_tf32(braw[h].w, bh[3][h], bl[3][h]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (LIVE >> i & 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(araw[i][e]), ah[i][e], al[i][e]);
    if (kk + 1 < NK) load(kk + 1);
    // each tile's chunk from zero, lo.b_hi + hi.b_lo + hi.b_hi, issued pass
    // by pass so that the tiles' MMA chains overlap; then added to the sums
    float c[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (LIVE >> i & 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32_zero(c[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (LIVE >> i & 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(c[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (LIVE >> i & 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(c[i][j], ah[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (LIVE >> i & 1)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], c[i][j][e]);
  }
}

// A stage with NK < 4 chunks (Din % 32 != 0, the last stage only).
template <int LIVE>
__device__ __forceinline__ void mma_stage_tail(float (&acc)[2][4][4], uint32_t sa,
                                               const int8_t* sb, int wm, int wn, int nk) {
  if (nk == 1) mma_stage<LIVE, 1>(acc, sa, sb, wm, wn);
  else if (nk == 2) mma_stage<LIVE, 2>(acc, sa, sb, wm, wn);
  else mma_stage<LIVE, 3>(acc, sa, sb, wm, wn);
}

__global__ void __launch_bounds__(F_MMA_THREADS, F_MMA_BLOCKS)
    gmm_f32_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const int* __restrict__ sizes, float* __restrict__ out, int T,
                       int G, int Din, int Dout) {
  constexpr int A_BYTES = BM * F_ROW_BYTES;
  constexpr int STAGE = A_BYTES + F_W_BYTES;
  extern __shared__ __align__(128) int8_t smem[];
  const Item it = find_item<F_MMA_THREADS, true>(sizes, G, T, blockIdx.x);
  if (it.lo >= it.hi) return;  // block-uniform
  const uint32_t s0 = smem_u32(smem);
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * TILE_N;
  const float* wg = w + (size_t)it.g * Din * Dout;
  const int ktiles = (Din + F_BK - 1) / F_BK;
  int live_mask = 0;  // bit i: the warp's m16 tile i holds rows of the item
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = it.m0 + wm * 32 + 16 * i;
    live_mask |= (r0 < it.hi && r0 + 16 > it.lo) << i;
  }
  float acc[2][4][4] = {};
  auto issue = [&](int kt) {
    const uint32_t st = s0 + (kt % F_MMA_STAGES) * STAGE;
    load_rows_f32<BM, F_MMA_THREADS>(st, x, Din, it.m0, it.lo, it.hi, kt * F_BK);
    load_strip_f32<F_MMA_THREADS>(st + A_BYTES, wg, Dout, Din, n0, kt * F_BK);
  };

#pragma unroll
  for (int s = 0; s < F_MMA_STAGES - 1; ++s) {
    if (s < ktiles) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<F_MMA_STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    if (kt + F_MMA_STAGES - 1 < ktiles) issue(kt + F_MMA_STAGES - 1);
    cp_async_commit();
    const uint32_t sa = s0 + (kt % F_MMA_STAGES) * STAGE;
    const int8_t* sb = smem + (kt % F_MMA_STAGES) * STAGE + A_BYTES;
    const int nk = min(F_BK, Din - kt * F_BK) / 8;  // Din % 8 == 0
    if (nk == 4) {
      if (live_mask == 3) mma_stage<3, 4>(acc, sa, sb, wm, wn);
      else if (live_mask == 1) mma_stage<1, 4>(acc, sa, sb, wm, wn);
      else if (live_mask == 2) mma_stage<2, 4>(acc, sa, sb, wm, wn);
    } else {
      if (live_mask == 3) mma_stage_tail<3>(acc, sa, sb, wm, wn, nk);
      else if (live_mask == 1) mma_stage_tail<1>(acc, sa, sb, wm, wn, nk);
      else if (live_mask == 2) mma_stage_tail<2>(acc, sa, sb, wm, wn, nk);
    }
  }
  cp_async_wait<0>();

  // accumulator e of tile j lies at row g + 8 (e >> 1), column 4 (2t + (e &
  // 1)) + j of the warp's 32: a lane writes columns 8t .. 8t + 7 of a row
  const int col = n0 + wn * 32 + 8 * t;
  if (col >= Dout) return;  // Dout % 8 == 0: all eight columns or none
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!(live_mask >> i & 1)) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = it.m0 + wm * 32 + 16 * i + g + 8 * h;
      if (row < it.lo || row >= it.hi) continue;
      float* o = out + (size_t)row * Dout + col;
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0][2 * h], acc[i][1][2 * h],
                                                  acc[i][2][2 * h], acc[i][3][2 * h]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(acc[i][0][2 * h + 1], acc[i][1][2 * h + 1], acc[i][2][2 * h + 1],
                      acc[i][3][2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(F_STREAM_THREADS)
    gmm_f32_stream_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const int* __restrict__ sizes, float* __restrict__ out, int T,
                          int Din, int Dout) {
  constexpr int A_BYTES = 16 * F_ROW_BYTES;
  constexpr int STAGE = A_BYTES + F_W_BYTES;
  extern __shared__ __align__(128) int8_t smem[];
  const int grp = blockIdx.y;
  const int size = sizes[grp];
  if (size <= 0) return;  // an expert with no rows reads nothing
  const int start = rows_before<F_STREAM_THREADS>(sizes, grp);
  const int end = min(start + size, T);
  const uint32_t s0 = smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TILE_N;
  const float* wg = w + (size_t)grp * Din * Dout;
  const int ktiles = (Din + F_BK - 1) / F_BK;
  const int col = n0 + 8 * warp + 2 * t;  // the warp's n8 tile: columns 8 warp ..

  for (int lo = start; lo < end; lo += 16) {  // 16 rows of the group at a time
    const int hi = min(end, lo + 16);
    float acc[4] = {};
    auto issue = [&](int kt) {
      const uint32_t st = s0 + (kt % F_STREAM_STAGES) * STAGE;
      load_rows_f32<16, F_STREAM_THREADS>(st, x, Din, lo, lo, hi, kt * F_BK);
      load_strip_f32<F_STREAM_THREADS>(st + A_BYTES, wg, Dout, Din, n0, kt * F_BK);
    };
#pragma unroll
    for (int s = 0; s < F_STREAM_STAGES - 1; ++s) {
      if (s < ktiles) issue(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<F_STREAM_STAGES - 2>();
      __syncthreads();
      if (kt + F_STREAM_STAGES - 1 < ktiles) issue(kt + F_STREAM_STAGES - 1);
      cp_async_commit();
      const uint32_t sa = s0 + (kt % F_STREAM_STAGES) * STAGE;
      const float* sb =
          reinterpret_cast<const float*>(smem + (kt % F_STREAM_STAGES) * STAGE + A_BYTES);
      // the stage's four chunks, each from zero and pass by pass as in
      // variant 1, then added to the sums in k order
      const int nk = min(F_BK, Din - kt * F_BK) / 8;  // Din % 8 == 0
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
      float c[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nk) continue;
        uint32_t a[4];
        frag_a_f32(sa, 0, kk, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), ah[kk][e], al[kk][e]);
        // B fragment: rows 8kk + t and 8kk + t + 4, column 8 warp + g
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * kk + t + 4 * h;
          split_tf32(sb[r * TILE_N + 4 * swz_fw(r, 2 * warp + (g >> 2)) + (g & 3)],
                     bh[kk][h], bl[kk][h]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) mma_tf32_zero(c[kk], al[kk], bh[kk][0], bh[kk][1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) mma_tf32(c[kk], ah[kk], bl[kk][0], bl[kk][1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk) mma_tf32(c[kk], ah[kk], bh[kk][0], bh[kk][1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], c[kk][e]);
    }
    cp_async_wait<0>();
    if (col < Dout) {
      if (lo + g < hi)
        *reinterpret_cast<float2*>(out + (size_t)(lo + g) * Dout + col) =
            make_float2(acc[0], acc[1]);
      if (lo + g + 8 < hi)
        *reinterpret_cast<float2*>(out + (size_t)(lo + g + 8) * Dout + col) =
            make_float2(acc[2], acc[3]);
    }
    __syncthreads();  // the ring is reused by the next 16 rows
  }
}

int work_items(int T, int G) { return (T + BM - 1) / BM + G; }

template <bool PACKED, int CW>
cudaError_t launch_tc(int variant, const int8_t* x, const int8_t* w, const int* sizes,
                      const float* ws, const float* as, float* out, int T, int G,
                      int Din, int Dout, cudaStream_t stream) {
  const int strips = (Dout + TILE_N - 1) / TILE_N;
  if (variant == 1) {
    constexpr int sub = PACKED ? 2 : 1;
    constexpr int stage = sub * (BM * BK + (PACKED ? BK / 2 : BK) * TILE_N);
    const int smem = (PACKED ? MMA_STAGES_W4 : MMA_STAGES) * stage
                     + (PACKED ? sub * BK * TILE_N : 0);  // < 48 KB
    gmm_mma_kernel<PACKED, CW><<<dim3(work_items(T, G), strips), MMA_THREADS, smem,
                                 stream>>>(x, w, sizes, ws, as, out, T, G, Din, Dout);
  } else {
    constexpr int sub = PACKED ? 2 : 1;
    constexpr int stage = sub * (16 * BK + (PACKED ? BK / 2 : BK) * TILE_N);
    const int smem = (PACKED ? STREAM_STAGES_W4 : STREAM_STAGES) * stage
                     + (PACKED ? sub * BK * TILE_N : 0);  // < 48 KB
    gmm_stream_kernel<PACKED, CW><<<dim3(strips, G), STREAM_THREADS, smem, stream>>>(
        x, w, sizes, ws, as, out, T, Din, Dout);
  }
  return cudaGetLastError();
}

}  // namespace

// Integer modes. packed: 0 = int8 w [G, Din, Dout], 1 = W4A8 (uint8
// [G, ceil(Din/2), Dout], Din the logical input width of x). variant: 1 mma,
// 2 stream (both need Din % 16 == 0, Dout % 8 == 0 and 16-byte aligned x, w,
// w_scale, out; refused with cudaErrorInvalidValue otherwise), 3 dp4a (any
// shape). sizes: int32 [G], summing to T. w_scale and a_scale may be null.
extern "C" int grouped_matmul_i8_launch(const int8_t* x, const void* w, int packed,
                                        const int* sizes, const float* w_scale,
                                        const float* a_scale, float* out, int T, int G,
                                        int Din, int Dout, int variant,
                                        cudaStream_t stream) {
  if (variant < 1 || variant > 3 || G < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant != 3 && (Din % 16 != 0 || Dout % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || Dout <= 0) return static_cast<int>(cudaSuccess);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  cudaError_t err;
  if (variant == 3) {
    const dim3 grid(work_items(T, G), (Dout + repro::I8_BN - 1) / repro::I8_BN);
    if (packed)
      gmm_dp4a_kernel<true><<<grid, repro::I8_THREADS, 0, stream>>>(
          x, w, sizes, w_scale, a_scale, out, T, G, Din, Dout);
    else
      gmm_dp4a_kernel<false><<<grid, repro::I8_THREADS, 0, stream>>>(
          x, w, sizes, w_scale, a_scale, out, T, G, Din, Dout);
    err = cudaGetLastError();
  } else if (Dout % 16 == 0) {
    err = packed ? launch_tc<true, 16>(variant, x, w8, sizes, w_scale, a_scale, out, T,
                                       G, Din, Dout, stream)
                 : launch_tc<false, 16>(variant, x, w8, sizes, w_scale, a_scale, out, T,
                                        G, Din, Dout, stream);
  } else {
    err = packed ? launch_tc<true, 8>(variant, x, w8, sizes, w_scale, a_scale, out, T,
                                      G, Din, Dout, stream)
                 : launch_tc<false, 8>(variant, x, w8, sizes, w_scale, a_scale, out, T,
                                       G, Din, Dout, stream);
  }
  return static_cast<int>(err);
}

// f32 mode: x [T, Din], w [G, Din, Dout], sizes int32 [G] summing to T.
// variant: 1 mma, 2 stream (both need Din % 8 == 0, Dout % 8 == 0 and
// 16-byte aligned x, w, out; refused with cudaErrorInvalidValue otherwise),
// 3 fma (any shape).
extern "C" int grouped_matmul_f32_launch(const float* x, const float* w,
                                         const int* sizes, float* out, int T, int G,
                                         int Din, int Dout, int variant,
                                         cudaStream_t stream) {
  if (variant < 1 || variant > 3 || G < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant != 3 && (Din % 8 != 0 || Dout % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || Dout <= 0) return static_cast<int>(cudaSuccess);
  const int strips = (Dout + TILE_N - 1) / TILE_N;
  if (variant == 1) {
    const int smem = F_MMA_STAGES * (BM * F_ROW_BYTES + F_W_BYTES);  // 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_f32_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_f32_mma_kernel<<<dim3(work_items(T, G), strips), F_MMA_THREADS, smem, stream>>>(
        x, w, sizes, out, T, G, Din, Dout);
  } else if (variant == 2) {
    const int smem = F_STREAM_STAGES * (16 * F_ROW_BYTES + F_W_BYTES);  // 40 KB
    gmm_f32_stream_kernel<<<dim3(strips, G), F_STREAM_THREADS, smem, stream>>>(
        x, w, sizes, out, T, Din, Dout);
  } else {
    const dim3 grid(work_items(T, G), (Dout + FMA_BN - 1) / FMA_BN);
    gmm_f32_fma_kernel<<<grid, FMA_THREADS, 0, stream>>>(x, w, sizes, out, T, G, Din, Dout);
  }
  return static_cast<int>(cudaGetLastError());
}
