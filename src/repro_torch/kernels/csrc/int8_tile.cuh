// Shared int8 tile main loop of int8_matmul.cu and grouped_matmul.cu.
//
// With PACKED the weight is a nibble-packed int4 matrix, uint8
// [ceil(K/2), N]: the low nibble of byte p holds row 2p, the high nibble
// row 2p+1, each a two's-complement 4-bit value (v - 16 (v >> 3)). The
// nibbles are unpacked to s8 on the way into shared memory, so the __dp4a
// loop is the int8 one (Hopper has no int4 tensor-core path); for an odd K
// the pad nibble lies at k = K and loads as zero like any k >= K.
//
// One block of I8_THREADS threads owns an I8_BM x I8_BN output tile and walks
// K in steps of I8_BK. Both operands are staged in shared memory with the
// contraction dim contiguous (the W tile is transposed on the way in), so
// every thread forms its 4 x 4 outputs with __dp4a: four int8 products summed
// into an int32 accumulator per instruction. The accumulator is exact: at
// K = 1536, 127^2 * 1536 < 2^31.
#pragma once

#include <cstdint>

namespace repro {

constexpr int I8_BM = 64;
constexpr int I8_BN = 64;
constexpr int I8_BK = 32;
constexpr int I8_THREADS = 256;          // 16 x 16 threads, 4 x 4 outputs each
constexpr int I8_WORDS = I8_BK / 4 + 1;  // one word of padding: no bank conflicts

struct I8Smem {
  int32_t xs[I8_BM][I8_WORDS];  // X rows, k-contiguous
  int32_t ws[I8_BN][I8_WORDS];  // W columns, k-contiguous
};

// The weight element (k, c) of w [K, N] (int8) or of its packed form.
template <bool PACKED>
__device__ inline int8_t load_w(const void* __restrict__ w, int k, int c, int N) {
  if constexpr (PACKED) {
    const int byte = static_cast<const uint8_t*>(w)[(size_t)(k >> 1) * N + c];
    const int v = (k & 1) ? (byte >> 4) : (byte & 0xF);
    return static_cast<int8_t>(v - ((v & 0x8) << 1));
  } else {
    return static_cast<const int8_t*>(w)[(size_t)k * N + c];
  }
}

// acc[i][j] += sum_k x[r, k] * w[k, c] for r = m0 + ty + 16 i and
// c = n0 + tx + 16 j (tx = tid % 16, ty = tid / 16). Rows outside
// [row_lo, row_hi), columns >= N and k >= K load as zero, which masks the
// ragged edges and the rows of other groups.
template <bool PACKED = false>
__device__ inline void i8_tile_mainloop(const int8_t* __restrict__ x,
                                        const void* __restrict__ w, int K,
                                        int N, int m0, int row_lo, int row_hi,
                                        int n0, I8Smem& sm, int acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int8_t* xs8 = reinterpret_cast<int8_t*>(&sm.xs[0][0]);
  int8_t* ws8 = reinterpret_cast<int8_t*>(&sm.ws[0][0]);
  constexpr int ROW_BYTES = I8_WORDS * 4;
  for (int k0 = 0; k0 < K; k0 += I8_BK) {
    for (int e = tid; e < I8_BM * I8_BK; e += I8_THREADS) {
      const int r = e / I8_BK, kk = e % I8_BK;
      const int row = m0 + r, k = k0 + kk;
      int8_t v = 0;
      if (row >= row_lo && row < row_hi && k < K) v = x[(size_t)row * K + k];
      xs8[r * ROW_BYTES + kk] = v;
    }
    for (int e = tid; e < I8_BK * I8_BN; e += I8_THREADS) {
      const int kk = e / I8_BN, c = e % I8_BN;
      const int k = k0 + kk, col = n0 + c;
      int8_t v = 0;
      if (k < K && col < N) v = load_w<PACKED>(w, k, col, N);
      ws8[c * ROW_BYTES + kk] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < I8_BK / 4; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.xs[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.ws[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace repro
