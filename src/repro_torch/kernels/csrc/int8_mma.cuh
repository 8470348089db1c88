// s8 tensor-core tiles for int8_matmul.cu: cp.async staging of int8 x and w
// tiles into a ring in shared memory, fragments for
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, and the Eq. 9 flush.
//
// Replaces: src/repro/kernels/int8_matmul.py, the tile body of
// _int8_mm_kernel (an int8 jnp.dot on the TPU's matrix unit into an int32
// VMEM accumulator, rescaled at the last k step).
//
// Bound on the H100: a tile moves 64 k-bytes of x and w a stage for
// 2 * 64 * BM * BN operations; the kernels built on it are bound by the
// device-memory bytes (int8_matmul.cu states each variant's bound). So a
// tile must keep the tensor cores fed from shared memory without spending
// instructions or bank conflicts on the layout.
//
// Design: the layout problem below, solved while fragments are read.
//
// The layout problem. The s8 MMA wants B column-major (for each column n,
// 4 consecutive k in one 32-bit register), but the weight is w[K, N] with N
// contiguous and ldmatrix.trans moves 16-bit elements, not bytes. The B tile
// is therefore staged N-major as it lies in device memory, and transposed
// while fragments are read:
//   * one ldmatrix.x4.trans over the rows k = {0,1,4,5,8,9,12,13} (matrix 0),
//     {2,3,6,7,...} (matrix 1) and the same + 16 (matrices 2, 3) of a
//     16-column slice gives lane (g, t) (g = lane / 4, t = lane % 4) the bytes
//     w[4t .. 4t+3][2g] and w[4t .. 4t+3][2g + 1], interleaved in two words;
//   * two __byte_perm per pair of words split them into one k-contiguous word
//     for column 2g and one for column 2g + 1.
// So a 16-column slice feeds two n8 MMA tiles: the even columns of the slice
// and the odd ones. In the accumulators lane (g, t) then holds, for row g and
// g + 8, the real columns 4t .. 4t+3 of the slice (even tile d0, odd d0, even
// d1, odd d1): the flush writes them as one 16-byte store per row.
//
// Both tiles are swizzled at 16-byte granularity so that every ldmatrix
// phase (8 rows of 16 bytes) and every 8-thread cp.async phase touches 32
// distinct banks (A: 64-byte rows; B: 64- or 128-byte rows).
#pragma once

#include <cstdint>

namespace repro {
namespace mma8 {

constexpr int BK = 64;  // k bytes of a stage: two m16n8k32 steps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES in {8, 16}; zero-filled (no read) when !pred.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[0..3] += a (16 x 32, row) . b (32 x 8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int* d, const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Physical 16-byte chunk of logical chunk c in row `row` of an A tile (64-byte
// rows, k-contiguous) and of a B tile (BN-byte rows, n-contiguous).
__device__ __forceinline__ int swz_a(int row, int c) { return c ^ ((row >> 1) & 3); }

template <int BN>
__device__ __forceinline__ int swz_b(int row, int c) {
  static_assert(BN == 64 || BN == 128, "B tiles are 64 or 128 columns wide");
  if constexpr (BN == 128) {
    return c ^ ((row & 1) | ((row >> 1) & 6));
  } else {
    return c ^ ((row >> 2) & 3);
  }
}

// Stage rows [m0, m0 + ROWS) x k [k0, k0 + BK) of x[M, K] (K % 16 == 0, so a
// 16-byte chunk is wholly inside or outside); the rest is zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_x(uint32_t s, const int8_t* __restrict__ x,
                                       int M, int K, int m0, int k0) {
  constexpr int COPIES = ROWS * 4;
#pragma unroll
  for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (COPIES % THREADS != 0 && e >= COPIES) break;
    const int r = e >> 2, c = e & 3;
    const int row = m0 + r, k = k0 + 16 * c;
    const bool ok = row < M && k < K;
    cp_async<16>(s + r * BK + 16 * swz_a(r, c), ok ? x + (size_t)row * K + k : x, ok);
  }
}

// Stage k [k0, k0 + BK) x columns [n0, n0 + BN) of w[K, N] in copies of CW
// bytes (N % CW == 0); the rest is zero-filled.
template <int BN, int CW, int THREADS>
__device__ __forceinline__ void load_w(uint32_t s, const int8_t* __restrict__ w,
                                       int N, int K, int n0, int k0) {
  constexpr int PER_ROW = BN / CW, COPIES = BK * PER_ROW;
#pragma unroll
  for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (COPIES % THREADS != 0 && e >= COPIES) break;
    const int r = e / PER_ROW, b = (e % PER_ROW) * CW;
    const int k = k0 + r, col = n0 + b;
    const bool ok = k < K && col < N;
    cp_async<CW>(s + r * BN + 16 * swz_b<BN>(r, b >> 4) + (b & 15),
                 ok ? w + (size_t)k * N + col : w, ok);
  }
}

// A fragment of tile rows [r0, r0 + 16) at k offset kk (0 or 32) of a stage.
__device__ __forceinline__ void frag_a(uint32_t s, int r0, int kk, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  const int row = r0 + i + 8 * (q & 1);
  ldsm_x4(s + row * BK + 16 * swz_a(row, (kk >> 4) + (q >> 1)), a);
}

// B fragments of the 16-column slice c16 at k offset kk: b[0], b[1] for the
// even columns of the slice (k 0-15, 16-31), b[2], b[3] for the odd ones.
template <int BN>
__device__ __forceinline__ void frag_b(uint32_t s, int c16, int kk, uint32_t (&b)[4]) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  const int row = kk + 16 * (q >> 1) + 2 * (q & 1) + 4 * (i >> 1) + (i & 1);
  uint32_t r[4];
  ldsm_x4_trans(s + row * BN + 16 * swz_b<BN>(row, c16), r);
  b[0] = __byte_perm(r[0], r[1], 0x6420);
  b[1] = __byte_perm(r[2], r[3], 0x6420);
  b[2] = __byte_perm(r[0], r[1], 0x7531);
  b[3] = __byte_perm(r[2], r[3], 0x7531);
}

// acc[0..3]: the even n8 tile of a slice, acc[4..7]: the odd one.
__device__ __forceinline__ void mma_slice(int* acc, const uint32_t (&a)[4],
                                          const uint32_t (&b)[4]) {
  mma_s8(acc, a, b[0], b[1]);
  mma_s8(acc + 4, a, b[2], b[3]);
}

// The Eq. 9 flush of four accumulators of one row to columns col .. col+3
// (col % 4 == 0, all < N): out = f32(acc) * (xs * ws[n]) (+ bias[n]), rounded
// step by step in the plain version's order, one 16-byte store.
__device__ __forceinline__ void flush4(float* __restrict__ out, int row, int col,
                                       int N, int v0, int v1, int v2, int v3,
                                       float xs, float4 ws, bool has_bias, float4 b) {
  float4 y;
  y.x = __fmul_rn(__int2float_rn(v0), __fmul_rn(xs, ws.x));
  y.y = __fmul_rn(__int2float_rn(v1), __fmul_rn(xs, ws.y));
  y.z = __fmul_rn(__int2float_rn(v2), __fmul_rn(xs, ws.z));
  y.w = __fmul_rn(__int2float_rn(v3), __fmul_rn(xs, ws.w));
  if (has_bias) {
    y.x = __fadd_rn(y.x, b.x);
    y.y = __fadd_rn(y.y, b.y);
    y.z = __fadd_rn(y.z, b.z);
    y.w = __fadd_rn(y.w, b.w);
  }
  *reinterpret_cast<float4*>(out + (size_t)row * N + col) = y;
}

}  // namespace mma8
}  // namespace repro
