// Mamba-1 selective scan: for every (batch b, channel d, state n)
//   h_t = exp(dt_t A[d, n]) h_{t-1} + (dt_t x_t) B_t[n],   h_{-1} = 0,
//   y_t = sum_n h_t[n] C_t[n] + D[d] x_t,
// over x, dt f32 [B, S, di], B, C f32 [B, S, N], A f32 [di, N] (negative),
// D f32 [di]; writes y f32 [B, S, di] and the final state h_last f32
// [B, di, N] (the prefill -> decode handoff).
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan /
// _scan_kernel.
//
// Bound on the H100: at the falcon-mamba-7b prefill shape [B, S, di, N] =
// [8, 256, 8192, 16] the kernel must read x and dt and write y (3 x 67 MB),
// read B and C (0.26 MB) and A (0.5 MB) and write h_last (4.2 MB): ~206 MB,
// 0.061 ms at 3.35 TB/s. It takes B S di N = 2.7e8 exponentials; on the
// special-function units (16 a clock on each of 132 SMs, ~4e12/s) that is
// ~0.064 ms, about even with the bytes, while the ~7 f32 operations per
// (b, t, d, n) take 0.028 ms at 67 TFLOP/s.
//
// Design: the TPU kernel walks S as its innermost, sequential grid axis and
// carries h in VMEM scratch from one grid step to the next. Hopper's blocks
// run in no order, so here the whole S loop runs inside one block and h
// never leaves the registers: device memory sees O(S di) traffic, not
// O(S di N). One thread holds one h[b, d, n]; the N lanes of a channel are
// neighbours in a warp, and a block of 256 threads covers 256 / N channels
// of one batch row. Per chunk of 32 time steps the block stages x and dt of
// its channels and B and C into shared memory with coalesced loads; each
// step then reads x_t and dt_t (the same word for a channel's N lanes) and
// B_t[n], C_t[n] from shared memory, and y_t is a shuffle reduction over
// the N lanes, staged again so that y is written coalesced. Any S works:
// the last chunk is shorter, with no padding. The update is written with
// __fmul_rn / __fadd_rn and the accurate expf (no FMA contraction, no fast
// math) in the plain version's order, so h follows it step for step; only
// the order of the N-term sum in y differs. Speed (exp2 with a prescaled A,
// vectorized loads, several states a thread, a split of S across blocks
// with a second pass that carries the state) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int SS_THREADS = 256;
constexpr int SS_CHUNK = 32;  // time steps staged in shared memory at once

template <int N>
__global__ void __launch_bounds__(SS_THREADS)
    selective_scan_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          const float* __restrict__ dskip,
                          float* __restrict__ y, float* __restrict__ h_last,
                          int S, int di) {
  constexpr int CH = SS_THREADS / N;  // channels of one block
  __shared__ float s_b[SS_CHUNK][N], s_c[SS_CHUNK][N];
  __shared__ float s_x[SS_CHUNK][CH], s_dt[SS_CHUNK][CH], s_y[SS_CHUNK][CH];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / N, n = threadIdx.x % N;
  const int d = d0 + c;
  const bool live = d < di;
  // a dead lane (ragged di) runs with A = 0 and zero inputs: h stays 0
  const float a_dn = live ? a[static_cast<size_t>(d) * N + n] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * S;  // first (b, t) row
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += SS_CHUNK) {
    const int tn = min(SS_CHUNK, S - t0);
    __syncthreads();  // the previous chunk's s_y is written out
    for (int i = threadIdx.x; i < SS_CHUNK * N; i += SS_THREADS) {
      const int tt = i / N, nn = i % N;
      const bool ok = tt < tn;
      const size_t off = (row0 + t0 + tt) * N + nn;
      s_b[tt][nn] = ok ? bm[off] : 0.f;
      s_c[tt][nn] = ok ? cm[off] : 0.f;
    }
    for (int i = threadIdx.x; i < SS_CHUNK * CH; i += SS_THREADS) {
      const int tt = i / CH, cc = i % CH;
      const bool ok = tt < tn && d0 + cc < di;
      const size_t off = (row0 + t0 + tt) * di + d0 + cc;
      s_x[tt][cc] = ok ? x[off] : 0.f;
      s_dt[tt][cc] = ok ? dt[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {  // tn is the same for the whole block
      const float dt_t = s_dt[tt][c];
      const float decay = expf(__fmul_rn(dt_t, a_dn));
      const float u = __fmul_rn(__fmul_rn(dt_t, s_x[tt][c]), s_b[tt][n]);
      h = __fadd_rn(__fmul_rn(decay, h), u);
      float p = __fmul_rn(h, s_c[tt][n]);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off, N));
      if (n == 0) s_y[tt][c] = p;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tn * CH; i += SS_THREADS) {
      const int tt = i / CH, cc = i % CH;
      if (d0 + cc < di) {
        const size_t off = (row0 + t0 + tt) * di + d0 + cc;
        y[off] = __fadd_rn(s_y[tt][cc], __fmul_rn(s_x[tt][cc], dskip[d0 + cc]));
      }
    }
  }
  if (live) h_last[(static_cast<size_t>(b) * di + d) * N + n] = h;
}

template <int N>
void launch(const float* x, const float* dt, const float* bm, const float* cm,
            const float* a, const float* dskip, float* y, float* h_last,
            int B, int S, int di, cudaStream_t stream) {
  constexpr int CH = SS_THREADS / N;
  dim3 grid((di + CH - 1) / CH, B);
  selective_scan_kernel<N><<<grid, SS_THREADS, 0, stream>>>(
      x, dt, bm, cm, a, dskip, y, h_last, S, di);
}

}  // namespace

// The state size N must be 16 (falcon-mamba-7b) or 8 (its smoke config); the
// wrapper checks it first. Any other N returns cudaErrorInvalidValue without
// launching.
extern "C" int selective_scan_launch(const float* x, const float* dt,
                                     const float* bm, const float* cm,
                                     const float* a, const float* dskip,
                                     float* y, float* h_last, int B, int S,
                                     int di, int N, cudaStream_t stream) {
  if (B <= 0 || di <= 0) return static_cast<int>(cudaGetLastError());
  switch (N) {
    case 8: launch<8>(x, dt, bm, cm, a, dskip, y, h_last, B, S, di, stream); break;
    case 16: launch<16>(x, dt, bm, cm, a, dskip, y, h_last, B, S, di, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
