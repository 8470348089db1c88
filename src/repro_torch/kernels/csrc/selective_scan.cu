// Mamba-1 selective scan: for every (batch b, channel d, state n)
//   h_t = exp(dt_t A[d, n]) h_{t-1} + (dt_t x_t) B_t[n],   h_{-1} = 0,
//   y_t = sum_n h_t[n] C_t[n] + D[d] x_t,
// over x, dt [B, S, di], B, C [B, S, N] (each f32 or bf16, one type for
// all four, widened to f32 on load), A f32 [di, N] (negative), D f32 [di];
// writes y [B, S, di] in x's type and the final state h_last f32 [B, di, N]
// (the prefill -> decode handoff). Any N up to 512. Asked for (hs not
// null), the states variant also writes the state at the start of every
// chunk of hk steps but the first, hs [B, ceil(S / hk) - 1, di, N] f32: the
// backward (csrc/selective_scan_bwd.cu) rebuilds each chunk from it; with y
// null it writes the states alone (the backward called without them): C is
// then neither staged nor read.
//
// Replaces: src/repro/kernels/selective_scan.py, selective_scan /
// _scan_kernel.
//
// Bound on the H100: at the falcon-mamba-7b prefill shape [B, S, di, N] =
// [8, 256, 8192, 16] the kernel must read x and dt and write y (3 x 67 MB),
// read B and C (0.26 MB) and A (0.5 MB) and write h_last (4.2 MB): ~206 MB,
// 0.061 ms at 3.35 TB/s. What bounds the states variant is the instructions
// issued per (b, t, d, n): B S di N = 2.7e8 of them, each an accurate expf
// (one MUFU.EX2 and ~7 FP32-pipe instructions), dt A, the three rounded
// operations of the update and one FMA into y: ~13 issue slots, ~0.12 ms at
// 128 lanes a clock on 132 SMs. The lane variant (the first port's design) spent ~30
// a state: each of the N lanes of a channel reloaded x_t and dt_t and
// formed dt x, read B_t[n] and C_t[n] alone, and ended every step with a
// log2 N shuffle reduction and a branch for the store (0.43 ms).
//
// Design: two variants.
//
// States variant (1): the TPU kernel walks S as its innermost,
// sequential grid axis and carries h in VMEM scratch; here the whole S loop
// runs inside one block and h never leaves the registers. A thread holds
// SPT in {4, 8, 16} consecutive states of one channel (N padded to a power
// of two Np = SPT L, the padded states with a = 0 and b = c = 0, which stay
// exactly 0 and add exact zeros), so x_t, dt_t and dt x are loaded and
// formed once for SPT states, B_t and C_t are read 16 bytes at a time, the
// y partial sum stays in registers, and log2 L shuffles finish it. L = Np /
// SPT lanes of a warp share a channel; a block of 128 threads covers 128 / L
// channels of one batch row. scan_layout (kernels/selective_scan.py) picks
// SPT per shape: the least work an SM in whole waves of blocks, among the
// widths that leave an SM enough warps (3/4 SPT) to hide a wider thread's
// latency, timed at every group size of the falcon-mamba prefill (a grouped
// 8 x 256 prefill: SPT 16, one thread a channel; 2-5 prompts: SPT 8; a
// single prompt: SPT 4). Chunks of 16 time steps of x, dt, B and C are staged with 16-byte
// cp.async into a double-buffered ring (plain loads where an operand is not
// 16-byte aligned or its rows are not whole 16-byte chunks), the next chunk
// in flight while the current one scans. Each step's y is stored straight
// from the registers by the channel's first lane: neighbouring channels are
// neighbouring threads, so a warp's stores are coalesced. The update is
// written with __fmul_rn / __fadd_rn and the accurate expf (no FMA
// contraction, no fast math, no exp2 with a prescaled A: that would change
// h's bits) in the plain version's order, so h follows it step for step and
// h_last is bit-equal; only the order of the N-term sum in y differs. The
// saved states are those registers at the chunk boundaries: the kernels
// that save (selective_scan_save_kernel, f32, a __global__ of their own)
// walk each staged chunk in runs of hk steps and write after each run, so
// no step carries a test; 16-byte stores, coalesced like h_last's. The
// kernels that do not save are the serving path's and keep their own code:
// a save flag or a shared step body in one kernel made them slower on the
// H100.
//
// Lane variant (2, the first port's kernel, kept as the yardstick that
// chip_smoke.py times the states variant against; f32, N in {8, 16}): one
// thread a state, the N lanes of a channel neighbours in a warp, chunks of
// 32 steps staged by plain loads between two __syncthreads, y a shuffle
// reduction staged in shared memory and written coalesced.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "f32_io.cuh"

#include "int8_mma.cuh"  // cp.async helpers

namespace {

using repro::narrow;
using repro::widen;

using repro::mma8::cp_async;
using repro::mma8::cp_async_commit;
using repro::mma8::cp_async_wait;
using repro::mma8::smem_u32;

constexpr int SCAN_THREADS = 128;
constexpr int SCAN_STEPS = 16;  // time steps of one staged chunk

// K consecutive elements at p (p aligned to four elements), widened
template <int K>
__device__ inline void load_run(const float* p, float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + k);
    v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
  }
}
template <int K>
__device__ inline void load_run(const __nv_bfloat16* p, float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p + k);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[k] = lo.x; v[k + 1] = lo.y; v[k + 2] = hi.x; v[k + 3] = hi.y;
  }
}

// Stage `rows` rows of `cols` elements of a tensor with row stride `ld` at
// g into shared memory s (row stride `cols`); columns >= cols_ok are zeros.
// vec: 16-byte cp.async (g, ld and cols_ok whole 16-byte chunks); else
// plain loads.
template <typename T>
__device__ inline void stage(T* s, const T* __restrict__ g, int64_t ld, int rows,
                             int cols, int cols_ok, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = cols / E;
    for (int i = threadIdx.x; i < rows * per_row; i += SCAN_THREADS) {
      const int r = i / per_row, q = (i % per_row) * E;
      const bool ok = q < cols_ok;
      cp_async<16>(smem_u32(s + r * cols + q), ok ? g + r * ld + q : g, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += SCAN_THREADS) {
      const int r = i / cols, q = i % cols;
      s[r * cols + q] = q < cols_ok ? g[r * ld + q] : narrow<T>(0.f);
    }
  }
}

template <typename T, int SPT, int L>
__global__ void __launch_bounds__(SCAN_THREADS)
    selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                          const T* __restrict__ bm, const T* __restrict__ cm,
                          const float* __restrict__ a, const float* __restrict__ dskip,
                          T* __restrict__ y, float* __restrict__ h_last, int S, int di,
                          int N, int sb, int vec_x, int vec_bc) {
  constexpr int CH = SCAN_THREADS / L;  // channels of one block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);
  // one slot: x [STEPS][CH], dt [STEPS][CH], B [STEPS][sb], C [STEPS][sb]
  const int slot = SCAN_STEPS * (2 * CH + 2 * sb);
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / L, g = threadIdx.x % L;
  const int d = d0 + c;
  const bool live = d < di;
  const int cols_ok = min(CH, di - d0);
  // a dead channel (ragged di) or padded state runs with a = 0 and zero
  // inputs: its h stays exactly 0
  float av[SPT], h[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int n = g * SPT + k;
    av[k] = live && n < N ? a[static_cast<int64_t>(d) * N + n] : 0.f;
    h[k] = 0.f;
  }
  const float dd = live ? dskip[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * S;  // first (b, t) row
  const int chunks = (S + SCAN_STEPS - 1) / SCAN_STEPS;
  auto load_chunk = [&](int ch) {
    T* s = ring + (ch & 1) * slot;
    const int64_t r = row0 + static_cast<int64_t>(ch) * SCAN_STEPS;
    const int tn = min(SCAN_STEPS, S - ch * SCAN_STEPS);
    stage(s, x + r * di + d0, di, tn, CH, cols_ok, vec_x);
    stage(s + SCAN_STEPS * CH, dt + r * di + d0, di, tn, CH, cols_ok, vec_x);
    stage(s + 2 * SCAN_STEPS * CH, bm + r * N, N, tn, sb, N, vec_bc);
    stage(s + 2 * SCAN_STEPS * CH + SCAN_STEPS * sb, cm + r * N, N, tn, sb, N, vec_bc);
  };
  if (chunks > 0) load_chunk(0);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) load_chunk(ch + 1);  // in flight while this one scans
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch (cp.async or plain stores) visible to all
    const T* sx = ring + (ch & 1) * slot;
    const T* sdt = sx + SCAN_STEPS * CH;
    const T* sbm = sx + 2 * SCAN_STEPS * CH + g * SPT;
    const T* scm = sbm + SCAN_STEPS * sb;
    const int64_t r = row0 + static_cast<int64_t>(ch) * SCAN_STEPS;
    const int tn = min(SCAN_STEPS, S - ch * SCAN_STEPS);  // block-uniform
#pragma unroll 2
    for (int tt = 0; tt < tn; ++tt) {
      const float xt = widen(sx[tt * CH + c]);
      const float dtt = widen(sdt[tt * CH + c]);
      const float dtx = __fmul_rn(dtt, xt);
      float bv[SPT], cv[SPT];
      load_run<SPT>(sbm + tt * sb, bv);
      load_run<SPT>(scm + tt * sb, cv);
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const float decay = expf(__fmul_rn(dtt, av[k]));
        h[k] = __fadd_rn(__fmul_rn(decay, h[k]), __fmul_rn(dtx, bv[k]));
        p = fmaf(h[k], cv[k], p);
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (g == 0 && live)
        y[(r + tt) * di + d] = narrow<T>(__fadd_rn(p, __fmul_rn(xt, dd)));
    }
    __syncthreads();  // slot ch & 1 is free for chunk ch + 2
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int n = g * SPT + k;
      if (n < N) h_last[(static_cast<int64_t>(b) * di + d) * N + n] = h[k];
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int SPT, int L>
int launch_states(const void* x, const void* dt, const void* bm, const void* cm,
                  const float* a, const float* dskip, void* y, float* h_last, int B,
                  int S, int di, int N, cudaStream_t stream) {
  constexpr int CH = SCAN_THREADS / L;
  const int sb = (SPT * L + 7) / 8 * 8;  // B/C row in shared memory: 16-byte multiple
  const size_t smem = 2 * SCAN_STEPS * (2 * CH + 2 * sb) * sizeof(T);
  auto kernel = selective_scan_kernel<T, SPT, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec_x = aligned16(x) && aligned16(dt) && di * sizeof(T) % 16 == 0 &&
                    CH * sizeof(T) % 16 == 0;
  const int vec_bc = aligned16(bm) && aligned16(cm) && N * sizeof(T) % 16 == 0;
  const dim3 grid((di + CH - 1) / CH, B);
  kernel<<<grid, SCAN_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), a, dskip, static_cast<T*>(y), h_last, S, di, N, sb,
      vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int SPT>
int dispatch_lanes(int lanes, const void* x, const void* dt, const void* bm,
                   const void* cm, const float* a, const float* dskip, void* y,
                   float* h_last, int B, int S, int di, int N, cudaStream_t stream) {
  switch (lanes) {
#define SCAN_CASE(LANES)                                                              \
  case LANES:                                                                         \
    return launch_states<T, SPT, LANES>(x, dt, bm, cm, a, dskip, y, h_last, B, S, di, \
                                        N, stream);
    SCAN_CASE(1) SCAN_CASE(2) SCAN_CASE(4) SCAN_CASE(8) SCAN_CASE(16) SCAN_CASE(32)
#undef SCAN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int spt, int lanes, const void* x, const void* dt, const void* bm,
             const void* cm, const float* a, const float* dskip, void* y, float* h_last,
             int B, int S, int di, int N, cudaStream_t stream) {
  switch (spt) {
    case 4: return dispatch_lanes<T, 4>(lanes, x, dt, bm, cm, a, dskip, y, h_last, B, S, di, N, stream);
    case 8: return dispatch_lanes<T, 8>(lanes, x, dt, bm, cm, a, dskip, y, h_last, B, S, di, N, stream);
    case 16: return dispatch_lanes<T, 16>(lanes, x, dt, bm, cm, a, dskip, y, h_last, B, S, di, N, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// states variant, saving (f32, the training forward): the chunk-start states
// ---------------------------------------------------------------------------

// The states kernel's walk, which also writes the state at the start of every
// chunk of hk steps but the first to hs (hk divides SCAN_STEPS): it walks
// each staged chunk in runs of hk steps and writes after each whole run, so
// no step carries a test. y may be null (the states alone): C is then neither
// staged nor read. A __global__ of its own, so that selective_scan_kernel
// compiles as it did before states could be saved.
template <int SPT, int L>
__global__ void __launch_bounds__(SCAN_THREADS)
    selective_scan_save_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                               const float* __restrict__ bm, const float* __restrict__ cm,
                               const float* __restrict__ a,
                               const float* __restrict__ dskip, float* __restrict__ y,
                               float* __restrict__ h_last, float* __restrict__ hs, int hk,
                               int S, int di, int N, int sb, int vec_x, int vec_bc) {
  constexpr int CH = SCAN_THREADS / L;  // channels of one block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const ring = reinterpret_cast<float*>(smem_raw);
  // one slot: x [STEPS][CH], dt [STEPS][CH], B [STEPS][sb], C [STEPS][sb]
  const int slot = SCAN_STEPS * (2 * CH + 2 * sb);
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / L, g = threadIdx.x % L;
  const int d = d0 + c;
  const bool live = d < di;
  const int cols_ok = min(CH, di - d0);
  float av[SPT], h[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int n = g * SPT + k;
    av[k] = live && n < N ? a[static_cast<int64_t>(d) * N + n] : 0.f;
    h[k] = 0.f;
  }
  const float dd = live ? dskip[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * S;  // first (b, t) row
  const int chunks = (S + SCAN_STEPS - 1) / SCAN_STEPS;
  const bool want_y = y != nullptr;                  // block-uniform
  const int saved = (S + hk - 1) / hk - 1;           // chunk starts in hs
  auto load_chunk = [&](int ch) {
    float* s = ring + (ch & 1) * slot;
    const int64_t r = row0 + static_cast<int64_t>(ch) * SCAN_STEPS;
    const int tn = min(SCAN_STEPS, S - ch * SCAN_STEPS);
    stage(s, x + r * di + d0, di, tn, CH, cols_ok, vec_x);
    stage(s + SCAN_STEPS * CH, dt + r * di + d0, di, tn, CH, cols_ok, vec_x);
    stage(s + 2 * SCAN_STEPS * CH, bm + r * N, N, tn, sb, N, vec_bc);
    if (want_y)
      stage(s + 2 * SCAN_STEPS * CH + SCAN_STEPS * sb, cm + r * N, N, tn, sb, N, vec_bc);
  };
  if (chunks > 0) load_chunk(0);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) load_chunk(ch + 1);  // in flight while this one scans
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk ch (cp.async or plain stores) visible to all
    const float* sx = ring + (ch & 1) * slot;
    const float* sdt = sx + SCAN_STEPS * CH;
    const float* sbm = sx + 2 * SCAN_STEPS * CH + g * SPT;
    const float* scm = sbm + SCAN_STEPS * sb;
    const int64_t r = row0 + static_cast<int64_t>(ch) * SCAN_STEPS;
    const int tn = min(SCAN_STEPS, S - ch * SCAN_STEPS);  // block-uniform
    for (int t0 = 0; t0 < tn; t0 += hk) {
      const int te = min(tn, t0 + hk);
#pragma unroll 2
      for (int tt = t0; tt < te; ++tt) {
        const float xt = sx[tt * CH + c];
        const float dtt = sdt[tt * CH + c];
        const float dtx = __fmul_rn(dtt, xt);
        float bv[SPT], cv[SPT];
        load_run<SPT>(sbm + tt * sb, bv);
        if (want_y) {
          load_run<SPT>(scm + tt * sb, cv);
        } else {
#pragma unroll
          for (int k = 0; k < SPT; ++k) cv[k] = 0.f;
        }
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const float decay = expf(__fmul_rn(dtt, av[k]));
          h[k] = __fadd_rn(__fmul_rn(decay, h[k]), __fmul_rn(dtx, bv[k]));
          p = fmaf(h[k], cv[k], p);
        }
        if (want_y) {
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
          if (g == 0 && live) y[(r + tt) * di + d] = __fadd_rn(p, __fmul_rn(xt, dd));
        }
      }
      const int t1 = ch * SCAN_STEPS + te;  // h is now the state before step t1
      if (te == t0 + hk && t1 < S && live) {
        float* out =
            hs + ((static_cast<int64_t>(b) * saved + t1 / hk - 1) * di + d) * N + g * SPT;
        if (N % 4 == 0) {  // 16-byte stores
#pragma unroll
          for (int k = 0; k < SPT; k += 4)
            if (g * SPT + k < N)
              *reinterpret_cast<float4*>(out + k) =
                  make_float4(h[k], h[k + 1], h[k + 2], h[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < SPT; ++k)
            if (g * SPT + k < N) out[k] = h[k];
        }
      }
    }
    __syncthreads();  // slot ch & 1 is free for chunk ch + 2
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int n = g * SPT + k;
      if (n < N) h_last[(static_cast<int64_t>(b) * di + d) * N + n] = h[k];
    }
  }
}

template <int SPT, int L>
int launch_save(const float* x, const float* dt, const float* bm, const float* cm,
                const float* a, const float* dskip, float* y, float* h_last, float* hs,
                int hk, int B, int S, int di, int N, cudaStream_t stream) {
  constexpr int CH = SCAN_THREADS / L;
  const int sb = (SPT * L + 7) / 8 * 8;  // B/C row in shared memory: 16-byte multiple
  const size_t smem = 2 * SCAN_STEPS * (2 * CH + 2 * sb) * sizeof(float);
  auto kernel = selective_scan_save_kernel<SPT, L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec_x = aligned16(x) && aligned16(dt) && di % 4 == 0 && CH % 4 == 0;
  const int vec_bc = aligned16(bm) && aligned16(cm) && N % 4 == 0;
  const dim3 grid((di + CH - 1) / CH, B);
  kernel<<<grid, SCAN_THREADS, smem, stream>>>(x, dt, bm, cm, a, dskip, y, h_last, hs, hk, S,
                                               di, N, sb, vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

template <int SPT>
int dispatch_save_lanes(int lanes, const float* x, const float* dt, const float* bm,
                        const float* cm, const float* a, const float* dskip, float* y,
                        float* h_last, float* hs, int hk, int B, int S, int di, int N,
                        cudaStream_t stream) {
  switch (lanes) {
#define SAVE_CASE(LANES)                                                                 \
  case LANES:                                                                            \
    return launch_save<SPT, LANES>(x, dt, bm, cm, a, dskip, y, h_last, hs, hk, B, S, di, \
                                   N, stream);
    SAVE_CASE(1) SAVE_CASE(2) SAVE_CASE(4) SAVE_CASE(8) SAVE_CASE(16) SAVE_CASE(32)
#undef SAVE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// lane variant (the first port's design): one thread a state, f32, N in {8, 16}
// ---------------------------------------------------------------------------

constexpr int LANE_THREADS = 256;
constexpr int LANE_CHUNK = 32;  // time steps staged in shared memory at once

template <int N>
__global__ void __launch_bounds__(LANE_THREADS)
    selective_scan_lane_kernel(const float* __restrict__ x,
                               const float* __restrict__ dt,
                               const float* __restrict__ bm,
                               const float* __restrict__ cm,
                               const float* __restrict__ a,
                               const float* __restrict__ dskip,
                               float* __restrict__ y, float* __restrict__ h_last,
                               int S, int di) {
  constexpr int CH = LANE_THREADS / N;  // channels of one block
  __shared__ float s_b[LANE_CHUNK][N], s_c[LANE_CHUNK][N];
  __shared__ float s_x[LANE_CHUNK][CH], s_dt[LANE_CHUNK][CH], s_y[LANE_CHUNK][CH];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / N, n = threadIdx.x % N;
  const int d = d0 + c;
  const bool live = d < di;
  const float a_dn = live ? a[static_cast<size_t>(d) * N + n] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * S;
  float h = 0.f;
  for (int t0 = 0; t0 < S; t0 += LANE_CHUNK) {
    const int tn = min(LANE_CHUNK, S - t0);
    __syncthreads();  // the previous chunk's s_y is written out
    for (int i = threadIdx.x; i < LANE_CHUNK * N; i += LANE_THREADS) {
      const int tt = i / N, nn = i % N;
      const bool ok = tt < tn;
      const size_t off = (row0 + t0 + tt) * N + nn;
      s_b[tt][nn] = ok ? bm[off] : 0.f;
      s_c[tt][nn] = ok ? cm[off] : 0.f;
    }
    for (int i = threadIdx.x; i < LANE_CHUNK * CH; i += LANE_THREADS) {
      const int tt = i / CH, cc = i % CH;
      const bool ok = tt < tn && d0 + cc < di;
      const size_t off = (row0 + t0 + tt) * di + d0 + cc;
      s_x[tt][cc] = ok ? x[off] : 0.f;
      s_dt[tt][cc] = ok ? dt[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
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
    for (int i = threadIdx.x; i < tn * CH; i += LANE_THREADS) {
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
void launch_lane(const float* x, const float* dt, const float* bm, const float* cm,
                 const float* a, const float* dskip, float* y, float* h_last, int B,
                 int S, int di, cudaStream_t stream) {
  constexpr int CH = LANE_THREADS / N;
  const dim3 grid((di + CH - 1) / CH, B);
  selective_scan_lane_kernel<N><<<grid, LANE_THREADS, 0, stream>>>(
      x, dt, bm, cm, a, dskip, y, h_last, S, di);
}

}  // namespace

// The states variant. x_bf16: 0 when x, dt, B, C are f32, 1 when bf16. spt
// and lanes come from scan_layout: spt in {4, 8, 16}, lanes a power of two
// up to 32, N <= spt * lanes. Anything else returns cudaErrorInvalidValue
// without launching.
extern "C" int selective_scan_launch(const void* x, const void* dt, const void* bm,
                                     const void* cm, const float* a, const float* dskip,
                                     void* y, float* h_last, int B, int S, int di, int N,
                                     int x_bf16, int spt, int lanes, cudaStream_t stream) {
  if (N <= 0 || N > spt * lanes) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || di <= 0) return static_cast<int>(cudaGetLastError());
  if (x_bf16)
    return dispatch<__nv_bfloat16>(spt, lanes, x, dt, bm, cm, a, dskip, y, h_last, B, S,
                                   di, N, stream);
  return dispatch<float>(spt, lanes, x, dt, bm, cm, a, dskip, y, h_last, B, S, di, N,
                         stream);
}

// The states variant saving the chunk-start states (f32 only): as
// selective_scan_launch, and hs [B, ceil(S / hk) - 1, di, N] the state at
// the start of every chunk of hk steps but the first (hk a power of two up
// to SCAN_STEPS = 16; hs may be null only where there is none, S <= hk);
// y may be null (the states alone, C not read) where hs is not. Anything
// else returns cudaErrorInvalidValue without launching.
extern "C" int selective_scan_save_launch(const float* x, const float* dt, const float* bm,
                                          const float* cm, const float* a,
                                          const float* dskip, float* y, float* h_last,
                                          float* hs, int B, int S, int di, int N, int spt,
                                          int lanes, int hk, cudaStream_t stream) {
  if (N <= 0 || N > spt * lanes || hk <= 0 || hk > SCAN_STEPS || (hk & (hk - 1)) != 0 ||
      (hs == nullptr && (S > hk || y == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || di <= 0) return static_cast<int>(cudaGetLastError());
  switch (spt) {
#define SAVE_SPT(SPT)                                                                     \
  case SPT:                                                                               \
    return dispatch_save_lanes<SPT>(lanes, x, dt, bm, cm, a, dskip, y, h_last, hs, hk, B, \
                                    S, di, N, stream);
    SAVE_SPT(4) SAVE_SPT(8) SAVE_SPT(16)
#undef SAVE_SPT
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The lane variant: f32 only, N 16 (falcon-mamba-7b) or 8; any other N
// returns cudaErrorInvalidValue without launching.
extern "C" int selective_scan_lane_launch(const float* x, const float* dt,
                                          const float* bm, const float* cm,
                                          const float* a, const float* dskip, float* y,
                                          float* h_last, int B, int S, int di, int N,
                                          cudaStream_t stream) {
  if (B <= 0 || di <= 0) return static_cast<int>(cudaGetLastError());
  switch (N) {
    case 8: launch_lane<8>(x, dt, bm, cm, a, dskip, y, h_last, B, S, di, stream); break;
    case 16: launch_lane<16>(x, dt, bm, cm, a, dskip, y, h_last, B, S, di, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
