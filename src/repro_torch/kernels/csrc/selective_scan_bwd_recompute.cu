// Mamba-1 selective scan, backward: the recompute variant (2), the
// backward's first design, kept as the yardstick that chip_smoke.py times
// the saved variant (csrc/selective_scan_bwd.cu) against; the wrapper
// reaches it only with variant=2. Same contract and math as that file.
//
// Design: four launches, no atomics, every sum in a fixed order (two calls
// are bit-equal).
//  1. scan_bwd_states_kernel walks the forward once and writes the state at
//     the start of every chunk of K time steps to a workspace
//     [B, ceil(S / K), di, N] (chunk 0 starts at zero and is not written).
//  2. scan_bwd_kernel walks the chunks from last to first. For each, it
//     stages x, dt, dy, B and C of the chunk in shared memory, rebuilds the
//     chunk's K states from the saved start (h in the forward's rounding)
//     into a shared-memory history [K][SPT][threads], reduces h_t dy_t over
//     the block's channels into dC, then runs the g recurrence backwards,
//     recomputing exp(dt A), g carried in registers from chunk to chunk.
//     Each step's dx and ddt finish in registers plus log2 L shuffles and
//     are written by the channel's first lane. The step overwrites its
//     history slot with g_t dt_t x_t, which the block then reduces over its
//     channels into dB. dA accumulates in registers over t. The per-block
//     sums of dB and dC go to partials [blocks along di][2][B, S, N]; dA to
//     [B, di, N].
//  3. scan_bwd_reduce_kernel sums the dB / dC partials over the blocks in
//     block order, and
//  4. the dA partials over the batch rows in row order.
// Layout: a thread holds SPT consecutive states of one channel and L = Np /
// SPT lanes share a channel (Np: N padded to a power of two >= 4; padded
// states have A = 0 and B = C = 0, so their g stays exactly 0): SPT = 4 up
// to N = 128, then lanes = 32. A block is 256 threads, 256 / L channels of
// one batch row; K = 64 / SPT time steps, so the history takes 64 KB (two
// blocks an SM). The channel sums inside a block are a warp per (t, n):
// lanes stride over the channels (a 4-way bank conflict at L = 4), then
// five dependent shuffles. At [2, 4096, 8192, 16] it spends about three
// times the forward's ~13 issue slots a state step (the states pass, the
// rebuild, and the reverse step's second exp(dt A)).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BWD_THREADS = 256;

__host__ __device__ constexpr int chunk_steps(int spt) { return 64 / spt; }

// Stage `rows_ok` rows of `cols` floats of a tensor with row stride `ld` at
// g into s ([rows][cols]); rows >= rows_ok and columns >= cols_ok are zeros.
__device__ inline void stage(float* s, const float* __restrict__ g, int64_t ld, int rows,
                             int rows_ok, int cols, int cols_ok) {
  for (int i = threadIdx.x; i < rows * cols; i += BWD_THREADS) {
    const int r = i / cols, q = i % cols;
    s[i] = r < rows_ok && q < cols_ok ? g[r * ld + q] : 0.f;
  }
}

template <int K>
__device__ inline void load_run(const float* p, float (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + k);
    v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
  }
}

template <int SPT, int L>
__global__ void __launch_bounds__(BWD_THREADS)
    scan_bwd_states_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ bm, const float* __restrict__ a,
                           float* __restrict__ hs, int S, int di, int N, int nck) {
  constexpr int CH = BWD_THREADS / L, K = chunk_steps(SPT), NP = SPT * L;
  __shared__ __align__(16) float sx[K * CH], sdt[K * CH], sb[K * NP];
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
  const int64_t row0 = static_cast<int64_t>(b) * S;
  for (int ch = 0; ch < nck; ++ch) {
    if (ch > 0 && live) {
      float* out = hs + ((static_cast<int64_t>(b) * nck + ch) * di + d) * N;
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        if (g * SPT + k < N) out[g * SPT + k] = h[k];
    }
    if (ch == nck - 1) break;  // the last chunk's steps feed no saved state
    const int t0 = ch * K;
    __syncthreads();  // the previous chunk's staged rows are read
    stage(sx, x + (row0 + t0) * di + d0, di, K, K, CH, cols_ok);
    stage(sdt, dt + (row0 + t0) * di + d0, di, K, K, CH, cols_ok);
    stage(sb, bm + (row0 + t0) * N, N, K, K, NP, N);
    __syncthreads();
#pragma unroll 2
    for (int tt = 0; tt < K; ++tt) {  // not the last chunk: K whole steps
      const float dtt = sdt[tt * CH + c];
      const float dtx = __fmul_rn(dtt, sx[tt * CH + c]);
      float bv[SPT];
      load_run<SPT>(sb + tt * NP + g * SPT, bv);
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const float decay = expf(__fmul_rn(dtt, av[k]));
        h[k] = __fadd_rn(__fmul_rn(decay, h[k]), __fmul_rn(dtx, bv[k]));
      }
    }
  }
}

// out[(row + tt) N + n] = sum over the block's channels c of
// hist[tt][n][c] (times w[tt][c] where w is given), for tt < tn, n < N: a
// warp per (tt, n), its lanes striding over the channels, then a shuffle
// tree. Padded and dead channels hold zeros.
template <int SPT, int L>
__device__ inline void reduce_channels(const float* hist, const float* w,
                                       float* __restrict__ out, int64_t row, int tn,
                                       int N) {
  constexpr int CH = BWD_THREADS / L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < tn * N; p += BWD_THREADS / 32) {
    const int tt = p / N, n = p % N;
    const float* hp = hist + (tt * SPT + n % SPT) * BWD_THREADS + n / SPT;
    float s = 0.f;
    for (int cc = lane; cc < CH; cc += 32)
      s = w ? fmaf(hp[cc * L], w[tt * CH + cc], s) : __fadd_rn(s, hp[cc * L]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) out[(row + tt) * N + n] = s;
  }
}

template <int SPT, int L>
__global__ void __launch_bounds__(BWD_THREADS)
    scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dskip,
                    const float* __restrict__ dy, const float* __restrict__ dh_last,
                    const float* __restrict__ hs, float* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ part,
                    float* __restrict__ da_part, int B, int S, int di, int N, int nck) {
  constexpr int CH = BWD_THREADS / L, K = chunk_steps(SPT), NP = SPT * L;
  extern __shared__ __align__(16) float smem[];
  float* const hist = smem;                      // [K][SPT][BWD_THREADS]
  float* const sb = hist + K * SPT * BWD_THREADS;  // [K][NP]
  float* const sc = sb + K * NP;                 // [K][NP]
  float* const sx = sc + K * NP;                 // [K][CH]
  float* const sdt = sx + K * CH;
  float* const sdy = sdt + K * CH;
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / L, g = threadIdx.x % L;
  const int d = d0 + c;
  const bool live = d < di;
  const int cols_ok = min(CH, di - d0);
  float av[SPT], carry[SPT], acc[SPT], h0[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int n = g * SPT + k;
    const bool on = live && n < N;
    av[k] = on ? a[static_cast<int64_t>(d) * N + n] : 0.f;
    carry[k] = on && dh_last ? dh_last[(static_cast<int64_t>(b) * di + d) * N + n] : 0.f;
    acc[k] = 0.f;
  }
  const float dd = live ? dskip[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * S;
  const int64_t plane = static_cast<int64_t>(B) * S * N;
  float* const db_part = part + static_cast<int64_t>(blockIdx.x) * 2 * plane;
  float* const dc_part = db_part + plane;
  for (int ch = nck - 1; ch >= 0; --ch) {
    const int t0 = ch * K, tn = min(K, S - t0);
    __syncthreads();  // the previous chunk's history and staged rows are read
    stage(sx, x + (row0 + t0) * di + d0, di, K, tn, CH, cols_ok);
    stage(sdt, dt + (row0 + t0) * di + d0, di, K, tn, CH, cols_ok);
    stage(sdy, dy + (row0 + t0) * di + d0, di, K, tn, CH, cols_ok);
    stage(sb, bm + (row0 + t0) * N, N, K, tn, NP, N);
    stage(sc, cm + (row0 + t0) * N, N, K, tn, NP, N);
    const float* hstart = hs + ((static_cast<int64_t>(b) * nck + ch) * di + d) * N;
#pragma unroll
    for (int k = 0; k < SPT; ++k)
      h0[k] = ch > 0 && live && g * SPT + k < N ? hstart[g * SPT + k] : 0.f;
    __syncthreads();
    // the chunk's states, in the forward's rounding
    {
      float h[SPT];
#pragma unroll
      for (int k = 0; k < SPT; ++k) h[k] = h0[k];
      for (int tt = 0; tt < tn; ++tt) {
        const float dtt = sdt[tt * CH + c];
        const float dtx = __fmul_rn(dtt, sx[tt * CH + c]);
        float bv[SPT];
        load_run<SPT>(sb + tt * NP + g * SPT, bv);
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          const float decay = expf(__fmul_rn(dtt, av[k]));
          h[k] = __fadd_rn(__fmul_rn(decay, h[k]), __fmul_rn(dtx, bv[k]));
          hist[(tt * SPT + k) * BWD_THREADS + threadIdx.x] = h[k];
        }
      }
    }
    __syncthreads();
    reduce_channels<SPT, L>(hist, sdy, dc_part, row0 + t0, tn, N);  // dC_t = sum_d h_t dy_t
    __syncthreads();  // h_t is overwritten below
    for (int tt = tn - 1; tt >= 0; --tt) {
      const float xt = sx[tt * CH + c], dtt = sdt[tt * CH + c], dyt = sdy[tt * CH + c];
      const float dtx = __fmul_rn(dtt, xt);
      float bv[SPT], cv[SPT];
      load_run<SPT>(sb + tt * NP + g * SPT, bv);
      load_run<SPT>(sc + tt * NP + g * SPT, cv);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        float* slot = hist + (tt * SPT + k) * BWD_THREADS + threadIdx.x;
        const float hp = tt > 0 ? slot[-SPT * BWD_THREADS] : h0[k];
        const float gk = __fadd_rn(__fmul_rn(dyt, cv[k]), carry[k]);
        const float at = expf(__fmul_rn(dtt, av[k]));
        const float q = __fmul_rn(__fmul_rn(gk, at), hp);
        s1 = fmaf(gk, bv[k], s1);
        s2 = fmaf(av[k], q, s2);
        acc[k] = __fadd_rn(acc[k], __fmul_rn(q, dtt));
        carry[k] = __fmul_rn(at, gk);
        *slot = __fmul_rn(gk, dtx);  // dB's term; h_t was step tt + 1's h_{t-1}
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
        s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
      }
      if (g == 0 && live) {
        const int64_t at_ = (row0 + t0 + tt) * di + d;
        dx[at_] = __fadd_rn(__fmul_rn(dtt, s1), __fmul_rn(dd, dyt));
        ddt[at_] = __fadd_rn(s2, __fmul_rn(xt, s1));
      }
    }
    __syncthreads();
    reduce_channels<SPT, L>(hist, nullptr, db_part, row0 + t0, tn, N);  // dB_t
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int n = g * SPT + k;
      if (n < N) da_part[(static_cast<int64_t>(b) * di + d) * N + n] = acc[k];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in order, i < count
__global__ void scan_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int64_t count, int parts) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int j = 1; j < parts; ++j) s = __fadd_rn(s, part[j * count + i]);
    out[i] = s;
  }
}

int launch_reduce(const float* part, float* out, int64_t count, int parts,
                  cudaStream_t stream) {
  if (count <= 0) return 0;
  const int64_t blocks = (count + 255) / 256;
  scan_bwd_reduce_kernel<<<static_cast<int>(blocks < 65536 ? blocks : 65536), 256, 0,
                           stream>>>(part, out, count, parts);
  return static_cast<int>(cudaGetLastError());
}

template <int SPT, int L>
int launch(const float* x, const float* dt, const float* bm, const float* cm, const float* a,
           const float* dskip, const float* dy, const float* dh_last, float* hs, float* part,
           float* da_part, float* dx, float* ddt, float* dbc, float* da, int B, int S, int di,
           int N, cudaStream_t stream) {
  constexpr int CH = BWD_THREADS / L, K = chunk_steps(SPT), NP = SPT * L;
  const int nck = (S + K - 1) / K;
  const dim3 grid((di + CH - 1) / CH, B);
  scan_bwd_states_kernel<SPT, L><<<grid, BWD_THREADS, 0, stream>>>(x, dt, bm, a, hs, S, di,
                                                                     N, nck);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t smem = (K * SPT * BWD_THREADS + 2 * K * NP + 3 * K * CH) * sizeof(float);
  auto kernel = scan_bwd_kernel<SPT, L>;
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err) return err;
  kernel<<<grid, BWD_THREADS, smem, stream>>>(x, dt, bm, cm, a, dskip, dy, dh_last, hs, dx,
                                              ddt, part, da_part, B, S, di, N, nck);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_reduce(part, dbc, 2 * static_cast<int64_t>(B) * S * N, grid.x, stream);
  if (err) return err;
  return launch_reduce(da_part, da, static_cast<int64_t>(di) * N, B, stream);
}

}  // namespace

// spt and lanes from kernels/selective_scan.py:scan_bwd_layout: (4, 1..32),
// (8, 32) or (16, 32), N <= spt * lanes. hs holds B x ceil(S / K) x di x N
// floats (K = 64 / spt), part 2 x ceil(di / (256 / lanes)) x B x S x N,
// da_part B x di x N; dbc is [2, B, S, N] (dB then dC). dh_last may be null.
// B, S and di must be positive. Anything else returns cudaErrorInvalidValue
// without launching.
extern "C" int selective_scan_bwd_recompute_launch(
    const float* x, const float* dt, const float* bm, const float* cm, const float* a,
    const float* dskip, const float* dy, const float* dh_last, float* hs, float* part,
    float* da_part, float* dx, float* ddt, float* dbc, float* da, int B, int S, int di, int N,
    int spt, int lanes, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || N > spt * lanes)
    return static_cast<int>(cudaErrorInvalidValue);
#define BWD_CASE(SPT, LANES)                                                              \
  if (spt == SPT && lanes == LANES)                                                       \
    return launch<SPT, LANES>(x, dt, bm, cm, a, dskip, dy, dh_last, hs, part, da_part, dx, \
                              ddt, dbc, da, B, S, di, N, stream);
  BWD_CASE(4, 1) BWD_CASE(4, 2) BWD_CASE(4, 4) BWD_CASE(4, 8) BWD_CASE(4, 16)
  BWD_CASE(4, 32) BWD_CASE(8, 32) BWD_CASE(16, 32)
#undef BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
