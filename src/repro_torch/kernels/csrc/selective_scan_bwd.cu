// Mamba-1 selective scan, backward. For every (batch b, channel d, state n),
// with the forward h_t = a_t h_{t-1} + (dt_t x_t) B_t[n], a_t = exp(dt_t A),
// y_t = sum_n h_t C_t[n] + D x_t, and g_t the gradient of h_t:
//   g_t   = dy_t C_t[n] + a_{t+1} g_{t+1}            (+ dh_last at t = S - 1)
//   dx_t  = dt_t sum_n g_t B_t[n] + D dy_t
//   ddt_t = sum_n A q_t + x_t sum_n g_t B_t[n],       q_t = (g_t a_t) h_{t-1}
//   dB_t  = sum_d g_t (dt_t x_t),   dC_t = sum_d h_t dy_t
//   dA    = sum_b sum_t q_t dt_t
// over f32 x, dt, dy [B, S, di], B, C [B, S, N], A [di, N], D [di], an
// optional dh_last [B, di, N] and the forward's chunk-start states (below);
// writes dx, ddt [B, S, di], dB and dC [B, S, N] (one buffer [2, B, S, N])
// and dA [di, N]. dD = sum dy x is left to one torch reduction in the
// wrapper. Any N up to 512.
//
// Replaces: nothing of the TPU package's kernels. The reference has no
// backward kernel; its gradient is XLA's autodiff of the chunked
// associative scan (src/repro/models/ssm.py:158-177).
//
// Bound on the H100 at falcon-mamba-7b's training shape [B, S, di, N] =
// [2, 4096, 8192, 16], the larger of two times. Bytes: the function must
// read x, dt and dy and write dx and ddt (5 x 268 MB; B, C, A, D and the
// dB / dC / dA / dD outputs add ~1 MB): 1.35 GB, 0.40 ms at 3.35 TB/s.
// Operations: ~20 f32 operations a (b, t, d, n) state step (exp(dt A) and
// the state update 5, g's update and carry 3, q 2, the n sums of dx and
// ddt 4, dA 2, dB and dC 4) over B S di N = 1.07e9 state steps: 2.1e10,
// 0.32 ms at 67 TFLOP/s. So the bytes bound it, at 0.40 ms (chip_smoke.py
// computes the same bound from its run's inputs). What holds this design
// is the instructions it issues. tools/sass_mix.py counts its compiled
// loop at the layout (4 states, 4 lanes): 61.9 instructions a state step
// after the loop's first barrier (static, so an upper bound: the scalar
// staging paths beside the 16-byte ones count too), 31.3 of them the
// step's work (FP32, MUFU, shared memory, shuffles: the rebuild 13.0 with
// the accurate expf's one MUFU, dt A and the update's three rounded
// operations; the reverse step 14.5 with g, g a_t, q, the two n sums, dA,
// the dB term and the dx / ddt shuffles; the two channel passes 3.7), the
// rest integer addressing and control; 18.6 more before that barrier (the
// set-up and the staging). 62 slots over 1.07e9 state steps take 2.0 ms at
// 128 lanes a clock on 132 SMs; the walk (2.5 ms at the training shape,
// PERF.md) runs near that issue time.
//
// Design: the saved variant (1). The recompute variant (2,
// csrc/selective_scan_bwd_recompute.cu, the backward's first design) is the
// yardstick chip_smoke.py times it against.
//  - No states pass. The forward kernel (csrc/selective_scan.cu) writes the
//    state at the start of every chunk of K steps when the autograd
//    function asks for it (hs [B, ceil(S / K) - 1, di, N]; chunk 0 starts
//    at zero); called alone, the wrapper runs the forward kernel for them
//    (without y).
//  - One launch walks the chunks from last to first, then two ordered sums.
//    A chunk's x, dt, dy, B and C are staged by 16-byte cp.async into a
//    double-buffered ring (plain loads where a row is not whole 16-byte
//    chunks), the next chunk in flight while this one walks; each thread
//    loads its own chunk-start state a chunk ahead into registers.
//  - The rebuild runs the chunk's K steps forward from the saved start in
//    the forward's rounding (__fmul_rn / __fadd_rn, the accurate expf), so
//    the states are the forward's bits and dA stays bit-equal to the plain
//    version. It keeps a_t = exp(dt_t A) in registers (K x SPT = 64 a
//    thread: the loops over the chunk are unrolled) and h_t in a
//    shared-memory history [K SPT / 4][threads + 1] of float4 (one float4 of
//    padding a row). The reverse step takes a_t from the registers: one expf
//    a state step in the walk. The steps of the last chunk past S are
//    staged as zeros, which makes each an exact identity (below), so no
//    step is branched around.
//  - Channel sums without atomics, in a fixed order: after the rebuild, a
//    pass sums h_t dy_t over the block's channels into dC; the reverse walk
//    overwrites each history slot with g_t dt_t x_t, and a second pass sums
//    those into dB. A pass gives each (t, float4 of states) item P = 8 / L
//    threads (at L <= 8); a thread sums every P-th channel of its item,
//    float4 by float4 (the padded row stride puts the eight items of a
//    quarter warp on eight bank groups), and the P parts meet in a shuffle
//    tree. Each block writes its sums to partials [blocks along di][2][B,
//    S, N]; a last launch sums the blocks in order. A cluster of eight
//    blocks summing through distributed shared memory instead (partials an
//    eighth the size) walked slower at the training shape, with one
//    cluster barrier a chunk or its arrive and wait a chunk apart (PERF.md
//    section 6).
//  - dx_t and ddt_t go to the staged x_t and dt_t slots (every lane of the
//    channel has used them by the step's shuffles) and leave as 16-byte
//    rows after the walk: a store a step from the registers cost ~20
//    instructions of 64-bit addressing.
//  - Four barriers a chunk (staged; the states; the dC pass has read them;
//    the dB terms and dx / ddt).
// Layout: a thread holds SPT consecutive states of one channel, L = Np /
// SPT lanes share a channel (Np: N padded to a power of two >= 4; padded
// states have A = 0 and B = C = 0, so their g stays exactly 0). A block is
// 128 threads, 128 / L channels of one batch row; K = 64 / SPT steps a
// chunk (the a_t registers). kernels/selective_scan.py:scan_bwd_layout
// takes SPT = 4 up to N = 128, then lanes = 32 (at N 16: 4 lanes, 32
// channels a block, 16 steps a chunk). Budget at that layout: the history
// 16 rows x 129 float4 = 32.25 KB, the ring 2 x 8.75 KB: 49.75 KB a block;
// four blocks an SM take 199 KB (+ 4 KB the system keeps) of the SM's 228
// KB, and 128 registers a thread (a few bytes spilled), the most four
// blocks allow. So 16 warps an SM walk together, 4 a scheduler: all 65,536
// threads of [2, 4096, 8192, 16] (512 blocks) in one wave. Fewer states a
// thread would double the warps but not fit (the a_t registers and history
// halve the chunk, doubling the saved states) and spend more slots on the
// dx / ddt shuffles; the wider layouts (8, 2) and (16, 1) walked slower
// (3.69 and 4.86 ms against 3.31 at the training shape, called alone;
// PERF.md section 6), so they are not built. Blocks of 256 and 512 threads (2 and 1 an SM, partials a
// half and a quarter the size) walked slower; a chunk of 8 steps (32 a_t
// registers) no faster.
// Workspace: the saved states (268 MB at the training shape, K = 16, from
// the forward in training), the block partials 2 B S N x ceil(di / (128 /
// L)) floats (268 MB) and dA's rows B di N (1 MB), every element written
// (allocated without deterministic mode's fill).
// Padding: a step with dt = dy = x = B = C = 0 has a_t = exp(0) = 1, h_t =
// 1 h + 0 = h, g = 0 + carry, q dt = 0 added to dA; its dB / dC terms are
// zeros and its rows are not written.
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_mma.cuh"  // cp.async helpers

namespace {

using repro::mma8::cp_async;
using repro::mma8::cp_async_commit;
using repro::mma8::cp_async_wait;
using repro::mma8::smem_u32;

constexpr int THREADS = 128;
constexpr int STATE_STEPS = 64;  // a thread's state steps a chunk: its a_t registers

template <int SPT, int L>
struct Geo {
  static constexpr int CH = THREADS / L;        // channels of a block
  static constexpr int K = STATE_STEPS / SPT;   // steps of a chunk
  static constexpr int NP = SPT * L;            // states, padded
  static constexpr int Q = SPT / 4;             // float4s of a thread's states
  static constexpr int ROW = THREADS + 1;       // float4s of a history row
  static constexpr int HIST = K * Q * ROW * 4;  // floats of the history
  static constexpr int CHP = CH + 4;            // floats of a staged x / dt / dy row
  static constexpr int SLOT = 3 * K * CHP + 2 * K * NP;  // floats of a ring slot
  static constexpr int ITEMS = K * NP / 4;      // float4 sums of a pass
  static constexpr int P = ITEMS < THREADS ? THREADS / ITEMS : 1;    // threads an item
  static constexpr int IPT = ITEMS > THREADS ? ITEMS / THREADS : 1;  // items a thread
};

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Stage rows [0, ROWS) x columns [0, COLS) of a row-major f32 tensor at g
// (row stride ld) into s (row stride LS); rows >= rows_ok and columns >=
// cols_ok are zeros. vec: 16-byte cp.async (g, ld and cols_ok in whole
// 16-byte chunks; a zero-filled chunk reads nothing and points at `safe`);
// else plain loads.
template <int ROWS, int COLS, int LS>
__device__ inline void stage(float* s, const float* __restrict__ g, const float* safe,
                             int64_t ld, int rows_ok, int cols_ok, bool vec) {
  if (vec) {
    constexpr int PER = COLS / 4, ALL = ROWS * PER;
#pragma unroll
    for (int i0 = 0; i0 < ALL; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      if (ALL % THREADS == 0 || i < ALL) {
        const int r = i / PER, q = i % PER * 4;
        const bool ok = r < rows_ok && q < cols_ok;
        cp_async<16>(smem_u32(s + r * LS + q), ok ? g + r * ld + q : safe, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, q = i % COLS;
      s[r * LS + q] = r < rows_ok && q < cols_ok ? g[r * ld + q] : 0.f;
    }
  }
}

// The reverse of stage: rows [0, rows_ok) x columns [0, cols_ok) of s (row
// stride LS) to g (row stride ld), 16 bytes a store where vec.
template <int ROWS, int COLS, int LS>
__device__ inline void unstage(const float* s, float* __restrict__ g, int64_t ld, int rows_ok,
                               int cols_ok, bool vec) {
  if (vec) {
    constexpr int PER = COLS / 4, ALL = ROWS * PER;
#pragma unroll
    for (int i0 = 0; i0 < ALL; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      const int r = i / PER, q = i % PER * 4;
      if ((ALL % THREADS == 0 || i < ALL) && r < rows_ok && q < cols_ok)
        *reinterpret_cast<float4*>(g + r * ld + q) =
            *reinterpret_cast<const float4*>(s + r * LS + q);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, q = i % COLS;
      if (r < rows_ok && q < cols_ok) g[r * ld + q] = s[r * LS + q];
    }
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

__device__ inline void add4(float4& s, const float4 v) {
  s.x = __fadd_rn(s.x, v.x); s.y = __fadd_rn(s.y, v.y);
  s.z = __fadd_rn(s.z, v.z); s.w = __fadd_rn(s.w, v.w);
}

// One channel-sum pass over the history: for each of the thread's items
// (tt, g, q) -- states n = g SPT + 4 q .. + 3 at step tt, tt fastest -- the
// sum over the block's channels c of hist[tt Q + q][c L + g] (times
// w[tt CHP + c] where WEIGHTED, by fma). Part p of an item's P threads sums
// channels p, p + P, ... in order; the parts meet in an xor tree. Part 0
// writes the item's states n < N at steps tt < tn to out[(row + tt) N + n]
// (16 bytes a store where vec: N a multiple of 4).
template <int SPT, int L, bool WEIGHTED>
__device__ inline void channel_pass(const float4* hist, const float* w,
                                    float* __restrict__ out, int64_t row, int tn, int N,
                                    bool vec) {
  using G = Geo<SPT, L>;
  const int part = threadIdx.x % G::P;
#pragma unroll
  for (int i = 0; i < G::IPT; ++i) {
    const int item = threadIdx.x / G::P + i * (THREADS / G::P);
    const int tt = item % G::K, rest = item / G::K;
    const int q = rest % G::Q, g = rest / G::Q;
    const float4* h = hist + (tt * G::Q + q) * G::ROW + g;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < G::CH / G::P; ++j) {
      const int c = part + j * G::P;
      const float4 v = h[c * L];
      if constexpr (WEIGHTED) {
        const float wc = w[tt * G::CHP + c];
        s.x = fmaf(v.x, wc, s.x); s.y = fmaf(v.y, wc, s.y);
        s.z = fmaf(v.z, wc, s.z); s.w = fmaf(v.w, wc, s.w);
      } else {
        add4(s, v);
      }
    }
#pragma unroll
    for (int o = G::P / 2; o > 0; o >>= 1)
      add4(s, make_float4(__shfl_xor_sync(0xffffffffu, s.x, o),
                          __shfl_xor_sync(0xffffffffu, s.y, o),
                          __shfl_xor_sync(0xffffffffu, s.z, o),
                          __shfl_xor_sync(0xffffffffu, s.w, o)));
    const int n = g * SPT + 4 * q;
    if (part == 0 && tt < tn && n < N) {
      float* o = out + (row + tt) * N + n;
      if (vec) {
        *reinterpret_cast<float4*>(o) = s;
      } else {
        const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) o[j] = v[j];
      }
    }
  }
}

template <int SPT, int L>
__global__ void __launch_bounds__(THREADS, SPT == 4 ? 4 : 1)
    scan_bwd_walk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ bm, const float* __restrict__ cm,
                         const float* __restrict__ a, const float* __restrict__ dskip,
                         const float* __restrict__ dy, const float* __restrict__ dh_last,
                         const float* __restrict__ hs, float* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ part,
                         float* __restrict__ da_part, int B, int S, int di, int N, int vec_x,
                         int vec_bc, int vec_h) {
  using G = Geo<SPT, L>;
  constexpr int K = G::K, CH = G::CH, NP = G::NP, Q = G::Q, CHP = G::CHP, ROW = G::ROW;
  extern __shared__ __align__(16) float smem[];
  float4* const hist = reinterpret_cast<float4*>(smem);  // [K Q][ROW]
  float* const ring = smem + G::HIST;  // 2 x [x, dt, dy: K][CHP], [B, C: K][NP]
  const int b = blockIdx.y, d0 = blockIdx.x * CH;
  const int c = threadIdx.x / L, g = threadIdx.x % L;
  const int d = d0 + c;
  const bool live = d < di;
  const int cols_ok = max(0, min(CH, di - d0));
  const int nck = (S + K - 1) / K;
  float av[SPT], carry[SPT], acc[SPT];
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

  auto load_chunk = [&](int ch) {
    float* s = ring + (ch & 1) * G::SLOT;
    const int t0 = ch * K, tn = min(K, S - t0);
    const int64_t r = row0 + t0;
    stage<K, CH, CHP>(s, x + r * di + d0, x, di, tn, cols_ok, vec_x);
    stage<K, CH, CHP>(s + K * CHP, dt + r * di + d0, dt, di, tn, cols_ok, vec_x);
    stage<K, CH, CHP>(s + 2 * K * CHP, dy + r * di + d0, dy, di, tn, cols_ok, vec_x);
    stage<K, NP, NP>(s + 3 * K * CHP, bm + r * N, bm, N, tn, N, vec_bc);
    stage<K, NP, NP>(s + 3 * K * CHP + K * NP, cm + r * N, cm, N, tn, N, vec_bc);
  };
  // the state at the start of chunk ch (zero for chunk 0), straight to registers
  auto load_h0 = [&](int ch, float (&v)[SPT]) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) v[k] = 0.f;
    if (ch == 0 || !live) return;
    const float* p = hs + ((static_cast<int64_t>(b) * (nck - 1) + ch - 1) * di + d) * N + g * SPT;
    if (vec_h) {
#pragma unroll
      for (int k = 0; k < SPT; k += 4) {
        if (g * SPT + k < N) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
          v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        if (g * SPT + k < N) v[k] = p[k];
    }
  };

  float h0[SPT], h0n[SPT];
  load_chunk(nck - 1);
  cp_async_commit();
  load_h0(nck - 1, h0n);
  for (int ch = nck - 1; ch >= 0; --ch) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) h0[k] = h0n[k];
    cp_async_wait<0>();
    __syncthreads();  // chunk ch staged; the chunk before is written out, its history read
    if (ch > 0) {  // in flight while this chunk walks
      load_chunk(ch - 1);
      load_h0(ch - 1, h0n);
    }
    cp_async_commit();
    float* const sx = ring + (ch & 1) * G::SLOT;  // row tt: x_t, then dx_t
    float* const sdt = sx + K * CHP;               // row tt: dt_t, then ddt_t
    const float* sdy = sdt + K * CHP;
    const float* sb = sdy + K * CHP + g * SPT;
    const float* sc = sb + K * NP;
    const int t0 = ch * K, tn = min(K, S - t0);  // block-uniform
    float dec[K][SPT];  // a_t of the chunk, from the rebuild to the reverse step
    {
      float h[SPT];
#pragma unroll
      for (int k = 0; k < SPT; ++k) h[k] = h0[k];
      // steps past S (the last chunk's tail) are staged as zeros: dt = 0
      // makes a_t = 1 and h_t = h_{t-1} exactly, dy = 0 passes g on
      // unchanged and adds nothing to dA, so no step is branched around
#pragma unroll
      for (int tt = 0; tt < K; ++tt) {
        const float dtt = sdt[tt * CHP + c];
        const float dtx = __fmul_rn(dtt, sx[tt * CHP + c]);
        float bv[SPT];
        load_run<SPT>(sb + tt * NP, bv);
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
          dec[tt][k] = expf(__fmul_rn(dtt, av[k]));
          h[k] = __fadd_rn(__fmul_rn(dec[tt][k], h[k]), __fmul_rn(dtx, bv[k]));
        }
#pragma unroll
        for (int q = 0; q < Q; ++q)
          hist[(tt * Q + q) * ROW + threadIdx.x] =
              make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
      }
    }
    __syncthreads();  // the chunk's states
    channel_pass<SPT, L, true>(hist, sdy, dc_part, row0 + t0, tn, N, vec_bc);
    __syncthreads();  // the states are summed; the walk overwrites them
#pragma unroll
    for (int tt = K - 1; tt >= 0; --tt) {
      const float xt = sx[tt * CHP + c], dtt = sdt[tt * CHP + c], dyt = sdy[tt * CHP + c];
      const float dtx = __fmul_rn(dtt, xt);
      float bv[SPT], cv[SPT], hp[SPT];
      load_run<SPT>(sb + tt * NP, bv);
      load_run<SPT>(sc + tt * NP, cv);
      if (tt > 0) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 v = hist[((tt - 1) * Q + q) * ROW + threadIdx.x];
          hp[4 * q] = v.x; hp[4 * q + 1] = v.y; hp[4 * q + 2] = v.z; hp[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int k = 0; k < SPT; ++k) hp[k] = h0[k];
      }
      float s1 = 0.f, s2 = 0.f, term[SPT];
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        const float gk = __fadd_rn(__fmul_rn(dyt, cv[k]), carry[k]);
        const float ga = __fmul_rn(gk, dec[tt][k]);  // g_t a_t: q's factor and the carry
        const float qk = __fmul_rn(ga, hp[k]);
        s1 = fmaf(gk, bv[k], s1);
        s2 = fmaf(av[k], qk, s2);
        acc[k] = __fadd_rn(acc[k], __fmul_rn(qk, dtt));
        carry[k] = ga;
        term[k] = __fmul_rn(gk, dtx);  // dB's term; h_t was read as step t + 1's h_{t-1}
      }
#pragma unroll
      for (int q = 0; q < Q; ++q)
        hist[(tt * Q + q) * ROW + threadIdx.x] =
            make_float4(term[4 * q], term[4 * q + 1], term[4 * q + 2], term[4 * q + 3]);
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
        s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, o));
        s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
      }
      if (g == 0) {  // every lane has used x_t, dt_t: their slots take dx_t, ddt_t
        sx[tt * CHP + c] = __fadd_rn(__fmul_rn(dtt, s1), __fmul_rn(dd, dyt));
        sdt[tt * CHP + c] = __fadd_rn(s2, __fmul_rn(xt, s1));
      }
    }
    __syncthreads();  // the dB terms, dx and ddt
    channel_pass<SPT, L, false>(hist, nullptr, db_part, row0 + t0, tn, N, vec_bc);
    unstage<K, CH, CHP>(sx, dx + (row0 + t0) * di + d0, di, tn, cols_ok, vec_x);
    unstage<K, CH, CHP>(sdt, ddt + (row0 + t0) * di + d0, di, tn, cols_ok, vec_x);
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
__global__ void scan_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int64_t count, int parts) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int j = 1; j < parts; ++j) s = __fadd_rn(s, part[j * count + i]);
    out[i] = s;
  }
}

int launch_sum(const float* part, float* out, int64_t count, int parts, cudaStream_t stream) {
  if (count <= 0) return 0;
  const int64_t blocks = (count + 255) / 256;
  scan_bwd_sum_kernel<<<static_cast<int>(blocks < 65536 ? blocks : 65536), 256, 0, stream>>>(
      part, out, count, parts);
  return static_cast<int>(cudaGetLastError());
}

template <int SPT, int L>
int smem_bytes() {
  using G = Geo<SPT, L>;
  return static_cast<int>((G::HIST + 2 * G::SLOT) * sizeof(float));
}

// blocks of the walk kernel that fit an SM at once (registers, shared
// memory, threads), or a negative value on error
template <int SPT, int L>
int blocks_per_sm() {
  auto kernel = scan_bwd_walk_kernel<SPT, L>;
  const int smem = smem_bytes<SPT, L>();
  int n = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem))
    return -1;
  return n;
}

template <int SPT, int L>
int launch(const float* x, const float* dt, const float* bm, const float* cm, const float* a,
           const float* dskip, const float* dy, const float* dh_last, const float* hs,
           float* part, float* da_part, float* dx, float* ddt, float* dbc, float* da, int B,
           int S, int di, int N, cudaStream_t stream) {
  using G = Geo<SPT, L>;
  const dim3 grid((di + G::CH - 1) / G::CH, B);
  const int smem = smem_bytes<SPT, L>();
  auto kernel = scan_bwd_walk_kernel<SPT, L>;
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  const int vec_x = aligned16(x) && aligned16(dt) && aligned16(dy) && aligned16(dx) &&
                    aligned16(ddt) && di % 4 == 0;
  const int vec_bc = aligned16(bm) && aligned16(cm) && aligned16(part) && N % 4 == 0;
  const int vec_h = aligned16(hs) && N % 4 == 0;
  kernel<<<grid, THREADS, smem, stream>>>(x, dt, bm, cm, a, dskip, dy, dh_last, hs, dx, ddt,
                                          part, da_part, B, S, di, N, vec_x, vec_bc, vec_h);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = launch_sum(part, dbc, 2 * static_cast<int64_t>(B) * S * N, grid.x, stream);
  if (err) return err;
  return launch_sum(da_part, da, static_cast<int64_t>(di) * N, B, stream);
}

}  // namespace

// every (spt, lanes) that kernels/selective_scan.py:scan_bwd_layout takes
#define BWD_LAYOUTS(X) X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(4, 16) X(4, 32) X(8, 32) X(16, 32)

// spt and lanes from kernels/selective_scan.py:scan_bwd_layout, N <= spt *
// lanes. hs holds the forward's chunk-start
// states, B x (ceil(S / K) - 1) x di x N floats (K = 64 / spt; may be null
// when S <= K), part 2 x ceil(di / (128 / lanes)) x B x S x N, da_part B x
// di x N; dbc is [2, B, S, N] (dB then dC). dh_last may be null. B, S and
// di must be positive. Anything else returns cudaErrorInvalidValue without
// launching.
extern "C" int selective_scan_bwd_launch(const float* x, const float* dt, const float* bm,
                                         const float* cm, const float* a, const float* dskip,
                                         const float* dy, const float* dh_last,
                                         const float* hs, float* part, float* da_part,
                                         float* dx, float* ddt, float* dbc, float* da, int B,
                                         int S, int di, int N, int spt, int lanes,
                                         cudaStream_t stream) {
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || N > spt * lanes ||
      (hs == nullptr && S > STATE_STEPS / spt))
    return static_cast<int>(cudaErrorInvalidValue);
#define BWD_CASE(SPT, LANES)                                                            \
  if (spt == SPT && lanes == LANES)                                                     \
    return launch<SPT, LANES>(x, dt, bm, cm, a, dskip, dy, dh_last, hs, part, da_part,  \
                              dx, ddt, dbc, da, B, S, di, N, stream);
  BWD_LAYOUTS(BWD_CASE)
#undef BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the walk kernel an SM holds at once in a built layout (the
// occupancy calculator's answer), or a negative value.
extern "C" int selective_scan_bwd_blocks_per_sm(int spt, int lanes) {
#define OCC_CASE(SPT, LANES) \
  if (spt == SPT && lanes == LANES) return blocks_per_sm<SPT, LANES>();
  BWD_LAYOUTS(OCC_CASE)
#undef OCC_CASE
  return -1;
}
