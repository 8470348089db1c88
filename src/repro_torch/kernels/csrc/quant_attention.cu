// Non-causal attention with the paper's 3-pass log-sqrt2 quantized softmax
// (CoQMoE sections 3.2 and 4.3), f32, q [B, Sq, H, hd], GQA k/v
// [B, Sk, KVH, hd], out [B, Sq, H, hd]:
//   pass 1: s = (q.k) / sqrt(hd), exact row max m (floored at -1e30);
//   pass 2: codes c = clip(rint(-2 log2(e) (s - m)), 0, 2^bits - 1),
//           weights 2^-ceil(c/2) * (1 + (c & 1)(sqrt2 - 1)), and the exact
//           denominator l = sum exp(s - m);
//   pass 3: out = (sum_j weight_j v_j) / max(l, 1e-30).
//
// Replaces: src/repro/kernels/quant_attention.py, streaming_attention /
// _attn_kernel, for quant_bits > 0 without causal masking, scales, segments,
// windows or softcap (the wrapper refuses those).
//
// Bound on the H100: at M3ViT-S (B = 8, S = 197, H = 6, hd = 64) the inputs
// and output are 4 x 2.4 MB, ~2.9 us at 3.35 TB/s, and the two products are
// 2 x 2 B H S^2 hd = 0.48 GFLOP of f32 (two 119 M-FMA products), ~7.1 us at
// 67 TFLOP/s outside the tensor cores: bound by f32 operations. The first
// port's kernel took 0.128 ms: each FMA of its score and P.V loops read two
// 4-byte words from shared memory, each of a head's seven 32-row blocks
// staged the whole of K and V (100 KB) again with scalar loads, and a warp
// worked through its rows one at a time. This kernel takes ~0.034 ms
// (PERF.md): the 336 blocks of M3ViT-S run in one wave, two or three an
// SM, so one block's chain of eight staged chunks, each loaded while the
// previous one computes, is the time; its arithmetic, not shared-memory
// bandwidth, is most of it (larger register tiles that halve the
// shared-memory loads a FMA were not faster, and a third ring slot leaves
// two blocks an SM and two waves), and replacing the IEEE division of each
// score by its exact product with 1 / sqrt(hd) (hd 64) took the call from
// 0.040 to 0.034 ms. Staging K and V once a head instead, with a thread-block
// cluster of the head's row blocks that each bulk-copy a share of every
// chunk, multicast into the shared memory of all of them, with one cluster
// barrier a chunk, was slower at every cluster size tried (1 to 8, slower
// the larger), and bulk copies alone (a cluster of one) slower than
// cp.async: the loads, overlapped with the arithmetic, are not the bound.
//
// Design: a block of 128 threads (8 row lanes x 16 key lanes) takes 32
// query rows of one (b, head), its q tile staged once. K and then V stream
// through a double-buffered ring of 64-key chunks with 16-byte cp.async
// (plain loads where hd % 4 != 0 or an operand is not 16-byte aligned),
// the next chunk in flight while the current one computes, so shared
// memory holds 70 KB at M3ViT-S and three blocks share an SM. Register
// micro-tiles make one shared-memory word feed four FMAs: a thread scores
// rows ty + 8 i against keys tx + 16 j (4 x 4, 16-byte loads along the
// head dim, rows of hd + 4 floats so that eight lanes of a phase hit 32
// distinct banks), and forms P.V for rows ty + 8 i and HDP / 16 head dims.
// The tile's scores stay on chip: each chunk's scores go to a row-major
// score tile in shared memory with the running row max in registers; then
// every thread turns its own scores into codes and adds exp(s - m) (no
// barrier: it reads what it wrote), four xor shuffles finish m and l for
// its rows, and the weights feed P.V from the same tile. hd is zero-padded
// to HDP in {16, 32, 64, 128} (zero dims add exact zeros); the last key
// chunk scores only its live 16-key groups; keys >= Sk get weight 0 and
// zero V rows, rows >= Sq are never stored. Scores and P.V are each one
// fmaf chain in order, over the head dim and over the keys, as in the
// first port's kernel, so both give the same scores and codes; codes use
// rintf (round half to even, as jnp.round) and the weight's power of two
// is built from its exponent bits (exact; ldexpf past a normal float's
// range).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "int8_mma.cuh"  // cp.async helpers

namespace {

using repro::mma8::cp_async;
using repro::mma8::cp_async_commit;
using repro::mma8::cp_async_wait;
using repro::mma8::smem_u32;

constexpr float NEG2_LOG2E = -2.8853900817779268f;  // -2 log2(e)
constexpr float SQRT2M1 = 0.41421356237309515f;     // sqrt(2) - 1

// the code's weight 2^-ceil(c/2) (1 + (c & 1)(sqrt2 - 1)), 2^-e built from
// its exponent bits where it is a normal float (e <= 126: every 4-bit
// code), ldexpf past that; exact either way
__device__ inline float log_sqrt2_weight(float t, float code_max) {
  const int c = (int)fminf(fmaxf(rintf(NEG2_LOG2E * t), 0.f), code_max);
  const int e = (c + 1) >> 1;
  const float m = (c & 1) ? 1.0f + SQRT2M1 : 1.0f;
  return e <= 126 ? m * __int_as_float((127 - e) << 23) : ldexpf(m, -e);
}

constexpr int TILE_THREADS = 128;
constexpr int TILE_TX = 16;    // key (pass 1) and head-dim (pass 3) lanes
constexpr int TILE_TY = 8;     // row lanes
constexpr int TILE_ROWS = 32;  // query rows of a block: ty + 8 i, i < 4
constexpr int TILE_KEYS = 64;  // keys of a staged chunk: tx + 16 j, j < 4
static_assert(TILE_TX * TILE_TY == TILE_THREADS && TILE_ROWS == 4 * TILE_TY &&
              TILE_KEYS == 4 * TILE_TX, "4 x 4 micro-tiles cover a block's rows and keys");

template <int HDP>
__device__ inline void stage_rows(float* s, int ld, const float* __restrict__ base,
                                  int64_t stride, int row0, int rows, int rows_ok, int hd,
                                  bool vec) {
  for (int i = threadIdx.x; i < rows * (HDP / 4); i += TILE_THREADS) {
    const int r = i / (HDP / 4), d = (i % (HDP / 4)) * 4;
    const float* src = base + (row0 + r) * stride + d;
    if (vec) {
      const bool ok = r < rows_ok && d < hd;
      cp_async<16>(smem_u32(s + r * ld + d), ok ? src : base, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[r * ld + d + e] = r < rows_ok && d + e < hd ? src[e] : 0.f;
    }
  }
}

template <int HDP, int JN>
__device__ inline void score_chunk(const float* qs, const float* ks, float* ps, int ps_ld,
                                   int key0, int Sk, float scale, float (&m)[4]) {
  const bool pow2 = (__float_as_uint(scale) & 0x7fffffu) == 0;
  const float inv_scale = 1.f / scale;
  constexpr int LD = HDP + 4;
  const int tx = threadIdx.x % TILE_TX, ty = threadIdx.x / TILE_TX;
  float acc[4][JN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 qv[4], kv[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 8 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < JN; ++j) kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
        acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
        acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
        acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int key = key0 + tx + 16 * j;
      // a power-of-two sqrt(hd) (hd 16, 64, 256): the product by its exact
      // reciprocal is the quotient
      const float s = pow2 ? acc[i][j] * inv_scale : __fdiv_rn(acc[i][j], scale);
      ps[(ty + 8 * i) * ps_ld + key] = s;
      if (key < Sk) m[i] = fmaxf(m[i], s);
    }
}

template <int HDP>
__device__ inline int pv_dim(int tx, int e) {
  constexpr int DPT = HDP / TILE_TX;
  return DPT >= 4 ? 64 * (e / 4) + 4 * tx + e % 4 : DPT * tx + e;
}

template <int HDP>
__device__ inline void load_v(const float* row, int tx, float (&v)[HDP / TILE_TX]) {
  constexpr int DPT = HDP / TILE_TX;
  if constexpr (DPT >= 4) {
#pragma unroll
    for (int q = 0; q < DPT / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(row + 64 * q + 4 * tx);
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z; v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < DPT; ++e) v[e] = row[DPT * tx + e];
  }
}

template <int HDP>
__global__ void __launch_bounds__(TILE_THREADS)
    quant_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Sq,
                           int Sk, int H, int KVH, int hd, int ps_ld, int quant_bits,
                           float scale, int vec) {
  constexpr int LD = HDP + 4;
  constexpr int DPT = HDP / TILE_TX;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [TILE_ROWS][LD]
  float* ps = qs + TILE_ROWS * LD;       // [TILE_ROWS][ps_ld]: scores, then weights
  float* ring = ps + TILE_ROWS * ps_ld;  // 2 x [TILE_KEYS][LD]: K, then V chunks
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * TILE_ROWS;
  const int kvh = h / (H / KVH);
  const int tx = threadIdx.x % TILE_TX, ty = threadIdx.x / TILE_TX;
  const int64_t qstride = static_cast<int64_t>(H) * hd, kvstride = static_cast<int64_t>(KVH) * hd;
  const float* qbase = q + (static_cast<int64_t>(b) * Sq * H + h) * hd;
  const float* kbase = k + (static_cast<int64_t>(b) * Sk * KVH + kvh) * hd;
  const float* vbase = v + (static_cast<int64_t>(b) * Sk * KVH + kvh) * hd;
  const int chunks = (Sk + TILE_KEYS - 1) / TILE_KEYS;
  const float code_max = (float)((1 << quant_bits) - 1);
  auto load_chunk = [&](int u) {  // u < chunks: K chunk u; else V chunk u - chunks
    const int key0 = (u % chunks) * TILE_KEYS;
    stage_rows<HDP>(ring + (u & 1) * TILE_KEYS * LD, LD, u < chunks ? kbase : vbase,
                    kvstride, key0, TILE_KEYS, Sk - key0, hd, vec);
  };
  stage_rows<HDP>(qs, LD, qbase, qstride, row0, TILE_ROWS, Sq - row0, hd, vec);
  load_chunk(0);
  cp_async_commit();
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  const int sk4 = (Sk + 3) / 4 * 4;
  for (int u = 0; u < 2 * chunks; ++u) {
    if (u + 1 < 2 * chunks) load_chunk(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cs = ring + (u & 1) * TILE_KEYS * LD;
    if (u < chunks) {
      const int key0 = u * TILE_KEYS;
      switch ((min(TILE_KEYS, Sk - key0) + 15) / 16) {
        case 1: score_chunk<HDP, 1>(qs, cs, ps, ps_ld, key0, Sk, scale, m); break;
        case 2: score_chunk<HDP, 2>(qs, cs, ps, ps_ld, key0, Sk, scale, m); break;
        case 3: score_chunk<HDP, 3>(qs, cs, ps, ps_ld, key0, Sk, scale, m); break;
        default: score_chunk<HDP, 4>(qs, cs, ps, ps_ld, key0, Sk, scale, m); break;
      }
    } else {
      if (u == chunks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
          m[i] = fmaxf(m[i], -1e30f);
        }
        for (int key = tx; key < sk4; key += TILE_TX) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* p = ps + (ty + 8 * i) * ps_ld + key;
            if (key < Sk) {
              const float t = *p - m[i];
              l[i] += expf(t);
              *p = log_sqrt2_weight(t, code_max);
            } else {
              *p = 0.f;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
          l[i] = fmaxf(l[i], 1e-30f);
        }
        __syncthreads();
      }
      const int key0 = (u - chunks) * TILE_KEYS;
      const int kn = min(TILE_KEYS, sk4 - key0);
#pragma unroll 2
      for (int jj = 0; jj < kn; jj += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 8 * i) * ps_ld + key0 + jj);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float vv[DPT];
          load_v<HDP>(cs + (jj + w) * LD, tx, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = w == 0 ? pv[i].x : w == 1 ? pv[i].y : w == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 8 * i;
    if (row >= Sq) continue;
    float* o = out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * hd;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = pv_dim<HDP>(tx, e);
      if (d < hd) o[d] = __fdiv_rn(acc[i][e], l[i]);
    }
  }
}

size_t tile_smem_bytes(int hdp, int ps_ld) {
  return sizeof(float) * ((size_t)TILE_ROWS * (hdp + 4) + (size_t)TILE_ROWS * ps_ld +
                          2 * (size_t)TILE_KEYS * (hdp + 4));
}

template <int HDP>
int launch_tile(const float* q, const float* k, const float* v, float* out, int B, int Sq,
                int Sk, int H, int KVH, int hd, int ps_ld, int quant_bits, float scale,
                cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(HDP, ps_ld);
  const cudaError_t err = cudaFuncSetAttribute(
      quant_attention_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = hd % 4 == 0 && al(q) && al(k) && al(v);
  const dim3 grid((Sq + TILE_ROWS - 1) / TILE_ROWS, H, B);
  quant_attention_kernel<HDP><<<grid, TILE_THREADS, smem, stream>>>(
      q, k, v, out, Sq, Sk, H, KVH, hd, ps_ld, quant_bits, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hdp (16, 32, 64 or 128, >= hd) and ps_ld (the score tile's row in
// floats: a multiple of 4, >= Sk rounded up to 16) come from the wrapper's
// vision_layout; scale is sqrt(hd) (scores are divided by it, as the plain
// version does). Anything else returns cudaErrorInvalidValue without
// launching.
extern "C" int quant_attention_launch(const float* q, const float* k, const float* v,
                                      float* out, int B, int Sq, int Sk, int H, int KVH,
                                      int hd, int hdp, int ps_ld, int quant_bits,
                                      float scale, cudaStream_t stream) {
  if (hd <= 0 || hd > hdp || ps_ld % 4 || ps_ld < (Sk + 15) / 16 * 16 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  switch (hdp) {
    case 16: return launch_tile<16>(q, k, v, out, B, Sq, Sk, H, KVH, hd, ps_ld, quant_bits, scale, stream);
    case 32: return launch_tile<32>(q, k, v, out, B, Sq, Sk, H, KVH, hd, ps_ld, quant_bits, scale, stream);
    case 64: return launch_tile<64>(q, k, v, out, B, Sq, Sk, H, KVH, hd, ps_ld, quant_bits, scale, stream);
    case 128: return launch_tile<128>(q, k, v, out, B, Sq, Sk, H, KVH, hd, ps_ld, quant_bits, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
