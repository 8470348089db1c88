// Non-causal attention with the paper's 3-pass log-sqrt2 quantized softmax
// (CoQMoE sections 3.2 and 4.3), f32, q [B, Sq, H, hd], GQA k/v
// [B, Sk, KVH, hd], out [B, Sq, H, hd]:
//   pass 1: s = q.k * sm_scale, exact row max m (floored at -1e30);
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
// 2 x 2 B H S^2 hd = 0.24 GFLOP of f32, ~3.6 us at 67 TFLOP/s outside the
// tensor cores: bound by f32 operations.
//
// Design: at Sk = 197, hd = 64 one (b, kv head)'s K and V take 2 x 50 KB and
// fit in shared memory, so a block loads them once and every pass reads them
// from there; the 3-pass schedule costs no extra device-memory traffic. Each
// warp owns one query row at a time: lanes split the keys for the scores (K
// rows padded by one float so lanes hit distinct banks), keep the row's
// scores and then its weights in a per-warp shared buffer, and split the
// head dim for P.V. Codes use rintf (round half to even, as jnp.round), the
// shift is exact through ldexpf, and keys >= Sk and rows >= Sq are never
// touched, which masks the ragged tile edges.
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int ATT_WARPS = 8;
constexpr int ATT_ROWS_PER_WARP = 4;
constexpr int ATT_BQ = ATT_WARPS * ATT_ROWS_PER_WARP;  // query rows per block
constexpr float NEG2_LOG2E = -2.8853900817779268f;    // -2 log2(e)
constexpr float SQRT2M1 = 0.41421356237309515f;       // sqrt(2) - 1

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(ATT_WARPS * 32)
    quant_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int Sq, int Sk, int H, int KVH, int hd,
                           int quant_bits, float sm_scale) {
  extern __shared__ float smem[];
  const int hd_pad = hd + 1;
  float* ks = smem;                 // [Sk][hd + 1]
  float* vs = ks + Sk * hd_pad;     // [Sk][hd]
  float* qs = vs + Sk * hd;         // [ATT_WARPS][hd]
  float* ps = qs + ATT_WARPS * hd;  // [ATT_WARPS][Sk]: scores, then weights
  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (H / KVH);
  for (int e = threadIdx.x; e < Sk * hd; e += blockDim.x) {
    const int j = e / hd, d = e % hd;
    const size_t g = (((size_t)b * Sk + j) * KVH + kvh) * hd + d;
    ks[j * hd_pad + d] = k[g];
    vs[j * hd + d] = v[g];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qw = qs + warp * hd;
  float* pw = ps + warp * Sk;
  const float code_max = (float)((1 << quant_bits) - 1);
  for (int r = 0; r < ATT_ROWS_PER_WARP; ++r) {
    const int i = blockIdx.x * ATT_BQ + warp * ATT_ROWS_PER_WARP + r;
    if (i >= Sq) break;  // warp-uniform
    const size_t row = (((size_t)b * Sq + i) * H + h) * hd;
    for (int d = lane; d < hd; d += 32) qw[d] = q[row + d];
    __syncwarp();
    // pass 1: scores and the exact row max
    float m = -INFINITY;
    for (int j = lane; j < Sk; j += 32) {
      const float* kr = ks + j * hd_pad;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qw[d], kr[d], s);
      s *= sm_scale;
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = fmaxf(warp_max(m), -1e30f);
    // pass 2: codes against the final max, exact denominator
    float l = 0.f;
    for (int j = lane; j < Sk; j += 32) {
      const float t = pw[j] - m;
      l += expf(t);
      const int c = (int)fminf(fmaxf(rintf(NEG2_LOG2E * t), 0.f), code_max);
      pw[j] = ldexpf((c & 1) ? 1.0f + SQRT2M1 : 1.0f, -((c + 1) >> 1));
    }
    l = fmaxf(warp_sum(l), 1e-30f);
    __syncwarp();
    // pass 3: P.V and one division by the denominator per output
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Sk; ++j) acc = fmaf(pw[j], vs[j * hd + d], acc);
      out[row + d] = acc / l;
    }
    __syncwarp();
  }
}

size_t smem_bytes(int Sk, int hd) {
  return sizeof(float) * ((size_t)Sk * (2 * hd + 1) + (size_t)ATT_WARPS * (hd + Sk));
}

}  // namespace

extern "C" size_t quant_attention_smem_bytes(int Sk, int hd) {
  return smem_bytes(Sk, hd);
}

extern "C" int quant_attention_launch(const float* q, const float* k,
                                      const float* v, float* out, int B,
                                      int Sq, int Sk, int H, int KVH, int hd,
                                      int quant_bits, float sm_scale,
                                      cudaStream_t stream) {
  const size_t smem = smem_bytes(Sk, hd);
  cudaError_t err = cudaFuncSetAttribute(
      quant_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && Sq > 0) {
    dim3 grid((Sq + ATT_BQ - 1) / ATT_BQ, H, B);
    quant_attention_kernel<<<grid, ATT_WARPS * 32, smem, stream>>>(
        q, k, v, out, Sq, Sk, H, KVH, hd, quant_bits, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
