// Streaming attention of the LM path, f32 q [B, Sq, H, hd], GQA k/v
// [B, Sk, KVH, hd] in f32, bf16 or int8 (with per-(position, head) f32
// k_scale / v_scale [B, Sk, KVH]), out f32 [B, Sq, H, hd]. Masks: causal
// and local window on absolute positions (q row i sits at q_offset[b] + i),
// kv_valid_len [B] fill levels, packed-prefill segment ids (q [B, Sq], kv
// [B, Sk]: a row sees only keys of its own id), and a tanh logit softcap.
//   s = (q.k) * k_scale[pos] / sqrt(hd), softcapped, masked to -inf;
//   quant_bits == 0: online softmax (running max, rescaled sum and P.V);
//   quant_bits  > 0: pass 1 takes the exact row max over every live K tile
//     and reads no V; pass 2 forms the log-sqrt2 codes
//     c = clip(rint(-2 log2(e) (s - m)), 0, 2^bits - 1) against that final
//     max, sums the exact denominator l = sum exp(s - m), and weights V by
//     2^-ceil(c/2) (1 + (c & 1)(sqrt2 - 1)) * v_scale[pos];
//   one division by max(l, 1e-30) per output at the flush. A row with no
//   visible key gives exactly 0.
//
// Replaces: src/repro/kernels/quant_attention.py, streaming_attention /
// _attn_kernel, in every mode the LM path runs (calibration: causal f32
// quant_bits=0; packed prefill: causal, segments, int8 K/V + scales,
// quant_bits=4; decode: per-slot q_offset and kv_valid_len over the int8
// cache). The non-causal cache-free vision case keeps quant_attention.cu.
//
// Bound on the H100: at the OLMoE-1B-7B shapes (H = KVH = 16, hd = 128) a
// decode step over an int8 cache of Sk = 512 slots reads 8 x 512 x 16 x
// 128 x 2 bytes of K/V plus scales, ~17 MB, ~5 us at 3.35 TB/s, for 2 x 2 x
// 8 x 16 x 512 x 128 = 34 MFLOP of f32 (~0.5 us at 67 TFLOP/s): bound by
// bytes. A packed prefill of 512 tokens is 2 x 2 x 16 x 512^2 x 128 / 2 =
// 1.1 GFLOP of causal f32 work on ~10 MB: bound by operations (~16 us).
//
// Design: one block of 8 warps owns (b, head, 32 query rows); each warp
// owns 4 of the rows and keeps their running max, denominator and P.V
// accumulator (hd <= 128: four floats a lane) in registers. K/V stream
// through shared memory in tiles of 32 keys, converted to f32 on the way
// in, so no head is ever held whole and any Sk works. For scores a lane
// takes one key of the tile (K rows padded by one float: distinct banks);
// for P.V the lanes split the head dim. A tile is skipped only when it is
// wholly masked for every row of the block (beyond the fill level, after
// the last row under the causal mask, or before the window of the first
// row), which is the Pallas kernel's dead-tile rule. The score is formed
// in the plain version's order with rounding intrinsics, so exact inputs
// give the plain version's scores and codes bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int LA_WARPS = 8;
constexpr int LA_ROWS = 4;                   // query rows per warp
constexpr int LA_BQ = LA_WARPS * LA_ROWS;    // query rows per block
constexpr int LA_BK = 32;                    // keys per tile: one per lane
constexpr int LA_MAX_HD = 128;
constexpr int LA_CHUNKS = LA_MAX_HD / 32;
constexpr float NEG2_LOG2E = -2.8853900817779268f;  // -2 log2(e)
constexpr float SQRT2M1 = 0.41421356237309515f;     // sqrt(2) - 1

enum KvType { KV_F32 = 0, KV_BF16 = 1, KV_I8 = 2 };

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KV>
__device__ inline float load_kv(const void* p, size_t i) {
  if constexpr (KV == KV_F32) return static_cast<const float*>(p)[i];
  if constexpr (KV == KV_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<float>(static_cast<const int8_t*>(p)[i]);
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* k_scale;  // nullable
  const float* v_scale;  // nullable with k_scale
  const int* q_offset;   // [B]
  const int* kv_valid;   // [B]
  const int* q_seg;      // nullable [B, Sq]
  const int* kv_seg;     // nullable with q_seg, [B, Sk]
  float* out;
  int Sq, Sk, H, KVH, hd;
  int causal, quant_bits, local_window;
  float softcap, sqrt_hd;
};

template <int KV, bool TWO_PASS>
__global__ void __launch_bounds__(LA_WARPS * 32) lm_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, hd_pad = hd + 1;
  float* ks = smem;                    // [LA_BK][hd + 1]
  float* vs = ks + LA_BK * hd_pad;     // [LA_BK][hd]
  float* qs = vs + LA_BK * hd;         // [LA_BQ][hd]
  float* pw = qs + LA_BQ * hd;         // [LA_WARPS][LA_BK]
  float* kss = pw + LA_WARPS * LA_BK;  // [LA_BK] k scales
  float* vss = kss + LA_BK;            // [LA_BK] v scales
  int* ksg = reinterpret_cast<int*>(vss + LA_BK);  // [LA_BK] kv segment ids

  const int b = blockIdx.z, h = blockIdx.y;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = blockIdx.x * LA_BQ;
  const int n_rows = min(LA_BQ, a.Sq - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool scaled = a.k_scale != nullptr, segs = a.q_seg != nullptr;

  for (int e = threadIdx.x; e < LA_BQ * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    qs[e] = r < n_rows ? a.q[(((size_t)b * a.Sq + q0 + r) * a.H + h) * hd + d] : 0.f;
  }
  const int q_off = a.q_offset[b];
  const int valid = min(a.kv_valid[b], a.Sk);
  const int pos_first = q_off + q0, pos_last = q_off + q0 + n_rows - 1;
  const float code_max = (float)((1 << max(a.quant_bits, 1)) - 1);

  float m[LA_ROWS], l[LA_ROWS], acc[LA_ROWS][LA_CHUNKS];
  int qseg[LA_ROWS];
#pragma unroll
  for (int r = 0; r < LA_ROWS; ++r) {
    m[r] = -1e30f;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < LA_CHUNKS; ++c) acc[r][c] = 0.f;
    const int i = q0 + r * LA_WARPS + warp;
    qseg[r] = (segs && i < a.Sq) ? a.q_seg[(size_t)b * a.Sq + i] : 0;
  }
  __syncthreads();

  const int n_tiles = (valid + LA_BK - 1) / LA_BK;
  for (int pass = 0; pass < (TWO_PASS ? 2 : 1); ++pass) {
    const bool need_v = !TWO_PASS || pass == 1;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * LA_BK;
      // dead-tile skip: block-uniform, only when every row masks every key
      if (a.causal && k0 > pos_last) break;
      if (a.local_window > 0 && k0 + LA_BK - 1 < pos_first - a.local_window + 1) continue;
      for (int e = threadIdx.x; e < LA_BK * hd; e += blockDim.x) {
        const int j = e / hd, d = e % hd, key = k0 + j;
        const size_t g = (((size_t)b * a.Sk + key) * a.KVH + kvh) * hd + d;
        const bool in = key < a.Sk;
        ks[j * hd_pad + d] = in ? load_kv<KV>(a.k, g) : 0.f;
        if (need_v) vs[j * hd + d] = in ? load_kv<KV>(a.v, g) : 0.f;
      }
      if (threadIdx.x < LA_BK) {
        const int key = k0 + threadIdx.x;
        const bool in = key < a.Sk;
        const size_t gs = ((size_t)b * a.Sk + key) * a.KVH + kvh;
        if (scaled) {
          kss[threadIdx.x] = in ? a.k_scale[gs] : 0.f;
          vss[threadIdx.x] = in ? a.v_scale[gs] : 0.f;
        }
        if (segs) ksg[threadIdx.x] = in ? a.kv_seg[(size_t)b * a.Sk + key] : -2;
      }
      __syncthreads();
      const int key = k0 + lane;
      const float* kr = ks + lane * hd_pad;
      float* pr = pw + warp * LA_BK;
#pragma unroll
      for (int r = 0; r < LA_ROWS; ++r) {
        const int i = q0 + r * LA_WARPS + warp;
        if (i >= a.Sq) break;  // warp-uniform
        const float* qr = qs + (r * LA_WARPS + warp) * hd;
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
        if (scaled) s = __fmul_rn(s, kss[lane]);
        s = __fdiv_rn(s, a.sqrt_hd);
        if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
        const int qpos = q_off + i;
        bool ok = key < valid;
        if (a.causal) ok = ok && key <= qpos;
        if (a.local_window > 0) ok = ok && qpos - key < a.local_window;
        if (segs) ok = ok && qseg[r] == ksg[lane];
        s = ok ? s : -INFINITY;
        float p, corr = 1.f;
        if (TWO_PASS) {
          if (pass == 0) {
            m[r] = fmaxf(m[r], fmaxf(warp_max(s), -1e30f));
            continue;
          }
          const float dt = s - m[r];
          l[r] += warp_sum(expf(dt));
          const int c = (int)fminf(fmaxf(rintf(NEG2_LOG2E * dt), 0.f), code_max);
          p = ok ? ldexpf((c & 1) ? 1.0f + SQRT2M1 : 1.0f, -((c + 1) >> 1)) : 0.f;
        } else {
          const float m_new = fmaxf(m[r], fmaxf(warp_max(s), -1e30f));
          corr = expf(m[r] - m_new);
          p = expf(s - m_new);
          l[r] = l[r] * corr + warp_sum(p);
          m[r] = m_new;
        }
        if (scaled) p = __fmul_rn(p, vss[lane]);
        pr[lane] = p;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < LA_CHUNKS; ++c) {
          const int d = lane + 32 * c;
          if (d >= hd) break;
          float sum = 0.f;
          for (int j = 0; j < LA_BK; ++j) sum = fmaf(pr[j], vs[j * hd + d], sum);
          acc[r][c] = fmaf(acc[r][c], corr, sum);
        }
        __syncwarp();
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < LA_ROWS; ++r) {
    const int i = q0 + r * LA_WARPS + warp;
    if (i >= a.Sq) break;
    const float den = fmaxf(l[r], 1e-30f);
    float* o = a.out + (((size_t)b * a.Sq + i) * a.H + h) * hd;
#pragma unroll
    for (int c = 0; c < LA_CHUNKS; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[d] = acc[r][c] / den;
    }
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)LA_BK * (2 * hd + 1) + (size_t)LA_BQ * hd +
                          LA_WARPS * LA_BK + 3 * LA_BK);
}

template <int KV, bool TWO_PASS>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.hd);
  cudaError_t err = cudaFuncSetAttribute(
      lm_attention_kernel<KV, TWO_PASS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && a.Sq > 0) {
    dim3 grid((a.Sq + LA_BQ - 1) / LA_BQ, a.H, B);
    lm_attention_kernel<KV, TWO_PASS><<<grid, LA_WARPS * 32, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KV>
int launch_kv(const Args& a, int B, cudaStream_t stream) {
  return a.quant_bits > 0 ? launch<KV, true>(a, B, stream)
                          : launch<KV, false>(a, B, stream);
}

}  // namespace

// kv_type: 0 f32, 1 bf16, 2 int8. hd <= 128; any other value, or a kv_type
// outside those, is refused with cudaErrorInvalidValue.
extern "C" int lm_attention_launch(
    const float* q, const void* k, const void* v, int kv_type,
    const float* k_scale, const float* v_scale, const int* q_offset,
    const int* kv_valid, const int* q_seg, const int* kv_seg, float* out,
    int B, int Sq, int Sk, int H, int KVH, int hd, int causal, int quant_bits,
    int local_window, float logit_softcap, float sqrt_hd, cudaStream_t stream) {
  if (hd < 1 || hd > LA_MAX_HD || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, q_offset, kv_valid, q_seg, kv_seg,
               out, Sq, Sk, H, KVH, hd, causal, quant_bits, local_window,
               logit_softcap, sqrt_hd};
  switch (kv_type) {
    case KV_F32: return launch_kv<KV_F32>(a, B, stream);
    case KV_BF16: return launch_kv<KV_BF16>(a, B, stream);
    case KV_I8: return launch_kv<KV_I8>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
