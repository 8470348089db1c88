// Streaming attention of the LM path, f32 q [B, Sq, H, hd], GQA k/v
// [B, Sk, KVH, hd] in f32, bf16 or int8 (with per-(position, head) f32
// k_scale / v_scale [B, Sk, KVH]), out f32 [B, Sq, H, hd], any hd <= 256.
// Masks: causal and local window on absolute positions (q row i sits at
// q_offset[b] + i), kv_valid_len [B] fill levels (each a [B] tensor or one
// value for every row), packed-prefill segment ids (q [B, Sq], kv [B, Sk]:
// a row sees only keys of its own id), and a tanh logit softcap.
//   s = (q.k) * k_scale[pos] / sqrt(hd), softcapped, masked to -inf;
//   quant_bits == 0: softmax, exp(s - m) against the row max m;
//   quant_bits  > 0: the exact row max m over every visible key first, then
//     the log-sqrt2 codes c = clip(rint(-2 log2(e) (s - m)), 0, 2^bits - 1)
//     against that final max, the exact denominator l = sum exp(s - m), and
//     V weighted by 2^-ceil(c/2) (1 + (c & 1)(sqrt2 - 1)) * v_scale[pos];
//   one division by max(l, 1e-30) per output at the flush. A row with no
//   visible key gives exactly 0. The score is formed in the plain version's
//   order with rounding intrinsics (__fmul_rn, __fdiv_rn).
//
// Replaces: src/repro/kernels/quant_attention.py, streaming_attention /
// _attn_kernel, in every mode the LM path runs (calibration: causal f32
// quant_bits=0; packed prefill: causal, segments, int8 K/V + scales,
// quant_bits=4; decode: per-slot q_offset and kv_valid_len over the int8
// cache). The non-causal cache-free vision case keeps quant_attention.cu.
//
// One arithmetic in both schedules. q.k is formed on the tensor cores in
// split precision, chunk by chunk. int8 and bf16 K are exact in bf16, so q
// is taken as three bf16 pieces, hi = rn(q), mid = rn(q - hi), lo = rn(q -
// hi - mid), whose sum is q exactly (while the pieces are normal numbers,
// |q| above ~2^-100), and a 16-dim chunk is the m16n8k16
// bf16 MMAs lo.k, mid.k, hi.k: all 48 products exact. f32 K (calibration)
// takes q as three tf32 pieces and k as two, and an 8-dim chunk is the
// m16n8k8 tf32 MMAs mid.k_hi + hi.k_lo + hi.k_hi (2^-22 of the product).
// Each chunk's MMAs start from zero and the chunk is added to the f32
// score with __fadd_rn, chunk after chunk in dim order, so an MMA never
// accumulates more than one chunk. A (row, key) score
// depends only on that row's q and that key's k, never on the schedule or
// on the other rows and keys of the MMA: the decode and tile schedules give
// the same scores, hence the same codes, bit for bit. Exact-score inputs
// (q on a 1/4 grid, int8 or grid K) give the plain version's scores and
// codes. P.V is one code in both schedules too (pv_step: a warp's 8 keys
// of a 64-key tile, P in three tf32 pieces, exact against int8 and bf16 V,
// each n8 tile's chunk added with __fadd_rn; the same per-lane denominators
// and the same merge over the 8 warps), so without a local window (whose
// tiles start at the first row of a block) the two schedules give a row the
// same output bit for bit: a served decode step computes what a prefill of
// the same tokens computes for that row.
//
// Each call is one kernel launch of one of two schedules, chosen by the
// wrapper (kernels/quant_attention.py:choose_schedule). With segment ids the
// tile schedule walks the segment-keyed plan (below), so a packed prefill
// gives each prompt's rows the bits of a prefill of that prompt alone.
//
// Both schedules come in two head-dim classes, hd <= 128 and hd <= 256,
// each its own instantiation (the output accumulators are 4 x hd / 8 f32
// registers a lane), so the narrower heads keep their code and times.
//
// Schedule decode (hd = 128 or 256, 16-byte aligned operands, at most 4
// query rows per KV head: Sq x H/KVH):
//   Bound on the H100: the K/V bytes. An OLMoE-1B-7B decode tick (8 slots,
//   16 heads of 128, int8 cache) reads each slot's live keys once: 6.9 MB at
//   the fill levels chip_smoke.py times, ~2 us at 3.35 TB/s, for 14 MFLOP.
//   Design: one block of 8 warps owns (b, kvh) with every query row of the
//   KV head (the H/KVH heads of GQA), so all warps share the keys and the
//   final row max is known inside the block; keys are not split over
//   blocks (8 x 16 = 128 blocks at OLMoE decode), so nothing relies on
//   blocks running together. K, then V, stream in their stored dtype
//   through one ring of 64-key tiles in shared memory by 16-byte cp.async
//   (int8: 8 stages, 76 KB in flight a block at hd 128; fewer stages at hd
//   256, dec_stages; rows padded by 16 bytes so that the MMA's k reads hit
//   32 banks), with the scales and segment ids
//   beside each tile; the V tiles are in flight while the last K tiles are
//   scored. Pass 1: warp w scores keys 8 w .. 8 w + 7 of each K tile for
//   every row at once (the rows are the first rows of the MMA's 16; q's
//   pieces sit in shared memory), writes every score to shared memory (rows
//   x live keys floats) and keeps a running max; the warps' maxima meet
//   once in shared memory. Pass 2 reads the scores back, not K, and runs
//   P.V over each V tile as the tile schedule does (pv_step), into 16 x hd
//   output accumulators a warp of which the first rows live; the 8 warps
//   meet at the end in shared memory (merge_row). K and V are each read
//   from device memory once.
//
// Schedule tile (everything else: prefill, packed prefill, calibration,
// head dims other than 128 and 256, unaligned operands):
//   Bound on the H100: operations. A packed prefill of 512 tokens in four
//   prompts is 2 x 2 x 16 heads x 128 x the visible pairs (~37,500 a head):
//   0.31 GFLOP, ~4.6 us at the f32 rate of 67 TFLOP/s, on ~2.5 MB.
//   Design: one block of 8 warps owns (b, head, 16 query rows); each warp
//   takes 8 keys of every 64-key tile. It forms S = q K^T for the 16 rows x
//   its 8 keys (the score function above: 8 chunks of 16 dims at hd =
//   128, 16 at 256, the q pieces staged once in shared memory, K fragments read from
//   the stored tile), scales, softcaps and masks S in its accumulators, reduces each
//   row's max over the 4 lanes that hold it (2 shuffles a tile), writes P
//   into its own rows of shared memory (a __syncwarp, no block barrier) and
//   multiplies P V into 16 x hd output accumulators; the denominators stay
//   per-lane partials. K/V tiles, in their stored dtype (rows padded so that
//   the fragment reads hit 32 banks), double-buffer by 16-byte cp.async:
//   tile t + 1 lands while tile t is multiplied, one __syncthreads a tile
//   (f32 K/V above hd 128: one stage, loaded, then multiplied; tile_layout).
//   A head dim that is not a multiple of 16 is zero-padded to one in shared
//   memory (zero dims add exact zeros) and the output store is masked; rows
//   whose bytes are not a multiple of 16, or operands off the 16-byte grid,
//   are staged by plain loads instead of cp.async. At the end the 8 warps
//   meet in shared memory (max, rescaled sums), each merging and writing
//   every 8th n8 tile of the output. quant_bits > 0 runs a pass over the K
//   tiles for the exact max first (K read twice, from L2 the second time);
//   the warps' maxima meet before the second pass.
//   Dead tiles: only tiles of keys in [window start of the first row, last
//   visible key of the last row] are walked, and with segment ids a tile is
//   skipped when none of its kv ids equals the block's q id: no row of the
//   block can see a key of it, so it would add exact zeros.
//
// The segment-keyed plan (tile schedule with segment ids, the packed
// prefill): a prompt's rows get the bits of a prefill of that prompt alone.
//   Bound on the H100: as the tile schedule; the plan adds one read of the
//   q ids (2 KB at 512 rows) and of the block's kv ids, from L2.
//   Design: the rows are cut at every change of q id into runs (each
//   prompt, the pad tail) and each run into blocks of 16 rows from its
//   first row (plan_block), so no block straddles two segments; a block's
//   64-key tiles start at its segment's first key. Each key of a prompt then
//   falls to the tile, warp, lane and MMA column it takes when the prompt
//   is prefilled alone at offset 0, and each row to the same block row, so
//   the sums run in the same order. The plan is derived on the device from
//   the ids: nothing is read back. The grid is ceil(Sq / 16) + a count of
//   runs the caller gives (the engine: its prompt slots + 1), fixed by
//   (bucket, prompt slots); a block takes plan blocks blockIdx.x,
//   + gridDim.x, ..., so a smaller count is slower, never wrong, and the
//   blocks past the plan exit after reading the ids.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

using namespace repro::tf32;

constexpr float NEG2_LOG2E = -2.8853900817779268f;  // -2 log2(e)
constexpr float SQRT2M1 = 0.41421356237309515f;     // sqrt(2) - 1

enum KvType { KV_F32 = 0, KV_BF16 = 1, KV_I8 = 2 };

template <int KV>
__host__ __device__ constexpr int kv_bytes() {
  return KV == KV_F32 ? 4 : (KV == KV_BF16 ? 2 : 1);
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* k_scale;  // nullable
  const float* v_scale;  // nullable with k_scale
  const int* q_offset;   // nullable: q_off0 for every row
  const int* kv_valid;   // nullable: valid0 for every row
  const int* q_seg;      // nullable [B, Sq]
  const int* kv_seg;     // nullable with q_seg, [B, Sk]
  float* out;
  int B, Sq, Sk, H, KVH, hd;
  int q_off0, valid0;
  int causal, quant_bits, local_window;
  float softcap, sqrt_hd;
  int vec;  // q, k, v, out 16-byte aligned and rows of 16-byte multiples
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes, zero-filled (no read) when !pred
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

__device__ __forceinline__ float finish_score(float dot, float ks, bool scaled,
                                              const Args& a) {
  float s = dot;
  if (scaled) s = __fmul_rn(s, ks);
  s = __fdiv_rn(s, a.sqrt_hd);
  if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
  return s;
}

__device__ __forceinline__ bool visible(const Args& a, int key, int qpos, int valid,
                                        bool segs, int qseg, int kseg) {
  bool ok = key < valid;
  if (a.causal) ok = ok && key <= qpos;
  if (a.local_window > 0) ok = ok && qpos - key < a.local_window;
  if (segs) ok = ok && qseg == kseg;
  return ok;
}

// The numerator weight of a visible key of score s against the row max m.
__device__ __forceinline__ float code_weight(float s, float m, float code_max) {
  const int c = (int)fminf(fmaxf(rintf(NEG2_LOG2E * (s - m)), 0.f), code_max);
  const int e = (c + 1) >> 1;
  const float base = (c & 1) ? 1.0f + SQRT2M1 : 1.0f;
  // base x 2^-e: a product with a normal power of two is exact (ldexpf's
  // result); ldexpf itself only where 2^-e would be subnormal
  return e < 126 ? base * __int_as_float((127 - e) << 23) : ldexpf(base, -e);
}

// ---------------------------------------------------------------------------
// the score function: split-precision tf32 MMAs a k8 chunk (the pieces and
// the MMA: tf32_mma.cuh)
// ---------------------------------------------------------------------------

// One stored K/V element as f32 (exact; for bf16 and int8 also exactly a
// tf32 value).
template <int KV>
__device__ __forceinline__ float kv_at(const int8_t* row, int d) {
  if constexpr (KV == KV_F32) return reinterpret_cast<const float*>(row)[d];
  if constexpr (KV == KV_BF16)
    return __uint_as_float((uint32_t)reinterpret_cast<const uint16_t*>(row)[d] << 16);
  return static_cast<float>(row[d]);
}

// c = a . b over one k8 chunk, from zero, for a = hi + mid + lo (A
// fragments) and b one K/V element pair of the B fragment: exact b (bf16,
// int8) takes lo.b + mid.b + hi.b, all exact; f32 b is split in two and
// takes mid.b_hi + hi.b_lo + hi.b_hi. The smaller terms go first.
template <int KV>
__device__ __forceinline__ void mma_chunk(float (&c)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&am)[4], const uint32_t (&al)[4],
                                          float b0, float b1) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  if constexpr (KV == KV_F32) {
    uint32_t bh0, bl0, bh1, bl1;
    split2(b0, bh0, bl0);
    split2(b1, bh1, bl1);
    mma_tf32(c, am, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, ah, bh0, bh1);
  } else {
    mma_tf32(c, al, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(c, am, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(c, ah, __float_as_uint(b0), __float_as_uint(b1));
  }
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t to_bf16(float x) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

// Two adjacent stored K elements d, d + 1 (d even) as a bf16 pair, the
// lower dim in the low half (int8 and bf16 are exact in bf16).
template <int KV>
__device__ __forceinline__ uint32_t kv_pair(const int8_t* row, int d) {
  if constexpr (KV == KV_BF16) return *reinterpret_cast<const uint32_t*>(row + 2 * d);
  const uint32_t lo = __float_as_uint(static_cast<float>(row[d])) >> 16;
  const uint32_t hi = __float_as_uint(static_cast<float>(row[d + 1])) >> 16;
  return lo | (hi << 16);
}

// Row stride, in pieces' elements, of q's three pieces: tf32 floats for f32
// K, bf16 for int8 and bf16 K (rows 4 banks apart either way).
template <int KV>
__host__ __device__ constexpr int q_piece_row(int hdp) {
  return KV == KV_F32 ? hdp + 4 : hdp + 8;
}

// q's three pieces of element x at index idx of each piece (`piece`
// elements apart): f32 K takes tf32 pieces (split3), int8 and bf16 K bf16
// pieces, hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid): each
// difference is exact and what is left after two 8-bit pieces has at most
// 7 significant bits, so hi + mid + lo == x (while the pieces are normal).
template <int KV>
__device__ __forceinline__ void put_q_pieces(void* q, int piece, int idx, float x) {
  if constexpr (KV == KV_F32) {
    float* p = static_cast<float*>(q);
    uint32_t hi, mid, lo;
    split3(x, hi, mid, lo);
    p[idx] = __uint_as_float(hi);
    p[piece + idx] = __uint_as_float(mid);
    p[2 * piece + idx] = __uint_as_float(lo);
  } else {
    uint16_t* p = static_cast<uint16_t*>(q);
    const uint16_t hi = to_bf16(x);
    const float r = x - bf16_to_f32(hi);
    const uint16_t mid = to_bf16(r);
    p[idx] = hi;
    p[piece + idx] = mid;
    p[2 * piece + idx] = to_bf16(r - bf16_to_f32(mid));
  }
}

// s += q . k over hdp dims (a multiple of 16) for the 16 x 8 MMA tile: q's
// three pieces in shared memory (put_q_pieces; row g, g + 8 of the
// fragment; rows_hi == false: rows g + 8 are zero and not read), k_row the
// fragment's key (key g) in its stored dtype. f32 K: m16n8k8 tf32 MMAs, 8
// dims a chunk (mma_chunk); int8 and bf16 K: m16n8k16 bf16 MMAs, 16 dims a
// chunk, lo.k + mid.k + hi.k, all 48 products exact. Each chunk starts from
// zero and is added to s with __fadd_rn.
template <int KV>
__device__ __forceinline__ void score_mma(float (&s)[4], const void* q, int q_row, int piece,
                                          bool row_lo, bool rows_hi, const int8_t* k_row,
                                          int hdp, int g, int t) {
  if constexpr (KV == KV_F32) {
    const float* qh = static_cast<const float*>(q);
    const float* qm = qh + piece;
    const float* ql = qm + piece;
#pragma unroll 4
    for (int kk = 0; kk < hdp; kk += 8) {
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, am[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      const int ia = g * q_row + kk + t, ib = ia + 8 * q_row;
      if (row_lo) {
        ah[0] = __float_as_uint(qh[ia]); ah[2] = __float_as_uint(qh[ia + 4]);
        am[0] = __float_as_uint(qm[ia]); am[2] = __float_as_uint(qm[ia + 4]);
        al[0] = __float_as_uint(ql[ia]); al[2] = __float_as_uint(ql[ia + 4]);
      }
      if (rows_hi) {
        ah[1] = __float_as_uint(qh[ib]); ah[3] = __float_as_uint(qh[ib + 4]);
        am[1] = __float_as_uint(qm[ib]); am[3] = __float_as_uint(qm[ib + 4]);
        al[1] = __float_as_uint(ql[ib]); al[3] = __float_as_uint(ql[ib + 4]);
      }
      float c[4];
      mma_chunk<KV>(c, ah, am, al, kv_at<KV>(k_row, kk + t), kv_at<KV>(k_row, kk + t + 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = __fadd_rn(s[e], c[e]);
    }
  } else {
    const uint16_t* qh = static_cast<const uint16_t*>(q);
    const uint16_t* qm = qh + piece;
    const uint16_t* ql = qm + piece;
    auto pair = [](const uint16_t* p) { return *reinterpret_cast<const uint32_t*>(p); };
#pragma unroll 4
    for (int kk = 0; kk < hdp; kk += 16) {
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, am[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      const int ia = g * q_row + kk + 2 * t, ib = ia + 8 * q_row;
      if (row_lo) {
        ah[0] = pair(qh + ia); ah[2] = pair(qh + ia + 8);
        am[0] = pair(qm + ia); am[2] = pair(qm + ia + 8);
        al[0] = pair(ql + ia); al[2] = pair(ql + ia + 8);
      }
      if (rows_hi) {
        ah[1] = pair(qh + ib); ah[3] = pair(qh + ib + 8);
        am[1] = pair(qm + ib); am[3] = pair(qm + ib + 8);
        al[1] = pair(ql + ib); al[3] = pair(ql + ib + 8);
      }
      const uint32_t b0 = kv_pair<KV>(k_row, kk + 2 * t), b1 = kv_pair<KV>(k_row, kk + 2 * t + 8);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c, al, b0, b1);
      mma_bf16(c, am, b0, b1);
      mma_bf16(c, ah, b0, b1);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = __fadd_rn(s[e], c[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// P.V and the final merge, one code in both schedules
// ---------------------------------------------------------------------------

constexpr int TL_BK = 64;     // keys a tile (and a decode ring tile)
constexpr int TL_WARPS = 8;   // each takes TL_KW keys of every tile
constexpr int TL_KW = TL_BK / TL_WARPS;
constexpr int TL_THREADS = 32 * TL_WARPS;
constexpr int TL_MAX_HD = 256;
// Head-dim classes: a lane holds NT n8 output tiles, 16 (hd <= 128) or 32
// (hd <= 256), so the output accumulators take 4 NT f32 registers and the
// hd <= 128 instantiations keep the 64 they had before the wider class.
constexpr int NT_128 = 16, NT_256 = 32;
constexpr int TL_PSTR = TL_KW + 4;  // floats a row of a warp's P: 4 g + t hits 32 banks

// One tile's P.V for a warp's 8 keys. s: the masked scores (-inf: not
// visible) of keys 2 t, 2 t + 1 of rows g (s[0..1]) and g + 8 (s[2..3]);
// m: the rows' maxima (QUANT: the exact max; else updated here, online);
// l: this lane's partial denominators; o: the 16 x hdp outputs (n8 tile n
// holds dims 8 n + 2 t, + 1 of rows g and g + 8); pw: the warp's P [16]
// [TL_PSTR]; vt: the V row of the warp's first key; vscale: its scales.
// P goes in three tf32 pieces (exact against int8 and bf16 V) and each n8
// tile's chunk is added with __fadd_rn.
template <int KV, bool QUANT, int NT>
__device__ __forceinline__ void pv_step(const float (&s)[4], float (&m)[2], float (&l)[2],
                                        float (&o)[NT][4], float* pw, const int8_t* vt,
                                        int v_row, const float* vscale, bool scaled,
                                        float code_max, int hdp, int g, int t) {
  float corr[2] = {1.f, 1.f};
  if (!QUANT) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = fmaxf(s[2 * i], s[2 * i + 1]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mi = fmaxf(m[i], fmaxf(tmax, -1e30f));
      corr[i] = expf(m[i] - mi);
      m[i] = mi;
    }
  }
  float lsum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = e >> 1, jj = 2 * t + (e & 1);
    float p = 0.f;
    if (s[e] != -INFINITY) {
      const float ex = expf(s[e] - m[i]);
      lsum[i] = __fadd_rn(lsum[i], ex);
      p = QUANT ? code_weight(s[e], m[i], code_max) : ex;
      if (scaled) p = __fmul_rn(p, vscale[jj]);
    }
    pw[(g + 8 * i) * TL_PSTR + jj] = p;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaf(l[i], corr[i], lsum[i]);
  if (!QUANT) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] = __fmul_rn(o[n][0], corr[0]);
      o[n][1] = __fmul_rn(o[n][1], corr[0]);
      o[n][2] = __fmul_rn(o[n][2], corr[1]);
      o[n][3] = __fmul_rn(o[n][3], corr[1]);
    }
  }
  __syncwarp();
  uint32_t ph[4], pm[4], pl[4];
  const float pv[4] = {pw[g * TL_PSTR + t], pw[(g + 8) * TL_PSTR + t],
                       pw[g * TL_PSTR + t + 4], pw[(g + 8) * TL_PSTR + t + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(pv[i], ph[i], pm[i], pl[i]);
  const int8_t* v0 = vt + t * v_row;
  const int8_t* v1 = v0 + 4 * v_row;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (8 * n >= hdp) break;
    float c[4];
    mma_chunk<KV>(c, ph, pm, pl, kv_at<KV>(v0, 8 * n + g), kv_at<KV>(v1, 8 * n + g));
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = __fadd_rn(o[n][e], c[e]);
  }
  __syncwarp();  // the warp's P rows are rewritten by the next tile
}

// The warps' partials of one lane: this lane's denominators summed over
// its quad, then (t == 0) the maxima and denominators of rows g, g + 8 into
// red_m / red_l [warp], the outputs into part [warp][16][hdp + 8] (rows 8
// banks apart: a half-warp's float2 stores and loads hit 32 banks).
template <int NT>
__device__ __forceinline__ void store_partials(const float (&m)[2], float (&l)[2],
                                               const float (&o)[NT][4], float* part,
                                               float (*red_m)[16], float (*red_l)[16],
                                               int hdp, int warp, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
    l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (t == 0) {
      red_m[warp][g + 8 * i] = m[i];
      red_l[warp][g + 8 * i] = l[i];
    }
    float* pr = part + (warp * 16 + g + 8 * i) * (hdp + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (8 * n >= hdp) break;
      *reinterpret_cast<float2*>(pr + 8 * n + 2 * t) = make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
}

// Row r of the output from the 8 warps' partials (rescaled to the largest
// max; QUANT: one exact max, so the factors are 1): this warp writes every
// 8th n8 tile, this lane dims 8 n + 2 t, + 1 of it, those below hd.
__device__ __forceinline__ void merge_row(const float* part, const float (*red_m)[16],
                                          const float (*red_l)[16], int r, int hdp, int hd,
                                          bool vec, int warp, int t, float* out) {
  float mm = red_m[0][r];
  for (int w = 1; w < TL_WARPS; ++w) mm = fmaxf(mm, red_m[w][r]);
  float f[TL_WARPS], ll = 0.f;
#pragma unroll
  for (int w = 0; w < TL_WARPS; ++w) {
    f[w] = expf(red_m[w][r] - mm);
    ll = fmaf(red_l[w][r], f[w], ll);
  }
  const float den = fmaxf(ll, 1e-30f);
  for (int n = warp; 8 * n < hdp; n += TL_WARPS) {
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int w = 0; w < TL_WARPS; ++w) {
      const float2 v =
          *reinterpret_cast<const float2*>(part + (w * 16 + r) * (hdp + 8) + 8 * n + 2 * t);
      x0 = fmaf(v.x, f[w], x0);
      x1 = fmaf(v.y, f[w], x1);
    }
    const int d = 8 * n + 2 * t;
    if (vec) {  // hd % 4 == 0
      if (d < hd) *reinterpret_cast<float2*>(out + d) = make_float2(x0 / den, x1 / den);
    } else {
      if (d < hd) out[d] = x0 / den;
      if (d + 1 < hd) out[d + 1] = x1 / den;
    }
  }
}

// ---------------------------------------------------------------------------
// schedule decode
// ---------------------------------------------------------------------------

// The decode schedule takes hd = HD, 128 or 256 (NT = HD / 8 output tiles).
constexpr int DEC_RMAX = 4;   // query rows a block, at most
constexpr int DEC_META = TL_BK * 8;  // a tile's scales and segment ids

template <int KV, int HD>
__host__ __device__ constexpr int dec_row() {  // bytes a key's row in the ring
  return HD * kv_bytes<KV>() + 16;
}

// Ring stages: at hd 128 int8 8 (77,824 bytes), bf16 6 (107,520), f32 3
// (102,912); at hd 256 int8 8 (143,360), bf16 4 (137,216), f32 2 (134,144),
// so that the ring, 64 KB of scores (DECODE_SCORE_BYTES) and the static
// q pieces, P and maxima (19,648 bytes at hd 256) fit a block's 232,448.
template <int KV, int HD>
__host__ __device__ constexpr int dec_stages() {
  if (HD == 128) return KV == KV_I8 ? 8 : (KV == KV_BF16 ? 6 : 3);
  return KV == KV_I8 ? 8 : (KV == KV_BF16 ? 4 : 2);
}

template <int KV, int HD>
__host__ __device__ constexpr int dec_stage_bytes() {
  return TL_BK * dec_row<KV, HD>() + DEC_META;
}

template <int KV, bool QUANT, int RMAX, int HD>
__global__ void __launch_bounds__(TL_THREADS) lm_decode_kernel(Args a) {
  constexpr int ES = kv_bytes<KV>(), ROWP = dec_row<KV, HD>(), STAGES = dec_stages<KV, HD>();
  constexpr int STAGE = dec_stage_bytes<KV, HD>(), NT = HD / 8, DEC_QROW = HD + 4;
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ float red_m[TL_WARPS][16], red_l[TL_WARPS][16];
  __shared__ __align__(16) float qs[3 * RMAX * DEC_QROW];  // q's pieces; zero rows past R
  __shared__ float pbuf[TL_WARPS][16 * TL_PSTR];  // each warp's P
  float* scores = reinterpret_cast<float*>(smem + STAGES * STAGE);  // [R][Sk]
  const uint32_t s0 = smem_u32(smem);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.KVH, R = a.Sq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool scaled = a.k_scale != nullptr, segs = a.q_seg != nullptr;
  const int q_off = a.q_offset != nullptr ? a.q_offset[b] : a.q_off0;
  const int valid = min(a.kv_valid != nullptr ? a.kv_valid[b] : a.valid0, a.Sk);
  const float code_max = (float)((1 << max(a.quant_bits, 1)) - 1);
  int khi = valid, klo = 0;
  if (a.causal) khi = min(khi, q_off + a.Sq);
  if (a.local_window > 0) klo = max(0, q_off - a.local_window + 1);
  const int n = max(0, khi - klo), ntiles = (n + TL_BK - 1) / TL_BK;

  // row r: query qi = r / G of head kvh * G + r % G; its q as three
  // pieces (visible to every warp after the first barrier of the ring)
  constexpr int QROW = q_piece_row<KV>(HD), QPIECE = RMAX * QROW;
  for (int e = tid; e < RMAX * HD; e += TL_THREADS) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
    if (r < R)
      x = a.q[(((size_t)b * a.Sq + r / G) * a.H + kvh * G + r % G) * HD + d];
    put_q_pieces<KV>(qs, QPIECE, r * QROW + d, x);
  }
  // this lane's row g (live when g < R) holds keys 2 t, 2 t + 1 of its
  // warp's 8 in the MMA's C layout
  const bool my_row = g < R;
  const int my_qi = min(g, R - 1) / G;
  const int my_pos = q_off + my_qi;
  const int my_seg = (segs && my_row) ? a.q_seg[(size_t)b * a.Sq + my_qi] : 0;

  // step s < ntiles: K tile s (+ k scales, segment ids); then V tile
  // s - ntiles (+ v scales)
  auto issue = [&](int step) {
    const bool is_k = step < ntiles;
    const int k0 = klo + TL_BK * (is_k ? step : step - ntiles);
    const uint32_t st = s0 + (step % STAGES) * STAGE;
    const int8_t* src = static_cast<const int8_t*>(is_k ? a.k : a.v);
    constexpr int CHUNKS = TL_BK * HD * ES / 16, ROWC = HD * ES / 16;
#pragma unroll
    for (int i = 0; i < CHUNKS / TL_THREADS; ++i) {
      const int e = tid + i * TL_THREADS;
      const int j = e / ROWC, c = e % ROWC, key = k0 + j;
      const bool ok = key < khi;
      const int8_t* gp = src + ((((size_t)b * a.Sk + key) * a.KVH + kvh) * HD) * ES + 16 * c;
      cp_async<16>(st + j * ROWP + 16 * c, ok ? gp : src, ok);
    }
    if (tid < TL_BK) {
      const int key = k0 + tid;
      const bool ok = key < khi;
      const size_t gs = ((size_t)b * a.Sk + key) * a.KVH + kvh;
      const uint32_t meta = st + TL_BK * ROWP;
      if (scaled) {
        const float* sp = is_k ? a.k_scale : a.v_scale;
        cp_async<4>(meta + 4 * tid, ok ? sp + gs : sp, ok);
      }
      if (segs && is_k)
        cp_async<4>(meta + 4 * (TL_BK + tid), ok ? a.kv_seg + (size_t)b * a.Sk + key
                                                 : a.kv_seg, ok);
    }
  };

  float mx = -1e30f, m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int nn = 0; nn < NT; ++nn) o[nn][0] = o[nn][1] = o[nn][2] = o[nn][3] = 0.f;

  const int steps = 2 * ntiles;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `step` landed; the stage of step - 1 is free
    if (step + STAGES - 1 < steps) issue(step + STAGES - 1);
    cp_async_commit();
    const int8_t* st = smem + (step % STAGES) * STAGE;
    const float* meta_s = reinterpret_cast<const float*>(st + TL_BK * ROWP) + TL_KW * warp;
    const int* meta_g = reinterpret_cast<const int*>(meta_s + TL_BK);
    if (QUANT && step == ntiles) {  // every score is in: the warps' maxima meet
      float w = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, 2));
      if (t == 0 && g < RMAX) red_m[warp][g] = w;
      __syncthreads();
      if (g < RMAX)
        for (int w2 = 0; w2 < TL_WARPS; ++w2) m[0] = fmaxf(m[0], red_m[w2][g]);
    }
    const bool is_k = step < ntiles;
    const int k0 = klo + TL_BK * (is_k ? step : step - ntiles) + TL_KW * warp;  // the warp's keys
    const int8_t* rows = st + TL_KW * warp * ROWP;
    if (is_k) {  // pass 1: the scores, into shared memory
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      score_mma<KV>(s, qs, QROW, QPIECE, g < RMAX, false, rows + g * ROWP, HD, g, t);
      if (my_row) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 2 * t + e, key = k0 + jj;
          if (key < khi) {
            float fs = finish_score(s[e], scaled ? meta_s[jj] : 1.f, scaled, a);
            if (!visible(a, key, my_pos, valid, segs, my_seg, segs ? meta_g[jj] : 0))
              fs = -INFINITY;
            scores[g * a.Sk + key - klo] = fs;
            mx = fmaxf(mx, fs);
          }
        }
      }
      continue;
    }
    // pass 2: the scores back, P.V as the tile schedule runs it
    float s[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (my_row) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 2 * t + e;
        if (key < khi) s[e] = scores[g * a.Sk + key - klo];
      }
    }
    pv_step<KV, QUANT, NT>(s, m, l, o, pbuf[warp], rows, ROWP, meta_s, scaled, code_max, HD,
                           g, t);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' partial outputs

  float* part = reinterpret_cast<float*>(smem);
  store_partials<NT>(m, l, o, part, red_m, red_l, HD, warp, g, t);
  __syncthreads();
  if (my_row)
    merge_row(part, red_m, red_l, g, HD, HD, true, warp, t,
              a.out + (((size_t)b * a.Sq + g / G) * a.H + kvh * G + g % G) * HD);
}

// ---------------------------------------------------------------------------
// schedule tile
// ---------------------------------------------------------------------------

constexpr int TL_BQ = 16;     // query rows a block

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct TileLayout {
  int hdp, q_row, k_row, v_row, stage, stages, stages_off, p_off, list_off, bytes;
};

// Shared memory of the tile schedule: q's three tf32 pieces, each [16]
// [hdp + 4] floats (the f32 q lands in the first); `stages` stages of one
// tile {K [64][k_row], V [64][v_row], k scales, v scales, kv segment ids},
// rows of hdp stored elements (hd padded to a multiple of 16) and padding
// that makes the fragment reads hit 32 banks (k_row = 16 mod 32 bytes;
// v_row = 16, f32 32, mod 128); each warp's P [16][TL_PSTR] f32; the
// live-tile list. At the end the same memory, from its start, holds the
// warps' partial outputs. Two stages (tile t + 1 lands while tile t is
// multiplied), except f32 K/V at hd > 128: at hd 256 a stage is 134,912
// bytes and two (269,824) exceed a block's 232,448 on their own, so that
// class streams one tile at a time (49,920 of q pieces + 134,912 + 6,144
// of P: 190,976 bytes and the list); bf16 (193 KB) and int8 (127 KB) keep
// two.
__host__ __device__ inline TileLayout tile_layout(int hd, int es, int Sk) {
  TileLayout t;
  t.hdp = round_up(hd, 16);
  t.q_row = t.hdp + 4;
  t.k_row = round_up(t.hdp * es, 32) + 16;
  t.v_row = round_up(t.hdp * es, 128) + (es == 4 ? 32 : 16);
  t.stage = TL_BK * (t.k_row + t.v_row) + 3 * TL_BK * 4;
  t.stages = (es == 4 && t.hdp > 128) ? 1 : 2;
  t.stages_off = 3 * TL_BQ * t.q_row * 4;
  t.p_off = t.stages_off + t.stages * t.stage;
  t.list_off = t.p_off + TL_WARPS * 16 * TL_PSTR * 4;
  t.bytes = t.list_off + 4 * ((Sk + TL_BK - 1) / TL_BK + 1);
  const int part = TL_WARPS * 16 * (t.hdp + 8) * 4;  // the warps' partial outputs
  if (t.bytes < part) t.bytes = part;
  return t;
}

// One stored element into a shared-memory row, zero when !ok (the staging
// of rows that are not whole 16-byte chunks, or of unaligned operands).
template <int KV>
__device__ __forceinline__ void copy_elem(int8_t* row, int d, const void* src, size_t i,
                                          bool ok) {
  if constexpr (KV == KV_F32)
    reinterpret_cast<float*>(row)[d] = ok ? static_cast<const float*>(src)[i] : 0.f;
  else if constexpr (KV == KV_BF16)
    reinterpret_cast<uint16_t*>(row)[d] = ok ? static_cast<const uint16_t*>(src)[i] : 0;
  else
    row[d] = ok ? static_cast<const int8_t*>(src)[i] : 0;
}

// The segment-keyed plan of a packed prefill (q segment ids given): the
// query rows of batch row b are cut at every change of q id into runs (a
// prompt, the pad tail) and each run into blocks of TL_BQ rows from its
// first row. Plan block pb (in row order) -> its first row; -1 past the
// last. The ids come in chunks of TL_THREADS through shared memory (one
// round trip a chunk) and warp 0 walks each chunk 32 rows at a time: a run
// starts where the id changes, a block where (row - run start) % TL_BQ is
// 0. Returns (first row, rows: up to TL_BQ rows of its id), the same in
// every thread.
__device__ int2 plan_block(const Args& a, int b, int pb) {
  __shared__ int ids[TL_THREADS], found, rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* qs = a.q_seg + (size_t)b * a.Sq;
  // warp 0: plan blocks before this chunk, the open run's first row, the
  // id before this chunk, the row found (warp-uniform)
  int count = 0, run_start = 0, prev = 0, row = -1;
  if (tid == 0) found = -1;
  for (int base = 0; base < a.Sq; base += TL_THREADS) {
    __syncthreads();  // `found` is set and the previous chunk is consumed
    if (found >= 0) break;
    ids[tid] = base + tid < a.Sq ? qs[base + tid] : 0;
    __syncthreads();
    if (warp != 0) continue;
    for (int sub = 0; sub < TL_THREADS && base + sub < a.Sq && row < 0; sub += 32) {
      const int r = base + sub + lane;
      const bool in = r < a.Sq;
      const int id = ids[sub + lane];
      const int before = lane > 0 ? ids[sub + lane - 1] : (sub > 0 ? ids[sub - 1] : prev);
      const unsigned starts = __ballot_sync(0xffffffffu, in && (r == 0 || id != before));
      const unsigned upto = starts & (0xffffffffu >> (31 - lane));  // run starts <= r
      const int rs = upto ? base + sub + 31 - __clz(upto) : run_start;
      const bool first = in && (r - rs) % TL_BQ == 0;
      const unsigned firsts = __ballot_sync(0xffffffffu, first);
      const unsigned hit = __ballot_sync(
          0xffffffffu, first && __popc(firsts & ((1u << lane) - 1)) == pb - count);
      if (hit) row = base + sub + __ffs(hit) - 1;
      count += __popc(firsts);
      if (starts) run_start = base + sub + 31 - __clz(starts);
    }
    prev = ids[TL_THREADS - 1];
    if (tid == 0) found = row;
  }
  __syncthreads();
  const int q0 = found;
  if (q0 >= 0 && warp == 0) {  // the run goes on while the id does
    const bool same = lane < TL_BQ && q0 + lane < a.Sq && qs[q0 + lane] == qs[q0];
    const unsigned m = __ballot_sync(0xffffffffu, same);
    if (lane == 0) rows = __ffs(~m) - 1;
  }
  __syncthreads();
  return make_int2(q0, q0 >= 0 ? rows : 0);
}

// One block of the tile schedule: rows [q0, q0 + n_rows) of (b, head h),
// all of one q segment id when segment ids are given. NT: the head-dim
// class; STAGES: tile_layout's stages (1 or 2).
template <int KV, bool QUANT, int NT, int STAGES>
__device__ __forceinline__ void tile_block(const Args& a, int8_t* smem, int b, int h, int q0,
                                           int n_rows) {
  constexpr int ES = kv_bytes<KV>();
  __shared__ int n_live, first_key;
  __shared__ float red_m[TL_WARPS][16], red_l[TL_WARPS][16];
  const int hd = a.hd;
  const TileLayout L = tile_layout(hd, ES, a.Sk);
  const int hdp = L.hdp;
  float* qh = reinterpret_cast<float*>(smem);  // the f32 q rows, [16][q_row]
  // q's three pieces: over the f32 rows (tf32, split in place) or past them
  // (bf16)
  void* qp = KV == KV_F32 ? static_cast<void*>(smem)
                          : static_cast<void*>(smem + TL_BQ * L.q_row * 4);
  const int qp_row = q_piece_row<KV>(L.hdp), qp_piece = TL_BQ * qp_row;
  int* live = reinterpret_cast<int*>(smem + L.list_off);
  const uint32_t s0 = smem_u32(smem);
  const int kvh = h / (a.H / a.KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* pw = reinterpret_cast<float*>(smem + L.p_off) + warp * 16 * TL_PSTR;
  const bool scaled = a.k_scale != nullptr, segs = a.q_seg != nullptr;
  const int q_off = a.q_offset != nullptr ? a.q_offset[b] : a.q_off0;
  const int valid = min(a.kv_valid != nullptr ? a.kv_valid[b] : a.valid0, a.Sk);
  const float code_max = (float)((1 << max(a.quant_bits, 1)) - 1);
  const int pos_first = q_off + q0, pos_last = q_off + q0 + n_rows - 1;
  int khi = valid, klo = 0;
  if (a.causal) khi = min(khi, pos_last + 1);
  if (a.local_window > 0) klo = max(0, pos_first - a.local_window + 1);

  // f32 q rows of the block (zero past n_rows and past hd) into the hi
  // array, with stage 0
  const float* qsrc = a.q + (((size_t)b * a.Sq + q0) * a.H + h) * hd;
  const size_t q_stride = (size_t)a.H * hd;  // floats between query rows
  if (a.vec) {
    for (int r = warp; r < TL_BQ; r += TL_WARPS)
      for (int c = lane; c < hdp / 4; c += 32) {
        const bool ok = r < n_rows && 4 * c < hd;
        cp_async<16>(s0 + (r * L.q_row + 4 * c) * 4, ok ? qsrc + r * q_stride + 4 * c : a.q,
                     ok);
      }
  } else {
    for (int e = tid; e < TL_BQ * hdp; e += TL_THREADS) {
      const int r = e / hdp, d = e - r * hdp;
      qh[r * L.q_row + d] = (r < n_rows && d < hd) ? qsrc[r * q_stride + d] : 0.f;
    }
  }

  // this lane's rows g and g + 8
  const int sigma = segs ? a.q_seg[(size_t)b * a.Sq + q0] : 0;  // the block's q id
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_ok[i] = g + 8 * i < n_rows;
    qpos[i] = q_off + q0 + g + 8 * i;
  }

  // With segment ids the block's tiles start at its segment's first key
  // (the first key of id sigma at or past the window's start), so a
  // prompt's keys fall to the same tile, warp and lane as in a prefill of
  // it alone; and only the tiles holding a key of id sigma are live, since
  // no row of the block can see any other key (a dead tile would add exact
  // zeros). Without segment ids every tile of [klo, khi) is live.
  const int* kv_ids = segs ? a.kv_seg + (size_t)b * a.Sk : nullptr;
  if (segs) {
    if (tid == 0) first_key = max(khi, klo);
    __syncthreads();
    for (int key = klo + tid; key < khi; key += TL_THREADS)
      if (kv_ids[key] == sigma) {
        atomicMin(&first_key, key);
        break;
      }
    __syncthreads();
    klo = first_key;
  }
  const int ntiles = khi > klo ? (khi - klo + TL_BK - 1) / TL_BK : 0;
  if (!segs) {
    if (tid == 0) n_live = ntiles;
  } else {
    for (int tile = warp; tile < ntiles; tile += TL_WARPS) {
      const int key = klo + tile * TL_BK + lane;
      const bool hit = (key < khi && kv_ids[key] == sigma) ||
                       (key + 32 < khi && kv_ids[key + 32] == sigma);
      const bool any = __any_sync(0xffffffffu, hit);
      if (lane == 0) live[tile] = any;
    }
    __syncthreads();
    if (tid == 0) {
      int nl = 0;
      for (int tile = 0; tile < ntiles; ++tile)
        if (live[tile]) live[nl++] = tile;
      n_live = nl;
    }
  }
  __syncthreads();
  const int spp = n_live;  // steps a pass: one live tile a step
  const int steps = (QUANT ? 2 : 1) * spp;

  // step st: live tile st % spp; K alone in the max pass of QUANT, K and V
  // otherwise
  auto issue = [&](int st) {
    const bool need_v = !QUANT || st >= spp;
    const int li = st % spp;
    const int k0 = klo + (segs ? live[li] : li) * TL_BK;
    const int off_k = L.stages_off + (st % STAGES) * L.stage, off_v = off_k + TL_BK * L.k_row;
    const int8_t* kp = static_cast<const int8_t*>(a.k);
    const int8_t* vp = static_cast<const int8_t*>(a.v);
    if (a.vec) {  // 16-byte chunks; those past hd are zero-filled
      const int C = hdp * ES / 16, row_bytes = hd * ES;
      for (int e = tid; e < TL_BK * C; e += TL_THREADS) {
        const int j = e / C, c = e - j * C, key = k0 + j;
        const bool ok = key < khi && 16 * c < row_bytes;
        const size_t off = (((size_t)b * a.Sk + key) * a.KVH + kvh) * row_bytes + 16 * c;
        cp_async<16>(s0 + off_k + j * L.k_row + 16 * c, ok ? kp + off : kp, ok);
        if (need_v) cp_async<16>(s0 + off_v + j * L.v_row + 16 * c, ok ? vp + off : vp, ok);
      }
    } else {  // element by element, zeros past hd
      for (int e = tid; e < TL_BK * hdp; e += TL_THREADS) {
        const int j = e / hdp, d = e - j * hdp, key = k0 + j;
        const bool ok = key < khi && d < hd;
        const size_t i = (((size_t)b * a.Sk + key) * a.KVH + kvh) * hd + d;
        copy_elem<KV>(smem + off_k + j * L.k_row, d, kp, i, ok);
        if (need_v) copy_elem<KV>(smem + off_v + j * L.v_row, d, vp, i, ok);
      }
    }
    for (int j = tid; j < TL_BK; j += TL_THREADS) {
      const int key = k0 + j;
      const bool ok = key < khi;
      const size_t gs = ((size_t)b * a.Sk + key) * a.KVH + kvh;
      const uint32_t meta = s0 + off_v + TL_BK * L.v_row;
      if (scaled) {
        cp_async<4>(meta + 4 * j, ok ? a.k_scale + gs : a.k_scale, ok);
        if (need_v) cp_async<4>(meta + 4 * (TL_BK + j), ok ? a.v_scale + gs : a.v_scale, ok);
      }
      if (segs)
        cp_async<4>(meta + 4 * (2 * TL_BK + j),
                    ok ? a.kv_seg + (size_t)b * a.Sk + key : a.kv_seg, ok);
    }
  };

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) issue(st);
    cp_async_commit();
  }
  if constexpr (STAGES == 1) cp_async_commit();  // q's group, before any tile's
  for (int st = 0; st < steps; ++st) {
    if constexpr (STAGES == 1) {  // one stage: tile st - 1 is done with, then st lands
      if (st > 0) __syncthreads();
      issue(st);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<STAGES - 2>();
    }
    __syncthreads();  // step st (and q) landed; the stage of step st - 1 is free
    if (st == 0) {    // q -> its three pieces, once
      for (int e = tid; e < TL_BQ * hdp; e += TL_THREADS) {
        const int r = e / hdp, d = e % hdp;
        put_q_pieces<KV>(qp, qp_piece, r * qp_row + d, qh[r * L.q_row + d]);
      }
      __syncthreads();
    }
    if (QUANT && st == spp) {  // the exact row max: lanes, then warps, meet
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
        if (t == 0) red_m[warp][g + 8 * i] = m[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
        for (int w = 0; w < TL_WARPS; ++w) m[i] = fmaxf(m[i], red_m[w][g + 8 * i]);
    }
    if constexpr (STAGES > 1) {
      if (st + STAGES - 1 < steps) issue(st + STAGES - 1);
      cp_async_commit();
    }
    const int li = st % spp;
    const bool max_pass = QUANT && st < spp;
    const int k0 = klo + (segs ? live[li] : li) * TL_BK + warp * TL_KW;  // the warp's keys
    const int8_t* kt = smem + L.stages_off + (st % STAGES) * L.stage;
    const int8_t* vt = kt + TL_BK * L.k_row;
    const float* kscale = reinterpret_cast<const float*>(vt + TL_BK * L.v_row) + warp * TL_KW;
    const float* vscale = kscale + TL_BK;
    const int* kseg = reinterpret_cast<const int*>(vscale + TL_BK);
    kt += warp * TL_KW * L.k_row;
    vt += warp * TL_KW * L.v_row;

    // S = q k^T for the 16 rows x the warp's 8 keys: keys 2 t, 2 t + 1 of
    // rows g (s[0..1]) and g + 8 (s[2..3])
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    score_mma<KV>(s, qp, qp_row, qp_piece, true, true, kt + g * L.k_row, hdp, g, t);
    // scale, softcap, mask
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, jj = 2 * t + (e & 1), key = k0 + jj;
      const float fs = finish_score(s[e], scaled ? kscale[jj] : 1.f, scaled, a);
      const bool ok = row_ok[i] && key < khi &&
                      visible(a, key, qpos[i], valid, segs, sigma, segs ? kseg[jj] : 0);
      s[e] = ok ? fs : -INFINITY;
    }
    if (max_pass) {
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[e]);
      continue;
    }
    pv_step<KV, QUANT, NT>(s, m, l, o, pw, vt, L.v_row, vscale, scaled, code_max, hdp, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with q and the stages

  float* part = reinterpret_cast<float*>(smem);
  store_partials<NT>(m, l, o, part, red_m, red_l, hdp, warp, g, t);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (row_ok[i])
      merge_row(part, red_m, red_l, g + 8 * i, hdp, hd, a.vec, warp, t,
                a.out + (((size_t)b * a.Sq + q0 + g + 8 * i) * a.H + h) * hd);
}

// grid (ceil(Sq / TL_BQ) + the wrapper's segment count when segment ids are
// given, H, B). Without segment ids block x holds rows 16 x ..; with them
// it takes plan blocks x, x + gridDim.x, ... until the plan ends (one each
// when the grid covers the plan; a row's bits do not depend on which block
// computes it).
template <int KV, bool QUANT, int NT, int STAGES>
__global__ void __launch_bounds__(TL_THREADS) lm_tile_kernel(Args a) {
  extern __shared__ __align__(128) int8_t smem[];
  const int b = blockIdx.z, h = blockIdx.y;
  if (a.q_seg == nullptr) {
    const int q0 = blockIdx.x * TL_BQ;
    tile_block<KV, QUANT, NT, STAGES>(a, smem, b, h, q0, min(TL_BQ, a.Sq - q0));
    return;
  }
  for (int pb = blockIdx.x;; pb += gridDim.x) {
    const int2 blk = plan_block(a, b, pb);
    if (blk.x < 0) return;
    tile_block<KV, QUANT, NT, STAGES>(a, smem, b, h, blk.x, blk.y);
    __syncthreads();  // the next plan block restages shared memory
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int es_of(int kv_type) { return kv_type == KV_F32 ? 4 : (kv_type == KV_BF16 ? 2 : 1); }

template <int KV, int HD>
size_t decode_ring_bytes() {
  return (size_t)dec_stages<KV, HD>() * dec_stage_bytes<KV, HD>();
}

// The ring and R rows of Sk scores; at the end the same memory holds the
// warps' partial outputs (8 x 16 x (hd + 8) floats), which at hd 256 may
// outgrow an f32 ring over few keys.
size_t decode_bytes(int kv_type, int hd, int R, int Sk) {
  size_t ring;
  if (hd == 128)
    ring = kv_type == KV_F32    ? decode_ring_bytes<KV_F32, 128>()
           : kv_type == KV_BF16 ? decode_ring_bytes<KV_BF16, 128>()
                                : decode_ring_bytes<KV_I8, 128>();
  else
    ring = kv_type == KV_F32    ? decode_ring_bytes<KV_F32, 256>()
           : kv_type == KV_BF16 ? decode_ring_bytes<KV_BF16, 256>()
                                : decode_ring_bytes<KV_I8, 256>();
  const size_t part = (size_t)TL_WARPS * 16 * (hd + 8) * 4;
  const size_t need = ring + 4 * (size_t)R * Sk;
  return need > part ? need : part;
}

template <typename Kernel>
cudaError_t launch_with(Kernel* kernel, dim3 grid, int threads, size_t smem,
                        const Args& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One head-dim class NT (16: hd <= 128, 32: hd <= 256); the decode
// schedule takes hd = 8 NT exactly.
template <int KV, bool QUANT, int NT>
cudaError_t launch_class(const Args& a, int schedule, int segments, cudaStream_t stream) {
  constexpr int HD = 8 * NT;
  if (schedule == 0) {
    const int R = a.Sq * (a.H / a.KVH);
    const size_t smem = decode_bytes(KV, HD, R, a.Sk);
    return R == 1 ? launch_with(lm_decode_kernel<KV, QUANT, 1, HD>, dim3(a.KVH, a.B),
                                TL_THREADS, smem, a, stream)
                  : launch_with(lm_decode_kernel<KV, QUANT, DEC_RMAX, HD>, dim3(a.KVH, a.B),
                                TL_THREADS, smem, a, stream);
  }
  const TileLayout L = tile_layout(a.hd, kv_bytes<KV>(), a.Sk);
  const dim3 grid((a.Sq + TL_BQ - 1) / TL_BQ + (a.q_seg != nullptr ? segments : 0), a.H, a.B);
  if constexpr (KV == KV_F32 && NT == NT_256) {
    if (L.stages == 1)
      return launch_with(lm_tile_kernel<KV, QUANT, NT, 1>, grid, TL_THREADS, L.bytes, a, stream);
  }
  return launch_with(lm_tile_kernel<KV, QUANT, NT, 2>, grid, TL_THREADS, L.bytes, a, stream);
}

template <int KV, bool QUANT>
cudaError_t launch_kv(const Args& a, int schedule, int segments, cudaStream_t stream) {
  return a.hd <= 8 * NT_128 ? launch_class<KV, QUANT, NT_128>(a, schedule, segments, stream)
                            : launch_class<KV, QUANT, NT_256>(a, schedule, segments, stream);
}

template <int KV>
cudaError_t launch_q(const Args& a, int schedule, int segments, cudaStream_t stream) {
  return a.quant_bits > 0 ? launch_kv<KV, true>(a, schedule, segments, stream)
                          : launch_kv<KV, false>(a, schedule, segments, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Dynamic shared memory a launch of `schedule` takes (0: decode, which
// holds R = Sq x H/KVH rows of Sk scores; 1: tile).
extern "C" size_t lm_attention_smem_bytes(int kv_type, int hd, int Sq, int G, int Sk,
                                          int schedule) {
  if (schedule == 0) return decode_bytes(kv_type, hd, Sq * G, Sk);
  return tile_layout(hd, es_of(kv_type), Sk).bytes;
}

// kv_type: 0 f32, 1 bf16, 2 int8. q_offset / kv_valid: [B] int32 or null,
// then q_off0 / valid0 hold for every row. segments (with q_seg): the tile
// grid's blocks beyond ceil(Sq / 16), at least the runs of equal q ids a
// row holds for one block a plan block (any value >= 0 is correct). schedule 1 (tile) takes any hd in
// 1..256 and any alignment; schedule 0 (decode) needs hd = 128 or 256, Sq x
// H/KVH <= 4 and 16-byte aligned q, k, v, out. Anything else is refused
// with cudaErrorInvalidValue.
extern "C" int lm_attention_launch(
    const float* q, const void* k, const void* v, int kv_type, const float* k_scale,
    const float* v_scale, const int* q_offset, const int* kv_valid, const int* q_seg,
    const int* kv_seg, float* out, int B, int Sq, int Sk, int H, int KVH, int hd,
    int q_off0, int valid0, int causal, int quant_bits, int local_window,
    float logit_softcap, float sqrt_hd, int schedule, int segments, cudaStream_t stream) {
  if (hd < 1 || hd > TL_MAX_HD || KVH < 1 || H % KVH != 0 || kv_type < KV_F32 ||
      kv_type > KV_I8 || (schedule != 0 && schedule != 1) || segments < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
                   hd % 4 == 0 && (hd * es_of(kv_type)) % 16 == 0;
  if (schedule == 0 && ((hd != 8 * NT_128 && hd != 8 * NT_256) || Sq * (H / KVH) > DEC_RMAX ||
                        !vec))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  const Args a{q, k, v, k_scale, v_scale, q_offset, kv_valid, q_seg, kv_seg, out,
               B, Sq, Sk, H, KVH, hd, q_off0, valid0, causal, quant_bits,
               local_window, logit_softcap, sqrt_hd, vec ? 1 : 0};
  cudaError_t err;
  switch (kv_type) {
    case KV_F32: err = launch_q<KV_F32>(a, schedule, segments, stream); break;
    case KV_BF16: err = launch_q<KV_BF16>(a, schedule, segments, stream); break;
    default: err = launch_q<KV_I8>(a, schedule, segments, stream); break;
  }
  return static_cast<int>(err);
}
