// Ragged paged attention over the page-major, head-interleaved KV cache,
// and its pure-decode variant with the KV-cache write fused in, for every
// cache element type C (kv_quant.cuh): the model's dtype T, INT8 with
// per-(slot, K/V) scales, or e4m3.
//
// Replaces the TPU kernel atoma_infer_tpu/ops/paged_attention.py:_kernel,
// reached through ragged_paged_attention_pallas (fuse_write=False: kernel A
// here, rpa_kernel) and ragged_paged_attention_fused /
// ragged_paged_attention_fused_quant (fuse_write=True: kernel B here,
// fused_decode_kernel); with quant=True (INT8 + scales: kernel D) and
// fp8=True (e4m3: kernel E) the same two kernels run on a 1-byte cache.
// Each instantiating source (paged_attention.cu: C = T;
// paged_attention_int8.cu; paged_attention_fp8.cu) is its own library, so
// the three build in parallel.
//
// Cache: [num_pages, block_size, 2*Hk*D], each slot's row laid out as
// [K_h0 | V_h0 | K_h1 | V_h1 | ...]; INT8 scales: [num_pages, block_size, 2]
// bf16, K at 0 and V at 1. Query token i of sequence s (tokens
// query_start_loc[s] .. query_start_loc[s+1]) sits at absolute position
// seq_lens[s] - q_len + i and attends to positions <= its own (and inside the
// sliding window, if any), read through block_tables[s]. Scores follow the
// plain version's order: dot * scale, then soft cap, then the ALiBi bias, then
// the mask; f32 online softmax (running max, sum, accumulator).
//
// Bound: bytes. A decode step does ~2 flops per cache byte read, a mixed step
// a few times more; both sit far below the H100's 295 flops/byte balance
// point, so the floor is the K/V bytes over 3.35 TB/s, and a 1-byte cache
// halves it. What the designs do about it:
//  * A stages a tile of gcd(block_size, 32) keys of one page, its kv head's
//    K and V, in shared memory (widened to f32 once; INT8 multiplied by its
//    slot's scale there, which is exact and is the plain version's
//    dequantization) and reuses it for every query of its tile and all G
//    query heads of the group (GQA), so each page is read from device
//    memory once per (tile, kv head) instead of once per query row. Any
//    block size that is a multiple of 8 runs.
//  * B is instantiated for G = 1 to 8 query heads per kv head.
//  * B splits one (sequence, kv head)'s keys over 4 warps, one key per lane,
//    so a decode token's G query heads share every K/V load, and combines
//    the warps' partial softmax states at the end (split-KV inside a block).
//    Its P·V loop takes each key's V row from the lane that scored it and
//    keeps 8 rows' loads in flight: at decode sizes memory latency, not
//    bandwidth, is what a block waits on. INT8 folds the scales as the TPU
//    kernel does: scores dot * k_scale, and p * v_scale before P·V.
// The page loops stop at the last position a tile can see: block_tables rows
// hold garbage past a sequence's length.
//
// Not done yet (later work): tensor-core MMA, TMA/cp.async double buffering,
// split-KV across blocks for occupancy on long contexts.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace atoma {

constexpr float kNegInf = -INFINITY;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// One 16-byte load, widened to f32.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_float(e[i]);
}

__device__ __forceinline__ float score_mod(float dot, float scale,
                                           float soft_cap, float slope,
                                           int kpos, int qpos) {
  float s = dot * scale;
  if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
  if (slope != 0.f) s += slope * (float)(kpos - qpos);
  return s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The INT8 scale of one slot's K (v = 0) or V (v = 1) half.
__device__ __forceinline__ float slot_scale(const __nv_bfloat16* scales,
                                            long long slot, int v) {
  return __bfloat162float(scales[2 * slot + v]);
}

// ---------------------------------------------------------------------------
// Kernel A: one block per (query tile of block_q tokens, sequence, kv head).
// Thread layout: TPR = D/32 consecutive threads own one query row (token,
// q head of the group), 32 dims each; rows are token-major within the tile.
// Keys are staged KT at a time, KT = gcd(block_size, 32): a key tile never
// straddles a page, any block size that is a multiple of 8 runs, and shared
// memory stays at the KT = 32 figure (2 * 32 * (D/32) * 33 floats).
// ---------------------------------------------------------------------------
template <typename T, typename C, int D, int KT>
__global__ void __launch_bounds__(256) rpa_kernel(
    const T* __restrict__ q, const C* __restrict__ cache,
    const __nv_bfloat16* __restrict__ scales,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    const int* __restrict__ query_start_loc, const int* __restrict__ num_seqs,
    const float* __restrict__ alibi, T* __restrict__ out, int num_q_heads,
    int num_kv_heads, int max_pages, int block_size, int group, int block_q,
    float scale, int window, float soft_cap) {
  constexpr int TPR = D / 32;
  constexpr int KS = TPR * 33;  // smem floats per key row; +1 pad per 32 dims
  constexpr int VN = Vec<C>::N;
  constexpr int CHUNKS = KT * 2 * D / VN;  // 16-byte vectors in one key tile (K|V)
  constexpr int QN = Vec<T>::N;
  __shared__ float ks[KT * KS];
  __shared__ float vs[KT * KS];

  const int s = blockIdx.y;
  if (s >= num_seqs[0]) return;
  const int q_start = query_start_loc[s];
  const int q_len = query_start_loc[s + 1] - q_start;
  const int tok0 = blockIdx.x * block_q;
  if (tok0 >= q_len) return;
  const int h = blockIdx.z;
  const int seq_len = seq_lens[s];
  const int ntok = min(block_q, q_len - tok0);
  const int ctx0 = seq_len - q_len;  // absolute position of the chunk's first query

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int ti = row / group, g = row - ti * group;
  // Rows past the tile compute on zeros (they join the block's barriers and
  // shuffles) but never store.
  const bool active = ti < ntok;
  const int qpos = ctx0 + tok0 + ti;
  const int hq = h * group + g;
  const float slope = alibi != nullptr ? alibi[hq] : 0.f;
  const long long q_row = (long long)(q_start + tok0 + ti) * num_q_heads + hq;

  float qr[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; i += QN) {
    if (active) {
      load16(q + q_row * D + part * 32 + i, qr + i);
    } else {
#pragma unroll
      for (int k = 0; k < QN; ++k) qr[i + k] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int last_pos = ctx0 + tok0 + ntok - 1;
  const int kv_begin = window > 0 ? max(0, ctx0 + tok0 - window + 1) : 0;
  const int tiles_per_page = block_size / KT;
  const int t_end = min((last_pos + KT) / KT, max_pages * tiles_per_page);
  const long long row_stride = 2LL * num_kv_heads * D;

  for (int t = kv_begin / KT; t < t_end; ++t) {
    const int p = t / tiles_per_page;
    const long long slot0 = (long long)block_tables[(long long)s * max_pages + p] * block_size +
                            (t - p * tiles_per_page) * KT;
    const C* base = cache + slot0 * row_stride + (long long)h * 2 * D;
    __syncthreads();  // the previous key tile is fully consumed
    for (int c = tid; c < CHUNKS; c += blockDim.x) {
      const int e = c * VN;
      const int r = e / (2 * D), col = e - r * 2 * D;
      float tmp[VN];
      load16(base + r * row_stride + col, tmp);
      const bool is_v = col >= D;
      if constexpr (kScaled<C>) {
        const float sc = slot_scale(scales, slot0 + r, is_v);
#pragma unroll
        for (int k = 0; k < VN; ++k) tmp[k] *= sc;
      }
      const int dcol = is_v ? col - D : col;
      float* dst = (is_v ? vs : ks) + r * KS + (dcol / 32) * 33 + (dcol % 32);
#pragma unroll
      for (int k = 0; k < VN; ++k) dst[k] = tmp[k];
    }
    __syncthreads();

    float sc[KT];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float* kr = ks + j * KS + part * 33;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int kpos = t * KT + j;
      const bool ok = kpos <= qpos && (window <= 0 || kpos > qpos - window);
      sc[j] = ok ? score_mod(dot, scale, soft_cap, slope, kpos, qpos) : kNegInf;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m, mx);
    if (m_new != kNegInf) {
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float pj = expf(sc[j] - m_new);
        l += pj;
        const float* vr = vs + j * KS + part * 33;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = fmaf(pj, vr[i], acc[i]);
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = out + q_row * D + part * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) op[i] = from_float<T>(acc[i] * inv);
  }
}

// ---------------------------------------------------------------------------
// Kernel B: pure decode, one block per (sequence, kv head), 4 warps. Stores
// this head's slice of the new K/V row in its slot (INT8: quantized with the
// token's scales, which every block computes alike from the whole K and V
// rows and block h = 0 stores; e4m3: clipped and rounded), then attends over
// the cache, the new position included: the block reads its own slice back
// after a barrier, so the current token is attended in the cache's type,
// exactly as the plain version's write-then-attend does. A block writes only
// its own (slot, head) slice, and pages belong to one sequence, so blocks
// never race. The current slot's scales come from the block's own registers
// (block 0's store need not be visible to the others).
// ---------------------------------------------------------------------------
constexpr int kDecodeWarps = 4;
constexpr int kPvUnroll = 8;  // V rows loaded ahead of their FMAs

template <typename T, typename C, int D, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32) fused_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, C* cache, __nv_bfloat16* scales,
    const int* __restrict__ slot_mapping, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, const int* __restrict__ query_start_loc,
    const int* __restrict__ num_seqs, const float* __restrict__ alibi,
    T* __restrict__ out, int num_kv_heads, int max_pages, int block_size,
    long long num_slots, float scale, int window, float soft_cap) {
  constexpr int NW = kDecodeWarps;
  constexpr int DPL = D / 32;  // output dims per lane
  constexpr int VN = Vec<C>::N;
  __shared__ float q_s[G * D];
  __shared__ float m_s[NW][G];
  __shared__ float l_s[NW][G];
  __shared__ float acc_s[NW][G][D];
  __shared__ float red_s[2 * NW];

  const int s = blockIdx.x, h = blockIdx.y;
  if (s >= num_seqs[0]) return;
  const int t = query_start_loc[s];
  if (query_start_loc[s + 1] - t != 1) return;  // decode: one query token
  const int num_q_heads = num_kv_heads * G;
  const int seq_len = seq_lens[s];
  const int pos = seq_len - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long row_stride = 2LL * num_kv_heads * D;
  const T* kn_row = k_new + (long long)t * num_kv_heads * D;
  const T* vn_row = v_new + (long long)t * num_kv_heads * D;
  const T* kn = kn_row + (long long)h * D;
  const T* vn = vn_row + (long long)h * D;
  const long long q_base = ((long long)t * num_q_heads + (long long)h * G) * D;

  for (int i = tid; i < G * D; i += blockDim.x) q_s[i] = to_float(q[q_base + i]);
  const long long slot = slot_mapping[t];
  const bool write = slot >= 0 && slot < num_slots;
  float k_sc = 1.f, v_sc = 1.f, inv_k = 1.f, inv_v = 1.f;
  if constexpr (kScaled<C>) {
    float mk, mv;
    row_absmax(kn_row, vn_row, num_kv_heads * D, red_s, mk, mv);
    const __nv_bfloat16 bk = kv_scale(mk), bv = kv_scale(mv);
    k_sc = __bfloat162float(bk);
    v_sc = __bfloat162float(bv);
    inv_k = 1.f / k_sc;
    inv_v = 1.f / v_sc;
    if (write && h == 0 && tid == 0) {
      scales[2 * slot] = bk;
      scales[2 * slot + 1] = bv;
    }
  }
  if (write) {
    C* dst = cache + slot * row_stride + (long long)h * 2 * D;
    for (int i = tid; i < 2 * D; i += blockDim.x)
      dst[i] = i < D ? encode<C>(to_float(kn[i]), inv_k)
                     : encode<C>(to_float(vn[i - D]), inv_v);
  }
  __syncthreads();  // q_s staged; this head's slice of the new row stored

  float m[G], l[G], slope[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    slope[g] = alibi != nullptr ? alibi[h * G + g] : 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[g][dd] = 0.f;
  }

  const int kv_begin = window > 0 ? max(0, pos - window + 1) : 0;
  for (int base = kv_begin + warp * 32; base < seq_len; base += NW * 32) {
    // Scores: lane j owns key base + j.
    const int kpos = base + lane;
    const bool valid = kpos < seq_len;
    const C* kr = cache;
    float ksc = 1.f, vsc = 1.f;
    if (valid) {
      const long long kslot =
          (long long)block_tables[(long long)s * max_pages + kpos / block_size] *
              block_size + kpos % block_size;
      kr = cache + kslot * row_stride + (long long)h * 2 * D;
      if constexpr (kScaled<C>) {
        ksc = kpos == pos ? k_sc : slot_scale(scales, kslot, 0);
        vsc = kpos == pos ? v_sc : slot_scale(scales, kslot, 1);
      }
    }
    // The same key's V row follows the K half of the head's slice. Lanes
    // past the sequence take lane 0's row (lane 0's key is always valid,
    // so the row holds finite values) and carry p = 0.
    unsigned long long vaddr = reinterpret_cast<unsigned long long>(kr + D);
    const unsigned long long v0 = __shfl_sync(0xffffffffu, vaddr, 0);
    if (!valid) vaddr = v0;
    float dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) dot[g] = 0.f;
    if (valid) {
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VN) {
        float kv[VN];
        load16(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < VN; ++i)
            dot[g] = fmaf(q_s[g * D + d0 + i], kv[i], dot[g]);
      }
    }
    float p[G], pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sv = valid ? score_mod(dot[g] * ksc, scale, soft_cap, slope[g],
                                         kpos, pos)
                             : kNegInf;
      // Lane 0's key is always valid, so m_new is finite.
      const float m_new = fmaxf(m[g], warp_max(sv));
      const float alpha = expf(m[g] - m_new);
      p[g] = expf(sv - m_new);
      pv[g] = p[g] * vsc;
      l[g] = l[g] * alpha + warp_sum(p[g]);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[g][dd] *= alpha;
      m[g] = m_new;
    }
    // P·V: lane owns dims lane + 32*dd; the warp walks its 32 keys in
    // order, taking each key's V row pointer from its lane by a shuffle, and
    // issues kPvUnroll rows' loads before their FMAs so that many loads are
    // in flight (one key at a time leaves the warp waiting on each load).
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kPvUnroll) {
      float v[kPvUnroll][DPL];
#pragma unroll
      for (int u = 0; u < kPvUnroll; ++u) {
        const C* vr = reinterpret_cast<const C*>(__shfl_sync(0xffffffffu, vaddr, j0 + u));
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) v[u][dd] = to_float(vr[lane + dd * 32]);
      }
#pragma unroll
      for (int u = 0; u < kPvUnroll; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pj = __shfl_sync(0xffffffffu, pv[g], j0 + u);
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) acc[g][dd] = fmaf(pj, v[u][dd], acc[g][dd]);
        }
      }
    }
  }

  // Combine the warps' partial (max, sum, accumulator) states.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc_s[warp][g][lane + dd * 32] = acc[g][dd];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w][g]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = m_s[w][g] == kNegInf ? 0.f : expf(m_s[w][g] - mx);
      sum += l_s[w][g] * c;
      o += acc_s[w][g][d] * c;
    }
    out[q_base + i] = from_float<T>(sum > 0.f ? o / sum : 0.f);
  }
}

// --------------------------------------------------------------- dispatch
template <typename T, typename C, int D>
int launch_rpa(int block_size, dim3 grid, int threads, cudaStream_t stream,
               const void* q, const void* cache, const void* scales,
               const int* bt, const int* sl, const int* qsl, const int* ns,
               const float* alibi, void* out, int hq, int hk, int max_pages,
               int group, int block_q, float scale, int window, float soft_cap) {
#define ATOMA_RPA(KT)                                                          \
  rpa_kernel<T, C, D, KT><<<grid, threads, 0, stream>>>(                       \
      (const T*)q, (const C*)cache, (const __nv_bfloat16*)scales, bt, sl, qsl, \
      ns, alibi, (T*)out, hq, hk, max_pages, block_size, group, block_q,       \
      scale, window, soft_cap)
  // The key tile: gcd(block_size, 32).
  if (block_size <= 0 || block_size % 8 != 0) return (int)cudaErrorInvalidValue;
  if (block_size % 32 == 0) {
    ATOMA_RPA(32);
  } else if (block_size % 16 == 0) {
    ATOMA_RPA(16);
  } else {
    ATOMA_RPA(8);
  }
#undef ATOMA_RPA
  return (int)cudaGetLastError();
}

template <typename T, typename C, int D>
int launch_fused(int group, dim3 grid, cudaStream_t stream, const void* q,
                 const void* k_new, const void* v_new, void* cache, void* scales,
                 const int* slots, const int* bt, const int* sl, const int* qsl,
                 const int* ns, const float* alibi, void* out, int hk,
                 int max_pages, int block_size, long long num_slots,
                 float scale, int window, float soft_cap) {
#define ATOMA_FUSED(G)                                                        \
  fused_decode_kernel<T, C, D, G><<<grid, kDecodeWarps * 32, 0, stream>>>(    \
      (const T*)q, (const T*)k_new, (const T*)v_new, (C*)cache,               \
      (__nv_bfloat16*)scales, slots, bt, sl, qsl, ns, alibi, (T*)out, hk,     \
      max_pages, block_size, num_slots, scale, window, soft_cap)
  switch (group) {
    case 1: ATOMA_FUSED(1); break;
    case 2: ATOMA_FUSED(2); break;
    case 3: ATOMA_FUSED(3); break;
    case 4: ATOMA_FUSED(4); break;
    case 5: ATOMA_FUSED(5); break;
    case 6: ATOMA_FUSED(6); break;
    case 7: ATOMA_FUSED(7); break;
    case 8: ATOMA_FUSED(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ATOMA_FUSED
  return (int)cudaGetLastError();
}

// The cache element type for q's type T: CacheOf<T>::type.
template <typename T>
struct SameCache {
  using type = T;
};
template <typename T>
struct Int8Cache {
  using type = int8_t;
};
template <typename T>
struct Fp8Cache {
  using type = __nv_fp8_e4m3;
};

// dtype (of q, k_new/v_new and out): 0 = float32, 1 = bfloat16. Pointers:
// q [T, Hq, D], cache [pages, block_size, 2*Hk*D], scales [pages,
// block_size, 2] bf16 (INT8 caches; else null), block_tables [S, max_pages],
// seq_lens [S], query_start_loc [S+1], num_seqs [1] (all int32), alibi [Hq]
// f32 or null, out [T, Hq, D]. window <= 0 and soft_cap <= 0 mean "off".
template <template <typename> class CacheOf>
int ragged_paged_attention_entry(
    int dtype, const void* q, const void* cache, const void* scales,
    const void* block_tables, const void* seq_lens, const void* query_start_loc,
    const void* num_seqs, const void* alibi, void* out, int num_seq_slots,
    int num_q_heads, int num_kv_heads, int head_dim, int max_pages,
    int block_size, int max_q_len, float scale, int window, float soft_cap,
    void* stream) {
  if (max_q_len <= 0 || num_seq_slots <= 0) return 0;
  const int group = num_q_heads / num_kv_heads;
  const int tpr = head_dim / 32;
  int block_q = 256 / (group * tpr);
  block_q = block_q < 1 ? 1 : (block_q > 16 ? 16 : block_q);
  const int threads = (block_q * group * tpr + 31) / 32 * 32;
  if (threads > 256) return (int)cudaErrorInvalidValue;
  const dim3 grid((max_q_len + block_q - 1) / block_q, num_seq_slots, num_kv_heads);
  cudaStream_t st = (cudaStream_t)stream;
  const int* bt = (const int*)block_tables;
  const int* sl = (const int*)seq_lens;
  const int* qsl = (const int*)query_start_loc;
  const int* ns = (const int*)num_seqs;
  const float* al = (const float*)alibi;
#define ATOMA_RPA_D(T, D)                                                      \
  return launch_rpa<T, typename CacheOf<T>::type, D>(                          \
      block_size, grid, threads, st, q, cache, scales, bt, sl, qsl, ns, al,    \
      out, num_q_heads, num_kv_heads, max_pages, group, block_q, scale,        \
      window, soft_cap)
  if (dtype == 0) {
    if (head_dim == 32) ATOMA_RPA_D(float, 32);
    if (head_dim == 64) ATOMA_RPA_D(float, 64);
    if (head_dim == 128) ATOMA_RPA_D(float, 128);
  } else if (dtype == 1) {
    if (head_dim == 32) ATOMA_RPA_D(__nv_bfloat16, 32);
    if (head_dim == 64) ATOMA_RPA_D(__nv_bfloat16, 64);
    if (head_dim == 128) ATOMA_RPA_D(__nv_bfloat16, 128);
  }
#undef ATOMA_RPA_D
  return (int)cudaErrorInvalidValue;
}

// As above, plus k_new/v_new [T, Hk, D] and slot_mapping [T] int32; the cache
// (and an INT8 cache's scales) is written in place. Every active sequence
// must have exactly one query token.
template <template <typename> class CacheOf>
int fused_decode_attention_entry(
    int dtype, const void* q, const void* k_new, const void* v_new, void* cache,
    void* scales, const void* slot_mapping, const void* block_tables,
    const void* seq_lens, const void* query_start_loc, const void* num_seqs,
    const void* alibi, void* out, int num_seq_slots, int num_q_heads,
    int num_kv_heads, int head_dim, int max_pages, int block_size,
    long long num_slots, float scale, int window, float soft_cap, void* stream) {
  if (num_seq_slots <= 0) return 0;
  const int group = num_q_heads / num_kv_heads;
  const dim3 grid(num_seq_slots, num_kv_heads);
  cudaStream_t st = (cudaStream_t)stream;
  const int* slots = (const int*)slot_mapping;
  const int* bt = (const int*)block_tables;
  const int* sl = (const int*)seq_lens;
  const int* qsl = (const int*)query_start_loc;
  const int* ns = (const int*)num_seqs;
  const float* al = (const float*)alibi;
#define ATOMA_FUSED_D(T, D)                                                    \
  return launch_fused<T, typename CacheOf<T>::type, D>(                        \
      group, grid, st, q, k_new, v_new, cache, scales, slots, bt, sl, qsl, ns, \
      al, out, num_kv_heads, max_pages, block_size, num_slots, scale, window,  \
      soft_cap)
  if (dtype == 0) {
    if (head_dim == 32) ATOMA_FUSED_D(float, 32);
    if (head_dim == 64) ATOMA_FUSED_D(float, 64);
    if (head_dim == 128) ATOMA_FUSED_D(float, 128);
  } else if (dtype == 1) {
    if (head_dim == 32) ATOMA_FUSED_D(__nv_bfloat16, 32);
    if (head_dim == 64) ATOMA_FUSED_D(__nv_bfloat16, 64);
    if (head_dim == 128) ATOMA_FUSED_D(__nv_bfloat16, 128);
  }
#undef ATOMA_FUSED_D
  return (int)cudaErrorInvalidValue;
}

}  // namespace atoma

// The C entry points of one cache kind: SUFFIX names them, CACHE_OF picks
// the cache element type.
#define ATOMA_PAGED_ATTENTION_ENTRIES(SUFFIX, CACHE_OF)                        \
  extern "C" int atoma_ragged_paged_attention##SUFFIX(                         \
      int dtype, const void* q, const void* cache, const void* scales,         \
      const void* block_tables, const void* seq_lens,                          \
      const void* query_start_loc, const void* num_seqs, const void* alibi,    \
      void* out, int num_seq_slots, int num_q_heads, int num_kv_heads,         \
      int head_dim, int max_pages, int block_size, int max_q_len, float scale, \
      int window, float soft_cap, void* stream) {                              \
    return atoma::ragged_paged_attention_entry<CACHE_OF>(                      \
        dtype, q, cache, scales, block_tables, seq_lens, query_start_loc,      \
        num_seqs, alibi, out, num_seq_slots, num_q_heads, num_kv_heads,        \
        head_dim, max_pages, block_size, max_q_len, scale, window, soft_cap,   \
        stream);                                                               \
  }                                                                            \
  extern "C" int atoma_fused_decode_attention##SUFFIX(                         \
      int dtype, const void* q, const void* k_new, const void* v_new,          \
      void* cache, void* scales, const void* slot_mapping,                     \
      const void* block_tables, const void* seq_lens,                          \
      const void* query_start_loc, const void* num_seqs, const void* alibi,    \
      void* out, int num_seq_slots, int num_q_heads, int num_kv_heads,         \
      int head_dim, int max_pages, int block_size, long long num_slots,        \
      float scale, int window, float soft_cap, void* stream) {                 \
    return atoma::fused_decode_attention_entry<CACHE_OF>(                      \
        dtype, q, k_new, v_new, cache, scales, slot_mapping, block_tables,     \
        seq_lens, query_start_loc, num_seqs, alibi, out, num_seq_slots,        \
        num_q_heads, num_kv_heads, head_dim, max_pages, block_size, num_slots, \
        scale, window, soft_cap, stream);                                      \
  }
