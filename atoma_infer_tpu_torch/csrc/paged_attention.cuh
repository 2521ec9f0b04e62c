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
// paged_attention_int8.cu; paged_attention_fp8.cu; at widths 96 and 256
// paged_attention{,_int8,_fp8}_wide.cu; at 512 *_w512.cu) is its own
// library, so they build in parallel; the fused kernel's entry of the
// narrow and wide ones is a source of its own (*_fused.cu).
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
// Bound: a decode row does ~2 flops per cache byte read, far below the
// H100's 295 flops/byte balance point, so the fused kernel's floor is the
// K/V bytes over 3.35 TB/s (a 1-byte cache halves it); a prefill chunk reuses
// each key for a whole query tile and is bound by operations. bf16 queries
// take the tensor-core ragged kernel of paged_attention_mma.cuh (mma.sync,
// a cp.async page ring, split-KV across blocks); rpa_kernel here is the f32
// queries' route. What the designs here do:
//  * A stages a tile of gcd(block_size, 32) keys (16 at D = 256) of one
//    page, its kv head's K and V, in shared memory (widened to f32 once;
//    INT8 multiplied by its
//    slot's scale there, which is exact and is the plain version's
//    dequantization) and reuses it for every query of its tile and all G
//    query heads of the group (GQA), so each page is read from device
//    memory once per (tile, kv head) instead of once per query row. Any
//    block size that is a multiple of 8 runs.
//  * B is instantiated for G = 1 to 8 query heads per kv head, and once
//    more for groups of 9 to 16 (G = kFusedWideGroup, the group passed at
//    run time; f32 queries only, the route that reaches it).
//  * B splits one (sequence, kv head)'s keys over 4 warps, one key per lane,
//    so a decode token's G query heads share every K/V load, and combines
//    the warps' partial softmax states at the end (split-KV inside a block).
//    Its P·V loop takes each key's V row from the lane that scored it and
//    keeps 8 rows' loads in flight: at decode sizes memory latency, not
//    bandwidth, is what a block waits on. INT8 folds the scales as the TPU
//    kernel does: scores dot * k_scale, and p * v_scale before P·V.
// The page loops stop at the last position a tile can see: block_tables rows
// hold garbage past a sequence's length. B here is the f32 queries' route:
// bf16 queries take fused_split_kernel (fused_decode_split.cuh: split-KV
// across blocks, Q·Kᵀ and P·V on the tensor cores).
//
// Head dims. Every kernel takes any head dim from 1 up at run time
// (head_dim), as FlashAttention-2 takes its own: a kernel is instantiated at
// a width D of 32, 64, 96, 128, 256 or 512 (instance_dim: the smallest that
// holds the head dim). A head dim below its width runs the kernel's PAD
// instantiation, one a width (here: key tiles of 8, and the fused kernel's
// run-time group; at 512 only the PAD one), strided by head_dim: what it
// stages (Q, K, V) has the columns from head_dim to D zero-filled, so the
// padded columns add nothing to Q·Kᵀ, and the padded output columns are
// computed and never stored; its copies are as wide as a head's bytes allow
// (copy_width: 16, 8, 4, 2 or 1 bytes; every head's K and V start at a
// multiple of its bytes from the 16-byte aligned cache, so an odd head dim
// of a 1-byte cache is copied byte by byte). Q and the output are read and
// written element by element there. The other instantiations run the code
// they ran before, with D for head_dim. Past 512 the width 512's PAD
// instantiations take column slices (column_slices: ceil(head_dim / 512),
// one more grid index): a block owns 512 of the output's columns, takes each
// key's whole Q·Kᵀ over the head dim (rpa_kernel stages K 512 columns at a
// time, each chunk's Q read anew; fused_decode_kernel reads Q from device
// memory, its shared q_s holding the slice's sums only), and
// stages, reads and stores only its own columns of V and the output. Every
// slice sums the same scores in the same order, so their softmax states
// agree and nothing crosses slices. The fused kernel's slices store their
// own columns of the new K and V rows; the new key's K, whose other columns
// another block stores, comes from k_new encoded and decoded as the cache
// holds it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_quant.cuh"

namespace atoma {

constexpr float kNegInf = -INFINITY;

// The widths a source instantiates: the narrow ones (32, 64, 128: head
// dims 1 to 64 and 97 to 128), the wide ones (96 and 256: head dims 65 to
// 96, Phi-3-mini's, and 129 to 256, Gemma-2's), both, or the width 512
// (head dims past 256); the wide ones of the slower builds and the width
// 512 sit in sources of their own (*_wide.cu, *_w512*.cu), which build in
// parallel with the rest.
enum HeadDimSet { kNarrowDims = 1, kWideDims = 2, kAllDims = 3, kW512Dims = 4 };

// The instantiation width of a head dim: the smallest width a kernel is
// built at (32, 64, 96, 128, 256 or 512) that holds it, and 512 past it
// (the width-512 kernels then take column_slices of 512 columns); 0 for a
// head dim no kernel takes (under 1).
__host__ __device__ constexpr int instance_dim(int head_dim) {
  return head_dim < 1       ? 0
         : head_dim <= 32  ? 32
         : head_dim <= 64  ? 64
         : head_dim <= 96  ? 96
         : head_dim <= 128 ? 128
         : head_dim <= 256 ? 256
                           : 512;
}

// The column slices a width-512 kernel cuts a head dim into, a block each:
// ceil(head_dim / 512), one up to 512.
__host__ __device__ constexpr int column_slices(int head_dim) {
  return head_dim <= 512 ? 1 : (head_dim + 511) / 512;
}

// A head dim known when compiling, converting to int on the device, for
// code written once for it and for the head dim of a run (an int).
template <int D>
struct FixedDim {
  __host__ __device__ constexpr operator int() const { return D; }
};

// The widest copy (16, 8, 4, 2 or 1 bytes) that divides a head's bytes: the
// alignment of every head's K, V, Q and output row in tensors whose base is
// 16-byte aligned.
__host__ __device__ constexpr int copy_width(int head_bytes) {
  return head_bytes % 16 == 0 ? 16
         : head_bytes % 8 == 0 ? 8
         : head_bytes % 4 == 0 ? 4
         : head_bytes % 2 == 0 ? 2
                               : 1;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
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

// load16 at a padded head dim: the first n elements (0 to Vec<T>::N) read
// in pieces of w bytes (16, 8, 4, 2 or 1: w divides their bytes and p's
// alignment), the rest 0. Nothing is read when n is 0.
template <typename T>
__device__ __forceinline__ void load16_padded(const T* p, float* out, int n, int w) {
  uint32_t raw[4] = {0u, 0u, 0u, 0u};
  const char* b = reinterpret_cast<const char*>(p);
  const int nbytes = n * (int)sizeof(T);
  if (w == 16) {
    if (nbytes > 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(b);
      raw[0] = v.x, raw[1] = v.y, raw[2] = v.z, raw[3] = v.w;
    }
  } else if (w == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (8 * i < nbytes) {
        const uint2 v = *reinterpret_cast<const uint2*>(b + 8 * i);
        raw[2 * i] = v.x, raw[2 * i + 1] = v.y;
      }
  } else if (w == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * i < nbytes) raw[i] = *reinterpret_cast<const uint32_t*>(b + 4 * i);
  } else if (w == 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (2 * i < nbytes)
        raw[i / 2] |= (uint32_t)*reinterpret_cast<const uint16_t*>(b + 2 * i) << (16 * (i % 2));
  } else {  // an odd head of a 1-byte cache
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nbytes) raw[i / 4] |= (uint32_t)(uint8_t)b[i] << (8 * (i % 4));
  }
  const T* e = reinterpret_cast<const T*>(raw);
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
// Kernel A: one block per (query tile of block_q tokens, sequence, kv head,
// slice of the group). A slice is group_rows of the group's q heads: the
// whole group while a token's group_rows · TPR threads fit a block of 256;
// past that (33+ q heads per kv head at D = 256, 65+ at 96 and 128) the
// group is cut into ceil(group · TPR / 256) slices of near-equal size, each
// a block of its own that stages the same keys (every row's sums are the
// same as in one block: a row's arithmetic never crosses rows).
// Thread layout: TPR consecutive threads own one query row (token, q head of
// the slice), DPT = D / TPR consecutive dims each; rows are token-major
// within the tile. TPR is a power of two (1, 2, 4 or 8), so a row's threads
// sit in one warp, aligned, and the xor butterfly over them stays inside the
// row: D / 32 threads of 32 dims, except at D = 96, where 3 threads a row
// would straddle warps and pair across rows, so 4 threads take 24 dims each.
// Keys are staged KT at a time, KT = gcd(block_size, 32) (16 at D = 256,
// whose 32-key tile would take 66 KB of static shared memory; 8 at a padded
// head dim, and so at D = 512, 16 threads of 32 dims a row, 33 KB): a key
// tile never straddles a page, any block size that is a multiple of 8 runs,
// and shared memory stays at 2 KT TPR (DPT + 1) floats.
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int rpa_threads_per_row(int d) { return d == 96 ? 4 : d / 32; }

template <typename T, typename C, int D, int KT, bool PAD = false>
__global__ void __launch_bounds__(256) rpa_kernel(
    const T* __restrict__ q, const C* __restrict__ cache,
    const __nv_bfloat16* __restrict__ scales,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    const int* __restrict__ query_start_loc, const int* __restrict__ num_seqs,
    const float* __restrict__ alibi, T* __restrict__ out, int num_q_heads,
    int num_kv_heads, int head_dim, int max_pages, int block_size, int group, int group_rows,
    int block_q, float scale, int window, float soft_cap) {
  constexpr int TPR = rpa_threads_per_row(D);
  constexpr int DPT = D / TPR;         // dims a thread
  constexpr int KS = TPR * (DPT + 1);  // smem floats per key row; +1 pad per thread's dims
  constexpr int VN = Vec<C>::N;
  constexpr int QN = Vec<T>::N;
  __shared__ float ks[KT * KS];
  __shared__ float vs[KT * KS];

  const int s = blockIdx.y;
  if (s >= num_seqs[0]) return;
  const int q_start = query_start_loc[s];
  const int q_len = query_start_loc[s + 1] - q_start;
  const int tok0 = blockIdx.x * block_q;
  if (tok0 >= q_len) return;
  const int slices = (group + group_rows - 1) / group_rows;
  // The width 512's PAD instantiation past 512: blockIdx.z also counts the
  // column slice cs (the innermost), whose output columns cs·D .. cs·D + D
  // the block owns.
  constexpr bool kCols = PAD && D == 512;
  const int ncs = kCols ? column_slices(head_dim) : 1;
  const int zz = blockIdx.z / ncs, cs = blockIdx.z - zz * ncs;
  const int h = zz / slices;
  const int g0 = (zz - h * slices) * group_rows;
  const int seq_len = seq_lens[s];
  const int ntok = min(block_q, q_len - tok0);
  const int ctx0 = seq_len - q_len;  // absolute position of the chunk's first query

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int ti = row / group_rows, g = g0 + row - ti * group_rows;
  // Rows past the tile or the group compute on zeros (they join the block's
  // barriers and shuffles) but never store.
  const bool active = ti < ntok && g < group;
  const int qpos = ctx0 + tok0 + ti;
  const int hq = h * group + g;
  const float slope = alibi != nullptr && active ? alibi[hq] : 0.f;
  const long long q_row = (long long)(q_start + tok0 + ti) * num_q_heads + hq;
  // PAD, a padded head dim (head_dim < D): dims past head_dim staged as 0,
  // copies as wide as a head's bytes allow.
  const int hd = PAD ? head_dim : D;
  const int cw = copy_width(hd * (int)sizeof(C));

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; i += QN) {
    if constexpr (PAD) {  // once a block: element by element, 0 past hd
#pragma unroll
      for (int k = 0; k < QN; ++k) {
        const int d = part * DPT + i + k;
        qr[i + k] = active && d < hd ? to_float(q[q_row * hd + d]) : 0.f;
      }
    } else if (active) {
      load16(q + q_row * D + part * DPT + i, qr + i);
    } else {
#pragma unroll
      for (int k = 0; k < QN; ++k) qr[i + k] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int last_pos = ctx0 + tok0 + ntok - 1;
  const int kv_begin = window > 0 ? max(0, ctx0 + tok0 - window + 1) : 0;
  const int tiles_per_page = block_size / KT;
  const int t_end = min((last_pos + KT) / KT, max_pages * tiles_per_page);
  const long long row_stride = 2LL * num_kv_heads * hd;

  // A key tile's scores (dot[j]: this thread's part of key t·KT + j's
  // Q·Kᵀ), summed over the row's threads, through the modifiers and the
  // mask into the online softmax, then P·V from the V rows staged in vs.
  auto absorb = [&](int t, const float (&dot)[KT]) {
    float sc[KT];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float d = dot[j];
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      const int kpos = t * KT + j;
      const bool ok = kpos <= qpos && (window <= 0 || kpos > qpos - window);
      sc[j] = ok ? score_mod(d, scale, soft_cap, slope, kpos, qpos) : kNegInf;
      mx = fmaxf(mx, sc[j]);
    }
    const float m_new = fmaxf(m, mx);
    if (m_new != kNegInf) {
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float pj = expf(sc[j] - m_new);
        l += pj;
        const float* vr = vs + j * KS + part * (DPT + 1);
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(pj, vr[i], acc[i]);
      }
      m = m_new;
    }
  };

  // Each key tile: K in chunks of D columns (ncs of them in a column slice
  // past 512, each chunk's Q dims read anew; one otherwise), the scores
  // summed over the whole head, then V's columns cs·D .. cs·D + D (staged
  // with the last K chunk) for P·V.
  auto stage_half = [&](const C* base, long long slot0, int v, int col0, float* dst) {
    for (int c = tid; c < KT * D / VN; c += blockDim.x) {
      const int e = c * VN;
      const int r = e / D, dcol = e - r * D;
      const C* src = base + r * row_stride + v * hd + col0 + dcol;
      float tmp[VN];
      if constexpr (PAD) {
        // The head's dims from its K or V row (V starting hd elements
        // after K), 0 past hd.
        load16_padded(src, tmp, min(VN, max(0, hd - col0 - dcol)), cw);
      } else {
        load16(src, tmp);
      }
      if constexpr (kScaled<C>) {
        const float sc = slot_scale(scales, slot0 + r, v);
#pragma unroll
        for (int k = 0; k < VN; ++k) tmp[k] *= sc;
      }
#pragma unroll
      for (int k = 0; k < VN; ++k)
        dst[r * KS + (dcol + k) / DPT * (DPT + 1) + (dcol + k) % DPT] = tmp[k];
    }
  };
  for (int t = kv_begin / KT; t < t_end; ++t) {
    const int p = t / tiles_per_page;
    const long long slot0 =
        (long long)block_tables[(long long)s * max_pages + p] * block_size +
        (t - p * tiles_per_page) * KT;
    const C* base = cache + slot0 * row_stride + (long long)h * 2 * hd;
    float dot[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) dot[j] = 0.f;
    for (int c = 0; c < ncs; ++c) {
      __syncthreads();  // the previous chunk (and key tile) fully consumed
      stage_half(base, slot0, 0, c * D, ks);
      if (c == ncs - 1) stage_half(base, slot0, 1, cs * D, vs);
      if (ncs > 1) {
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          const int d = c * D + part * DPT + i;
          qr[i] = active && d < hd ? to_float(q[q_row * hd + d]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float* kr = ks + j * KS + part * (DPT + 1);
#pragma unroll
        for (int i = 0; i < DPT; ++i) dot[j] = fmaf(qr[i], kr[i], dot[j]);
      }
    }
    absorb(t, dot);
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int c0 = cs * D;  // the slice's first column (0 but past 512)
    T* op = out + q_row * hd + c0 + part * DPT;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (!PAD || c0 + part * DPT + i < hd) op[i] = from_float<T>(acc[i] * inv);
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
// The G of the instantiation for groups of 9 to 16, passed at run time.
constexpr int kFusedWideGroup = 16;

template <typename T, typename C, int D, int G, bool PAD = false>
__global__ void __launch_bounds__(kDecodeWarps * 32) fused_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, C* cache, __nv_bfloat16* scales,
    const int* __restrict__ slot_mapping, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, const int* __restrict__ query_start_loc,
    const int* __restrict__ num_seqs, const float* __restrict__ alibi,
    T* __restrict__ out, int num_kv_heads, int head_dim, int max_pages, int block_size,
    long long num_slots, float scale, int window, float soft_cap, int group) {
  static_assert(G <= 8 || G == kFusedWideGroup, "groups 1 to 8, or 9 to 16 at run time");
  constexpr int NW = kDecodeWarps;
  constexpr int DPL = D / 32;  // output dims per lane
  constexpr int VN = Vec<C>::N;
  // Query heads a kv head: G, or the run-time group (9 to 16). Per-head
  // loops run to G and skip heads past ng (a block-uniform test).
  const int ng = G == kFusedWideGroup ? group : G;
  // Loops over the heads unroll, their states in registers; the padded
  // instantiation (PAD, f32 queries' test-size route) keeps them rolled,
  // its states in local memory, to stay small to build.
  constexpr int GU = PAD ? 1 : G;
  __shared__ float q_s[G * D];
  __shared__ float m_s[NW][G];
  __shared__ float l_s[NW][G];
  // One [G][D] sum that the warps add their weighted partials into in turn:
  // at G = 16 and D = 256 all four partials would pass the 48 KB of static
  // shared memory. At D = 512 it is q_s itself, which the key loop is done
  // with by then (the two apart would pass it too).
  constexpr bool kAccInQ = D > 256;
  __shared__ float acc_own[kAccInQ ? 1 : G * D];
  float* const acc_s = kAccInQ ? q_s : acc_own;  // [G][D]
  __shared__ float red_s[2 * NW];

  // The width 512's PAD instantiation past 512: blockIdx.y also counts the
  // column slice cs (the innermost), whose columns c0 .. c0 + D of V and
  // of the output the block owns (c0 = cs·D); Q is then read from device
  // memory, q_s holding the slice's sums only.
  constexpr bool kCols = PAD && D == 512;
  const int ncs = kCols ? column_slices(head_dim) : 1;
  const int s = blockIdx.x, h = blockIdx.y / ncs, cs = blockIdx.y - h * ncs;
  const int c0 = cs * D;
  if (s >= num_seqs[0]) return;
  const int t = query_start_loc[s];
  if (query_start_loc[s + 1] - t != 1) return;  // decode: one query token
  const int num_q_heads = num_kv_heads * ng;
  const int seq_len = seq_lens[s];
  const int pos = seq_len - 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // PAD, a padded head dim (head_dim < D): q_s holds 0 past head_dim and
  // the K and V rows are read only up to it.
  const int hd = PAD ? head_dim : D;
  const bool sliced = kCols && hd > D;
  const int cw = copy_width(hd * (int)sizeof(C));
  const long long row_stride = 2LL * num_kv_heads * hd;
  const T* kn_row = k_new + (long long)t * num_kv_heads * hd;
  const T* vn_row = v_new + (long long)t * num_kv_heads * hd;
  const T* kn = kn_row + (long long)h * hd;
  const T* vn = vn_row + (long long)h * hd;
  const long long q_base = ((long long)t * num_q_heads + (long long)h * ng) * hd;

  if (!sliced) {
    for (int i = tid; i < ng * D; i += blockDim.x) {
      if constexpr (PAD) {
        const int g = i / D, d = i - g * D;
        q_s[i] = d < hd ? to_float(q[q_base + g * hd + d]) : 0.f;
      } else {
        q_s[i] = to_float(q[q_base + i]);
      }
    }
  }
  const long long slot = slot_mapping[t];
  const bool write = slot >= 0 && slot < num_slots;
  float k_sc = 1.f, v_sc = 1.f, inv_k = 1.f, inv_v = 1.f;
  if constexpr (kScaled<C>) {
    float mk, mv;
    row_absmax(kn_row, vn_row, num_kv_heads * hd, red_s, mk, mv);
    const __nv_bfloat16 bk = kv_scale(mk), bv = kv_scale(mv);
    k_sc = __bfloat162float(bk);
    v_sc = __bfloat162float(bv);
    inv_k = 1.f / k_sc;
    inv_v = 1.f / v_sc;
    if (write && h == 0 && cs == 0 && tid == 0) {
      scales[2 * slot] = bk;
      scales[2 * slot + 1] = bv;
    }
  }
  if (write) {
    // This slice's columns of the head's new K and V (all of them but
    // past 512).
    const int w = min(D, hd - c0);
    C* dst = cache + slot * row_stride + (long long)h * 2 * hd + c0;
    for (int i = tid; i < 2 * w; i += blockDim.x) {
      if (i < w)
        dst[i] = encode<C>(to_float(kn[c0 + i]), inv_k);
      else
        dst[hd + i - w] = encode<C>(to_float(vn[c0 + i - w]), inv_v);
    }
  }
  __syncthreads();  // q_s staged; this head's slice of the new row stored

  float m[G], l[G], slope[G], acc[G][DPL];
#pragma unroll (GU)
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    slope[g] = alibi != nullptr && g < ng ? alibi[h * ng + g] : 0.f;
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
      kr = cache + kslot * row_stride + (long long)h * 2 * hd;
      if constexpr (kScaled<C>) {
        ksc = kpos == pos ? k_sc : slot_scale(scales, kslot, 0);
        vsc = kpos == pos ? v_sc : slot_scale(scales, kslot, 1);
      }
    }
    // The same key's V row follows the K half of the head's slice. Lanes
    // past the sequence take lane 0's row (lane 0's key is always valid,
    // so the row holds finite values) and carry p = 0.
    unsigned long long vaddr = reinterpret_cast<unsigned long long>(kr + hd);
    const unsigned long long v0 = __shfl_sync(0xffffffffu, vaddr, 0);
    if (!valid) vaddr = v0;
    float dot[G];
#pragma unroll (GU)
    for (int g = 0; g < G; ++g) dot[g] = 0.f;
    if constexpr (!PAD) {
      if (valid) {
#pragma unroll
        for (int d0 = 0; d0 < D; d0 += VN) {
          float kv[VN];
          load16(kr + d0, kv);
#pragma unroll (GU)
          for (int g = 0; g < G; ++g)
            if (g < ng)
#pragma unroll
              for (int i = 0; i < VN; ++i)
                dot[g] = fmaf(q_s[g * D + d0 + i], kv[i], dot[g]);
        }
      }
    } else if (valid) {
      // The head's vectors only, a loop of its own. A column slice past 512
      // takes the whole head's Q·Kᵀ with Q from device memory (q_s holds
      // the slice's sums only), and the new key's K from k_new, encoded and
      // decoded as the cache holds it (other slices' blocks store its other
      // columns).
      const bool mine = sliced && write && kpos == pos;
#pragma unroll 1
      for (int d0 = 0; d0 < hd; d0 += VN) {
        float kv[VN];
        const int n = min(VN, hd - d0);
        if (mine) {
#pragma unroll
          for (int i = 0; i < VN; ++i)
            kv[i] = i < n ? to_float(encode<C>(to_float(kn[d0 + i]), inv_k)) : 0.f;
        } else {
          load16_padded(kr + d0, kv, n, cw);
        }
#pragma unroll (GU)
        for (int g = 0; g < G; ++g)
          if (g < ng)
#pragma unroll
            for (int i = 0; i < VN; ++i) {
              const float qv = !sliced ? q_s[g * D + d0 + i]
                               : i < n  ? to_float(q[q_base + g * hd + d0 + i])
                                        : 0.f;
              dot[g] = fmaf(qv, kv[i], dot[g]);
            }
      }
    }
    float p[G], pv[G];
#pragma unroll (GU)
    for (int g = 0; g < G; ++g) {
      if (g >= ng) {
        pv[g] = 0.f;
        continue;
      }
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
    // The padded instantiation keeps the loop rolled, to stay small.
#pragma unroll (PAD ? 1 : 32 / kPvUnroll)
    for (int j0 = 0; j0 < 32; j0 += kPvUnroll) {
      float v[kPvUnroll][DPL];
#pragma unroll
      for (int u = 0; u < kPvUnroll; ++u) {
        const C* vr = reinterpret_cast<const C*>(__shfl_sync(0xffffffffu, vaddr, j0 + u));
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          const int col = c0 + lane + dd * 32;
          v[u][dd] = !PAD || col < hd ? to_float(vr[col]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kPvUnroll; ++u) {
#pragma unroll (GU)
        for (int g = 0; g < G; ++g) {
          if (g >= ng) continue;
          const float pj = __shfl_sync(0xffffffffu, pv[g], j0 + u);
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) acc[g][dd] = fmaf(pj, v[u][dd], acc[g][dd]);
        }
      }
    }
  }

  // Combine the warps' partial (max, sum, accumulator) states: each warp's
  // weight exp(m_w - max) from the maxima in shared memory, then the warps
  // add their weighted accumulators into acc_s in warp order.
#pragma unroll (GU)
  for (int g = 0; g < G; ++g) {
    if (g < ng && lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll (GU)
  for (int g = 0; g < G; ++g) {
    if (g >= ng) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w][g]);
    const float c = m[g] == kNegInf ? 0.f : expf(m[g] - mx);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[g][dd] *= c;
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    if (warp == w) {
#pragma unroll (GU)
      for (int g = 0; g < G; ++g) {
        if (g >= ng) continue;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          float& a = acc_s[g * D + lane + dd * 32];
          a = w == 0 ? acc[g][dd] : a + acc[g][dd];
        }
      }
    }
    __syncthreads();
  }
  // The output, head_dim dims a head (the constant D but at PAD; a column
  // slice's own columns past 512).
  auto store = [&](auto width) {
    const int W = width;
    for (int i = tid; i < ng * W; i += blockDim.x) {
      const int g = i / W, d = i - g * W;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w][g]);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        sum += m_s[w][g] == kNegInf ? 0.f : l_s[w][g] * expf(m_s[w][g] - mx);
      out[q_base + (long long)g * hd + c0 + d] =
          from_float<T>(sum > 0.f ? acc_s[g * D + d] / sum : 0.f);
    }
  };
  if constexpr (PAD) {
    store(min(D, hd - c0));
  } else {
    store(FixedDim<D>{});
  }
}

// --------------------------------------------------------------- dispatch
template <typename T, typename C, int D, bool PAD>
int launch_rpa(int block_size, dim3 grid, int threads, cudaStream_t stream,
               const void* q, const void* cache, const void* scales,
               const int* bt, const int* sl, const int* qsl, const int* ns,
               const float* alibi, void* out, int hq, int hk, int head_dim, int max_pages,
               int group, int group_rows, int block_q, float scale, int window,
               float soft_cap) {
#define ATOMA_RPA(KT)                                                          \
  rpa_kernel<T, C, D, KT, PAD><<<grid, threads, 0, stream>>>(                  \
      (const T*)q, (const C*)cache, (const __nv_bfloat16*)scales, bt, sl, qsl, \
      ns, alibi, (T*)out, hq, hk, head_dim, max_pages, block_size, group,      \
      group_rows, block_q, scale, window, soft_cap)
  // The key tile: gcd(block_size, 32), or gcd(block_size, 16) at D = 256;
  // at a padded head dim 8, one instantiation for every block size.
  if (block_size <= 0 || block_size % 8 != 0) return (int)cudaErrorInvalidValue;
  if constexpr (PAD) {
    ATOMA_RPA(8);
  } else if (D <= 128 && block_size % 32 == 0) {
    if constexpr (D <= 128) ATOMA_RPA(32);
  } else if (block_size % 16 == 0) {
    ATOMA_RPA(16);
  } else {
    ATOMA_RPA(8);
  }
#undef ATOMA_RPA
  return (int)cudaGetLastError();
}

template <typename T, typename C, int D, bool PAD>
int launch_fused(int group, dim3 grid, cudaStream_t stream, const void* q,
                 const void* k_new, const void* v_new, void* cache, void* scales,
                 const int* slots, const int* bt, const int* sl, const int* qsl,
                 const int* ns, const float* alibi, void* out, int hk, int head_dim,
                 int max_pages, int block_size, long long num_slots,
                 float scale, int window, float soft_cap) {
#define ATOMA_FUSED(G)                                                        \
  fused_decode_kernel<T, C, D, G, PAD><<<grid, kDecodeWarps * 32, 0, stream>>>( \
      (const T*)q, (const T*)k_new, (const T*)v_new, (C*)cache,               \
      (__nv_bfloat16*)scales, slots, bt, sl, qsl, ns, alibi, (T*)out, hk,     \
      head_dim, max_pages, block_size, num_slots, scale, window, soft_cap, group)
  if constexpr (PAD) {
    // A padded head dim: the instantiation that takes the group (1 to 16)
    // at run time.
    if (group < 1 || group > kFusedWideGroup) return (int)cudaErrorInvalidValue;
    ATOMA_FUSED(kFusedWideGroup);
  } else {
    switch (group) {
      case 1: ATOMA_FUSED(1); break;
      case 2: ATOMA_FUSED(2); break;
      case 3: ATOMA_FUSED(3); break;
      case 4: ATOMA_FUSED(4); break;
      case 5: ATOMA_FUSED(5); break;
      case 6: ATOMA_FUSED(6); break;
      case 7: ATOMA_FUSED(7); break;
      case 8: ATOMA_FUSED(8); break;
      default:
        // Groups of 9 to 16: f32 queries only (bf16 ones take the split
        // kernel; this kernel's bf16 form is only timed beside it).
        if constexpr (sizeof(T) == 4) {
          if (group > 8 && group <= kFusedWideGroup) {
            ATOMA_FUSED(kFusedWideGroup);
            break;
          }
        }
        return (int)cudaErrorInvalidValue;
    }
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

// dtype (of q, k_new/v_new and out): 0 = float32 (head dims at widths 32,
// 64 and 128 of kNarrowDims, at 96 and 256 of kWideDims, at 512 of
// kW512Dims, and past 512 in column slices), 1 = bfloat16 (widths 32, 64,
// 128; bf16 queries take the tensor cores, and chip_smoke.py times this
// route beside them). Any head_dim from 1 up runs on the width
// instance_dim(head_dim). Pointers:
// q [T, Hq, D], cache [pages, block_size, 2*Hk*D], scales [pages,
// block_size, 2] bf16 (INT8 caches; else null), block_tables [S, max_pages],
// seq_lens [S], query_start_loc [S+1], num_seqs [1] (all int32), alibi [Hq]
// f32 or null, out [T, Hq, D]. window <= 0 and soft_cap <= 0 mean "off".
template <template <typename> class CacheOf, int DIMS>
int ragged_paged_attention_entry(
    int dtype, const void* q, const void* cache, const void* scales,
    const void* block_tables, const void* seq_lens, const void* query_start_loc,
    const void* num_seqs, const void* alibi, void* out, int num_seq_slots,
    int num_q_heads, int num_kv_heads, int head_dim, int max_pages,
    int block_size, int max_q_len, float scale, int window, float soft_cap,
    void* stream) {
  if (max_q_len <= 0 || num_seq_slots <= 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0) return (int)cudaErrorInvalidValue;
  const int group = num_q_heads / num_kv_heads;
  const int dp = instance_dim(head_dim);
  if (dp == 0) return (int)cudaErrorInvalidValue;
  const int tpr = rpa_threads_per_row(dp);
  // A block takes a slice of group_rows q heads: the whole group while one
  // token's rows fit 256 threads, else the fewest near-equal slices that do.
  const int cut = (group * tpr + 255) / 256;
  const int group_rows = (group + cut - 1) / cut;
  const int slices = (group + group_rows - 1) / group_rows;  // as the kernel counts them
  int block_q = 256 / (group_rows * tpr);
  block_q = block_q < 1 ? 1 : (block_q > 16 ? 16 : block_q);
  const int threads = (block_q * group_rows * tpr + 31) / 32 * 32;
  if (threads > 256) return (int)cudaErrorInvalidValue;
  // Past 512 the width 512 also cuts the columns into column_slices, a
  // block each (the innermost of grid.z).
  const dim3 grid((max_q_len + block_q - 1) / block_q, num_seq_slots,
                  num_kv_heads * slices * column_slices(head_dim));
  cudaStream_t st = (cudaStream_t)stream;
  const int* bt = (const int*)block_tables;
  const int* sl = (const int*)seq_lens;
  const int* qsl = (const int*)query_start_loc;
  const int* ns = (const int*)num_seqs;
  const float* al = (const float*)alibi;
  const bool pad = head_dim != dp;  // f32 queries only (bf16 take the tensor cores)
#define ATOMA_RPA_D(T, D)                                                      \
  return pad ? launch_rpa<T, typename CacheOf<T>::type, D, true>(              \
      block_size, grid, threads, st, q, cache, scales, bt, sl, qsl, ns, al,    \
      out, num_q_heads, num_kv_heads, head_dim, max_pages, group, group_rows,  \
      block_q, scale, window, soft_cap)                                        \
             : launch_rpa<T, typename CacheOf<T>::type, D, false>(             \
      block_size, grid, threads, st, q, cache, scales, bt, sl, qsl, ns, al,    \
      out, num_q_heads, num_kv_heads, head_dim, max_pages, group, group_rows,  \
      block_q, scale, window, soft_cap)
  // bf16 queries on the CUDA cores (timed beside the tensor cores, never
  // routed) at the widths' own head dims only.
#define ATOMA_RPA_BF16(D)                                                      \
  return launch_rpa<__nv_bfloat16, typename CacheOf<__nv_bfloat16>::type, D, false>( \
      block_size, grid, threads, st, q, cache, scales, bt, sl, qsl, ns, al,    \
      out, num_q_heads, num_kv_heads, head_dim, max_pages, group, group_rows,  \
      block_q, scale, window, soft_cap)
  if constexpr ((DIMS & kNarrowDims) != 0) {
    if (dtype == 0) {
      if (dp == 32) ATOMA_RPA_D(float, 32);
      if (dp == 64) ATOMA_RPA_D(float, 64);
      if (dp == 128) ATOMA_RPA_D(float, 128);
    } else if (dtype == 1 && !pad) {
      if (dp == 32) ATOMA_RPA_BF16(32);
      if (dp == 64) ATOMA_RPA_BF16(64);
      if (dp == 128) ATOMA_RPA_BF16(128);
    }
  }
  if constexpr ((DIMS & kWideDims) != 0) {
    if (dtype == 0) {
      if (dp == 96) ATOMA_RPA_D(float, 96);
      if (dp == 256) ATOMA_RPA_D(float, 256);
    }
  }
  if constexpr ((DIMS & kW512Dims) != 0) {
    // The width 512: its PAD instantiation only, for every head dim it holds.
    if (dtype == 0 && dp == 512)
      return launch_rpa<float, typename CacheOf<float>::type, 512, true>(
          block_size, grid, threads, st, q, cache, scales, bt, sl, qsl, ns, al, out,
          num_q_heads, num_kv_heads, head_dim, max_pages, group, group_rows, block_q, scale,
          window, soft_cap);
  }
#undef ATOMA_RPA_D
#undef ATOMA_RPA_BF16
  return (int)cudaErrorInvalidValue;
}

// As above, plus k_new/v_new [T, Hk, D] and slot_mapping [T] int32; the cache
// (and an INT8 cache's scales) is written in place. Every active sequence
// must have exactly one query token.
template <template <typename> class CacheOf, int DIMS>
int fused_decode_attention_entry(
    int dtype, const void* q, const void* k_new, const void* v_new, void* cache,
    void* scales, const void* slot_mapping, const void* block_tables,
    const void* seq_lens, const void* query_start_loc, const void* num_seqs,
    const void* alibi, void* out, int num_seq_slots, int num_q_heads,
    int num_kv_heads, int head_dim, int max_pages, int block_size,
    long long num_slots, float scale, int window, float soft_cap, void* stream) {
  if (num_seq_slots <= 0) return 0;
  const int group = num_q_heads / num_kv_heads;
  const int dp = instance_dim(head_dim);
  // Past 512 the width 512 also cuts the columns into column_slices, a
  // block each (the innermost of grid.y).
  const dim3 grid(num_seq_slots, num_kv_heads * column_slices(head_dim));
  cudaStream_t st = (cudaStream_t)stream;
  const int* slots = (const int*)slot_mapping;
  const int* bt = (const int*)block_tables;
  const int* sl = (const int*)seq_lens;
  const int* qsl = (const int*)query_start_loc;
  const int* ns = (const int*)num_seqs;
  const float* al = (const float*)alibi;
  const bool pad = head_dim != dp;  // f32 queries only (bf16 take the split kernel)
#define ATOMA_FUSED_D(T, D)                                                    \
  return pad ? launch_fused<T, typename CacheOf<T>::type, D, true>(            \
      group, grid, st, q, k_new, v_new, cache, scales, slots, bt, sl, qsl, ns, \
      al, out, num_kv_heads, head_dim, max_pages, block_size, num_slots,       \
      scale, window, soft_cap)                                                 \
             : launch_fused<T, typename CacheOf<T>::type, D, false>(           \
      group, grid, st, q, k_new, v_new, cache, scales, slots, bt, sl, qsl, ns, \
      al, out, num_kv_heads, head_dim, max_pages, block_size, num_slots,       \
      scale, window, soft_cap)
#define ATOMA_FUSED_BF16(D)                                                    \
  return launch_fused<__nv_bfloat16, typename CacheOf<__nv_bfloat16>::type, D, false>( \
      group, grid, st, q, k_new, v_new, cache, scales, slots, bt, sl, qsl, ns, \
      al, out, num_kv_heads, head_dim, max_pages, block_size, num_slots,       \
      scale, window, soft_cap)
  if constexpr ((DIMS & kNarrowDims) != 0) {
    if (dtype == 0) {
      if (dp == 32) ATOMA_FUSED_D(float, 32);
      if (dp == 64) ATOMA_FUSED_D(float, 64);
      if (dp == 128) ATOMA_FUSED_D(float, 128);
    } else if (dtype == 1 && !pad) {
      if (dp == 32) ATOMA_FUSED_BF16(32);
      if (dp == 64) ATOMA_FUSED_BF16(64);
      if (dp == 128) ATOMA_FUSED_BF16(128);
    }
  }
  if constexpr ((DIMS & kWideDims) != 0) {
    if (dtype == 0) {
      if (dp == 96) ATOMA_FUSED_D(float, 96);
      if (dp == 256) ATOMA_FUSED_D(float, 256);
    }
  }
  if constexpr ((DIMS & kW512Dims) != 0) {
    if (dtype == 0 && dp == 512)
      return launch_fused<float, typename CacheOf<float>::type, 512, true>(
          group, grid, st, q, k_new, v_new, cache, scales, slots, bt, sl, qsl, ns, al, out,
          num_kv_heads, head_dim, max_pages, block_size, num_slots, scale, window, soft_cap);
  }
#undef ATOMA_FUSED_D
#undef ATOMA_FUSED_BF16
  return (int)cudaErrorInvalidValue;
}

}  // namespace atoma

// The C entry points of one cache kind at the head dims of DIMS (a
// HeadDimSet): SUFFIX names them, CACHE_OF picks the cache element type. The
// ragged (A) and the fused decode (B) entry each have a macro of their own,
// so that the slowest sources' two halves build in parallel
// (paged_attention{,_int8,_fp8}{,_wide}.cu and their *_fused.cu).
#define ATOMA_RAGGED_ATTENTION_ENTRY(SUFFIX, CACHE_OF, DIMS)                   \
  extern "C" int atoma_ragged_paged_attention##SUFFIX(                         \
      int dtype, const void* q, const void* cache, const void* scales,         \
      const void* block_tables, const void* seq_lens,                          \
      const void* query_start_loc, const void* num_seqs, const void* alibi,    \
      void* out, int num_seq_slots, int num_q_heads, int num_kv_heads,         \
      int head_dim, int max_pages, int block_size, int max_q_len, float scale, \
      int window, float soft_cap, void* stream) {                              \
    return atoma::ragged_paged_attention_entry<CACHE_OF, DIMS>(                \
        dtype, q, cache, scales, block_tables, seq_lens, query_start_loc,      \
        num_seqs, alibi, out, num_seq_slots, num_q_heads, num_kv_heads,        \
        head_dim, max_pages, block_size, max_q_len, scale, window, soft_cap,   \
        stream);                                                               \
  }

#define ATOMA_FUSED_DECODE_ENTRY(SUFFIX, CACHE_OF, DIMS)                       \
  extern "C" int atoma_fused_decode_attention##SUFFIX(                         \
      int dtype, const void* q, const void* k_new, const void* v_new,          \
      void* cache, void* scales, const void* slot_mapping,                     \
      const void* block_tables, const void* seq_lens,                          \
      const void* query_start_loc, const void* num_seqs, const void* alibi,    \
      void* out, int num_seq_slots, int num_q_heads, int num_kv_heads,         \
      int head_dim, int max_pages, int block_size, long long num_slots,        \
      float scale, int window, float soft_cap, void* stream) {                 \
    return atoma::fused_decode_attention_entry<CACHE_OF, DIMS>(                \
        dtype, q, k_new, v_new, cache, scales, slot_mapping, block_tables,     \
        seq_lens, query_start_loc, num_seqs, alibi, out, num_seq_slots,        \
        num_q_heads, num_kv_heads, head_dim, max_pages, block_size, num_slots, \
        scale, window, soft_cap, stream);                                      \
  }

#define ATOMA_PAGED_ATTENTION_ENTRIES(SUFFIX, CACHE_OF, DIMS) \
  ATOMA_RAGGED_ATTENTION_ENTRY(SUFFIX, CACHE_OF, DIMS)        \
  ATOMA_FUSED_DECODE_ENTRY(SUFFIX, CACHE_OF, DIMS)
