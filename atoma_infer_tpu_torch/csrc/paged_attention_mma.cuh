// Kernels A, D and E for bf16 and fp16 queries on the tensor cores: ragged
// paged attention over a cache in the queries' dtype, INT8 (+ per-slot
// scales) or e4m3, the same
// function as rpa_kernel (paged_attention.cuh) and as the plain version
// (ops/paged_attention.py: ragged_paged_attention_paged_plain).
//
// Replaces the TPU kernel atoma_infer_tpu/ops/paged_attention.py:_kernel
// (:139) with fuse_write=False, reached through ragged_paged_attention_pallas
// (:1058); quant=True (INT8, scale_rows :409) and fp8=True (_e4m3_decode
// :66-85) on the 1-byte caches. Its numerics are the TPU kernel's
// (attend_chunk_fused :435-508): bf16 dots with f32 sums for Q·Kᵀ and P·V,
// raw 1-byte K and V widened to bf16 before the dots (exact for int8 and
// e4m3), an INT8 score multiplied by its key's slot scale, l summed before
// the V scale, and P times V's slot scale rounded to bf16 for P·V.
//
// Bound. A decode row reads its keys once for 4·D flops a (query head, key):
// far below the H100's 295 flops a byte, so bytes. A prefill chunk reuses
// every key for up to 128 query rows of a block: at the 8B shapes a
// 256-token chunk over 2,048 keys does ≈ 8 GFLOP on 8 MB, operations. The
// design:
//  * One block per (query tile, kv head, KV split). The query tile packs
//    (token, q head of the group) rows token-major into m16 row tiles, one a
//    warp: 16·NW rows (64 or 128), 16·NW / G tokens; the host picks NW from
//    (G, max_q_len). Padding rows compute but never store. The query tiles
//    of all sequences are laid end to end on grid x (sequence s starts at
//    query_start_loc[s] / tokens + s), so a batch of one long chunk and many
//    decode rows launches no grid of empty tiles.
//  * S = Q·Kᵀ and O += P·V on mma.sync m16n8k16 bf16 with f32 sums
//    (rpa_warp_step). Q's A fragments stay in registers for the whole key
//    loop; S and O stay in registers in the accumulator layout; the online
//    softmax (running max, sum, rescale) works on the S fragments, rows
//    reduced over the lane quad by shuffles, in f32 (exponentials by the
//    special-function unit's ex2); P is rounded to bf16 as the A fragments
//    of P·V. K's B fragments by ldmatrix, V's by ldmatrix.trans.
//  * Keys come in tiles of kRpaKT = 64 (any block size that is a multiple of
//    8; a tile may span pages), gathered slot by slot through the block
//    table into a kRpaStages-deep cp.async ring in shared memory, each
//    (slot, kv head) K|V slice copied in 16-byte pieces, rows padded by 16
//    bytes so ldmatrix meets no bank conflict. A tile's slots are read
//    from the block table two key tiles before its copies are issued. Keys
//    outside the rows' range are zero-filled.
//  * 1-byte caches stage raw bytes (half the ring and the bytes read). All
//    the block's threads widen each landed tile once into a bf16 tile
//    (widen2: int8 by widen_pair, a prmt, two lop3 and one bf16x2 fma;
//    e4m3 by the card's e4m3x2 → f16x2 conversion, then to bf16; both
//    exact), which the bf16 path reads. Widening inside each
//    warp's fragment loads instead cost a lone warp 3.6-4.3 µs a key tile
//    against bf16's 1.7 µs on an H100 (tools/rpa_ablation.py), and every
//    warp of a prefill tile repeated it.
//  * Split-KV across blocks for long rows: the host picks an upper bound on
//    splits from shapes alone (ops/paged_attention.py: rpa_mma_plan); a block
//    takes min(splits, ceil(its key tiles / min_tiles)) splits of its own key
//    range, so short rows stay whole. A block of a row cut in several splits
//    stores its unnormalized O and (m, l) in an f32 workspace, and
//    rpa_combine_kernel (its own launch, after the attention's) merges
//    them by log-sum-exp in split order (no atomics: deterministic); a
//    split past its row's key tiles exits at once. A row with no visible
//    key gives 0. No host sync: the launch is CUDA-graph capturable.
// Score order, as rpa_kernel's: dot (× the INT8 key scale) × scale, soft
// cap, ALiBi slope × (kpos − qpos), then the causal / sliding-window mask.
// fp16 queries (the template's Q = __half; bf16 is Q = __nv_bfloat16) run
// the same kernel with mma.sync's f16 form: Q·Kᵀ and P·V on fp16 operands
// with f32 sums, 1-byte caches widened to fp16 (exact: int8 by widen_pair's
// construction under fp16 1024, e4m3 by the card's e4m3x2 → f16x2), P and
// the output rounded to fp16. Everything else, scales included (bf16), is
// the bf16 kernel's.
// Groups past 128 q heads per kv head: a token's group is cut into
// ceil(G / 128) slices of near-equal size (group_rows rows, at most 8 warps
// of 16), one block per (query tile, kv head, slice), each staging the same
// keys, as rpa_kernel cuts a group over blocks; a tile then holds one
// token. A row's arithmetic never crosses rows, so the sums are those of one
// block.
// Any head dim from 1 to 256 over every cache kind, at the instantiation
// width D (32, 64, 96, 128 or 256; instance_dim in paged_attention.cuh)
// with the head dim passed at run time (257 to 512: paged_attention_w512.cuh).
// A head dim below its width runs the PAD instantiation (8 warps, one a
// width): the ring's columns from head_dim to D are zero-filled (cp.async's
// source size of 0), Q's fragments there are 0, and the output columns
// there are never stored; a head's K and V rows are copied in the widest
// pieces its bytes allow (cp_async_part, a loop of its own where they are
// no multiple of 16 bytes: 1-byte copies for an odd head of a 1-byte
// cache), and at an odd head dim Q and the output, whose rows then start at
// odd elements, a half of a pair at a time. The other instantiations run
// the code they ran before. A source
// instantiates the narrow widths (32, 64, 128), the wide ones (96, 256) or
// both (HeadDimSet), so that the 1-byte caches' wide
// instantiations build in sources of their own, in parallel. At D = 96 a
// key's K|V slice is 24 16-byte pieces in the queries' dtype and 12 in a
// 1-byte cache, neither of which divides the block's threads, so the copies
// walk the tile's pieces key-major; 208-byte widened rows keep ldmatrix free
// of bank conflicts, and the widening pass takes 6 pieces a raw row. At D =
// 256 the ring is 3 × 66 KB in the queries' dtype and 3 × 34 KB of raw bytes
// plus a 66 KB widened tile in a 1-byte cache (one block an SM either way),
// and a thread holds Q's fragments (64 registers) and O (128) through the
// key loop: what does not fit spills (the build log counts it).

#pragma once

#include "device_once.cuh"
#include "mma_sm90.cuh"
#include "paged_attention.cuh"

namespace atoma {

constexpr int kRpaKT = 64;     // keys a tile
constexpr int kRpaStages = 3;  // tiles in the cp.async ring

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// One 16-byte piece of a ring row at a head dim whose bytes are no
// multiple of 16: its first n bytes (0 to 16, a multiple of w) from src in
// copies of w bytes (8, 4, 2 or 1: w divides the head's bytes, so no copy
// crosses the head's end), the rest zero-filled: 8 and 4 by cp.async (a
// source size of 0 fills zeros), 2 and 1 (an odd head of a 1-byte cache) by
// loads and a store, since cp.async has no smaller size. src must be
// readable where n is 0 (nothing is read then).
__device__ __forceinline__ void cp_async_part(uint32_t dst, const char* src, int n, int w) {
  if (w == 8) {
#pragma unroll
    for (int o = 0; o < 16; o += 8) cp_async8(dst + o, o < n ? src + o : src, o < n);
  } else if (w == 4) {
#pragma unroll
    for (int o = 0; o < 16; o += 4) cp_async4(dst + o, o < n ? src + o : src, o < n);
  } else if (w == 2) {
#pragma unroll
    for (int o = 0; o < 16; o += 4) {
      const uint32_t lo = o < n ? *reinterpret_cast<const uint16_t*>(src + o) : 0u;
      const uint32_t hi = o + 2 < n ? *reinterpret_cast<const uint16_t*>(src + o + 2) : 0u;
      sts32(dst + o, lo | hi << 16);
    }
  } else {
#pragma unroll
    for (int o = 0; o < 16; o += 4) {
      uint32_t v = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (o + b < n) v |= (uint32_t)(uint8_t)src[o + b] << (8 * b);
      sts32(dst + o, v);
    }
  }
}

// Elements d and d + 1 of a row of 16-bit values (p points at element d)
// as a pair, the low half first, 0 past the head dim hd: one 32-bit load
// where hd is even (the pair is then whole and 4-byte aligned), else two
// 16-bit ones (an odd row starts at an odd element).
__device__ __forceinline__ uint32_t load_pair(const void* p, int d, int hd) {
  if (hd % 2 == 0) return d < hd ? *reinterpret_cast<const uint32_t*>(p) : 0u;
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  const uint32_t lo = d < hd ? h[0] : 0u;
  const uint32_t hi = d + 1 < hd ? h[1] : 0u;
  return lo | hi << 16;
}

// The pair v at elements d and d + 1 of a row of 16-bit values, nothing
// past the head dim hd (load_pair's alignment).
__device__ __forceinline__ void store_pair(void* p, int d, int hd, uint32_t v) {
  if (hd % 2 == 0) {
    if (d < hd) *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
  uint16_t* h = reinterpret_cast<uint16_t*>(p);
  if (d < hd) h[0] = (uint16_t)v;
  if (d + 1 < hd) h[1] = (uint16_t)(v >> 16);
}

// The same for a row of floats (the split workspace).
__device__ __forceinline__ void store_pair_f32(float* p, int d, int hd, float a, float b) {
  if (hd % 2 == 0) {
    if (d < hd) *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  if (d < hd) p[0] = a;
  if (d + 1 < hd) p[1] = b;
}

// The bytes of 16-byte piece p of a head's K (or V) row that lie inside a
// head of head_bytes bytes: 16, a multiple of its copy width, or 0.
__device__ __forceinline__ int piece_bytes(int p, int head_bytes) {
  return min(16, max(0, head_bytes - 16 * p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Bytes j and j + 1 (j = 0 or 2) of a word of a 1-byte cache C as a Q pair
// (bf16 or fp16), byte j in the low half; exact for both.
template <typename C, typename Q>
__device__ __forceinline__ uint32_t widen2(uint32_t w, int j) {
  if constexpr (kScaled<C>) {
    // int8: widen_pair on byte j of w and of w >> 8.
    return widen_pair_t<Q>(w, w >> 8, j);
  } else {
    // e4m3: the card's e4m3x2 → f16x2 (every e4m3 value is an fp16 value),
    // then, for bf16, each half to bf16 (every e4m3 value is a bf16 value).
    const __nv_fp8x2_storage_t two = (__nv_fp8x2_storage_t)(w >> (8 * j));
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3);
    if constexpr (std::is_same<Q, __half>::value) {
      return (uint32_t)h.x | ((uint32_t)h.y << 16);
    } else {
      const float2 f = __half22float2(__half2(h));
      const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
      return *reinterpret_cast<const uint32_t*>(&b);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c),
               "r"(d));
}

// The key tiles a query tile sees: [t_lo, t_lo + n_tiles), from the
// window's first key to the tile's last query position.
__device__ __forceinline__ void rpa_tile_keys(int first_pos, int last_pos, int window,
                                              int& t_lo, int& n_tiles) {
  const int lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  t_lo = lo / kRpaKT;
  n_tiles = last_pos / kRpaKT + 1 - t_lo;
}

// The splits a query tile's keys take: at most ``splits``, at least
// ``min_tiles`` key tiles each (one split for a short row).
__device__ __forceinline__ int rpa_split_count(int n_tiles, int splits, int min_tiles) {
  return max(1, min(splits, (n_tiles + min_tiles - 1) / min_tiles));
}

template <typename C, int D, int NW>
struct RpaTile {
  static constexpr int kThreads = NW * 32;
  static constexpr bool kBytes = sizeof(C) == 1;
  static constexpr int kRawRow = D * (int)sizeof(C) + 16;  // padded ring row, bytes
  static constexpr int kRow = 2 * D + 16;                  // padded bf16 row, bytes
  static constexpr int kChunks = D * (int)sizeof(C) / 16;  // 16-byte pieces of a K (or V) row
  static constexpr int kStageBytes = 2 * kRpaKT * kRawRow;  // K rows, then V rows
  static constexpr int kWideBytes = kBytes ? 2 * kRpaKT * kRow : 0;
  static constexpr int kScaleBytes = kScaled<C> ? kRpaStages * kRpaKT * 4 : 0;
  static constexpr int kSmem =
      kRpaStages * kStageBytes + kWideBytes + kScaleBytes + (kRpaStages + 1) * kRpaKT * 4;
};

// A warp's S fragments of a tile of NK keys (lane (g8, c4) holds keys
// 8j + 2c4 + {0, 1} of rows g8 (e = 0, 1) and g8 + 8 (e = 2, 3) in s[j])
// through the score modifiers in the plain version's order (the INT8 key
// scale of the pairs at sc, scale, soft cap, ALiBi slope × (kpos − qpos),
// the causal / window mask when masked), then the online softmax of the
// lane's two rows: s becomes P (× INT8's V scale), (m, l) move on and the
// NO n8 tiles of O are rescaled.
template <int NK, int NO, bool SCALED>
__device__ __forceinline__ void rpa_tile_softmax(
    float (&s)[NK / 8][4], uint32_t sc, int kpos0, const int (&qpos)[2],
    const float (&slope)[2], bool alibi, bool masked, float scale, int window, float soft_cap,
    float (&o)[NO][4], float (&m)[2], float (&l)[2]) {
  const int c4 = threadIdx.x % 4;
  // Scores in the plain version's order, each modifier a uniform pass.
  float vsc[NK / 8][2];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float ksc = 1.f;
      vsc[j][e] = 1.f;
      if constexpr (SCALED) {
        const uint32_t pair = lds32(sc + (j * 8 + 2 * c4 + e) * 4);
        ksc = __uint_as_float(pair << 16);
        vsc[j][e] = __uint_as_float(pair & 0xFFFF0000u);
      }
      s[j][e] = s[j][e] * ksc * scale;
      s[j][2 + e] = s[j][2 + e] * ksc * scale;
    }
  if (soft_cap > 0.f) {
    const float inv_cap = 1.f / soft_cap;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = soft_cap * tanhf(s[j][e] * inv_cap);
  }
  if (alibi) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] += slope[e >> 1] * (float)(kpos0 + j * 8 + 2 * c4 + (e & 1) - qpos[e >> 1]);
  }
  if (masked) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kpos0 + j * 8 + 2 * c4 + (e & 1), qp = qpos[e >> 1];
        if (kpos > qp || (window > 0 && kpos <= qp - window)) s[j][e] = kNegInf;
      }
  }
  // Online softmax, rows reduced over the lane quad.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[rr], mx);
    const float mb = (m_new == kNegInf ? 0.f : m_new) * kLog2e;
    const float alpha = exp2_approx(m[rr] * kLog2e - mb);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2_approx(fmaf(s[j][2 * rr + e], kLog2e, -mb));
        sum += p;
        s[j][2 * rr + e] = p * vsc[j][e];  // INT8: V's scale folds into P
      }
    l[rr] = l[rr] * alpha + sum;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * rr] *= alpha;
      o[n][2 * rr + 1] *= alpha;
    }
    m[rr] = m_new;
  }
}

// One warp's work on a key tile: kRpaKT keys whose Q-typed K and V rows start
// at shared addresses ks and vs, rows row_bytes apart, the first at position
// kpos0; their INT8 scale pairs at sc. Updates the warp's running (m, l, O)
// for its two rows a lane.
template <typename Q, int D, bool SCALED>
__device__ __forceinline__ void rpa_warp_step(
    const uint32_t (&qf)[D / 16][4], uint32_t ks, uint32_t vs, int row_bytes, uint32_t sc,
    int kpos0, const int (&qpos)[2], const float (&slope)[2], bool alibi, bool masked,
    float scale, int window, float soft_cap, float (&o)[D / 8][4], float (&m)[2],
    float (&l)[2]) {
  constexpr int NK = kRpaKT;
  const int lane = threadIdx.x % 32;
  // S = Q·Kᵀ: n tile j holds keys 8j .. 8j+7; lane (g8, c4) holds keys
  // 8j + 2c4 + {0, 1} of rows g8 (e = 0, 1) and g8 + 8 (e = 2, 3).
  float s[NK / 8][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < NK / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + (16 * p + (lane / 16) * 8 + lane % 8) * row_bytes +
                         (kk * 16 + ((lane / 8) % 2) * 8) * 2);
      if (kk == 0) {
        mma16_fresh<Q>(s[2 * p], qf[kk], b[0], b[1]);
        mma16_fresh<Q>(s[2 * p + 1], qf[kk], b[2], b[3]);
      } else {
        mma16<Q>(s[2 * p], qf[kk], b[0], b[1]);
        mma16<Q>(s[2 * p + 1], qf[kk], b[2], b[3]);
      }
    }
  }
  rpa_tile_softmax<NK, D / 8, SCALED>(s, sc, kpos0, qpos, slope, alibi, masked, scale, window,
                                      soft_cap, o, m, l);
  // O += P·V, k step qq covering keys 16qq .. 16qq+15; P's A fragments are
  // the score accumulators of n tiles 2qq and 2qq+1, rounded to Q.
#pragma unroll
  for (int qq = 0; qq < NK / 16; ++qq) {
    const uint32_t a[4] = {pack2<Q>(s[2 * qq][0], s[2 * qq][1]),
                           pack2<Q>(s[2 * qq][2], s[2 * qq][3]),
                           pack2<Q>(s[2 * qq + 1][0], s[2 * qq + 1][1]),
                           pack2<Q>(s[2 * qq + 1][2], s[2 * qq + 1][3])};
#pragma unroll
    for (int mm = 0; mm < D / 16; ++mm) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (16 * qq + ((lane / 8) % 2) * 8 + lane % 8) * row_bytes +
                               (16 * mm + (lane / 16) * 8) * 2);
      mma16<Q>(o[2 * mm], a, b[0], b[1]);
      mma16<Q>(o[2 * mm + 1], a, b[2], b[3]);
    }
  }
}

template <typename Q, typename C, int D, int NW, bool PAD = false>
__global__ void __launch_bounds__(NW * 32) rpa_mma_kernel(
    const Q* __restrict__ q, const C* __restrict__ cache,
    const __nv_bfloat16* __restrict__ scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, const int* __restrict__ query_start_loc,
    const int* __restrict__ num_seqs, const float* __restrict__ alibi,
    Q* __restrict__ out, float* __restrict__ ws_o, float* __restrict__ ws_ml,
    int num_tokens, int num_q_heads, int num_kv_heads, int head_dim, int max_pages,
    int block_size, int group, int group_rows, int splits, int min_tiles, float scale,
    int window, float soft_cap) {
  using L = RpaTile<C, D, NW>;
  constexpr int KT = kRpaKT, ST = kRpaStages, NT = L::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int seq_s;
  const uint32_t ring = smem_addr(smem);
  const uint32_t wide = ring + ST * L::kStageBytes;
  const uint32_t sc_base = wide + L::kWideBytes;
  int* slot_ring = reinterpret_cast<int*>(smem + ST * L::kStageBytes + L::kWideBytes +
                                          L::kScaleBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, c4 = lane % 4;
  // A tile's rows: group_rows q heads (the whole group, or a slice of it
  // past 16 NW) of bq tokens; grid y is (kv head, slice).
  const int slices = (group + group_rows - 1) / group_rows;
  const int bq = NW * 16 / group_rows;  // tokens a tile
  const int x = blockIdx.x, h = blockIdx.y / slices, split = blockIdx.z;
  const int g0 = (blockIdx.y - h * slices) * group_rows;
  const int hd = PAD ? head_dim : D;  // D itself but at a padded head dim

  // Which sequence's query tile this block is.
  if (tid == 0) seq_s = -1;
  __syncthreads();
  const int n_seqs = num_seqs[0];
  for (int i = tid; i < n_seqs; i += NT) {
    const int a = query_start_loc[i], b = query_start_loc[i + 1];
    if (a / bq + i <= x && x < b / bq + i + 1) seq_s = i;
  }
  __syncthreads();
  const int s = seq_s;
  if (s < 0) return;
  const int q_start = query_start_loc[s];
  const int q_len = query_start_loc[s + 1] - q_start;
  const int tok0 = (x - (q_start / bq + s)) * bq;
  if (tok0 >= q_len) return;
  const int ntok = min(bq, q_len - tok0);
  const int ctx0 = seq_lens[s] - q_len;
  const int first_pos = ctx0 + tok0, last_pos = first_pos + ntok - 1;
  int t_lo, n_tiles;
  rpa_tile_keys(first_pos, last_pos, window, t_lo, n_tiles);
  const int nsplit = rpa_split_count(n_tiles, splits, min_tiles);
  if (split >= nsplit) return;
  const int tb = t_lo + (int)((long long)n_tiles * split / nsplit);
  const int te = t_lo + (int)((long long)n_tiles * (split + 1) / nsplit);
  const int key_lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  const long long row_stride = 2LL * num_kv_heads * hd;
  const int* bt = block_tables + (long long)s * max_pages;

  auto slot_of = [&](int t) {
    const int key = t * KT + tid;
    if (key < key_lo || key > last_pos) return -1;
    return bt[key / block_size] * block_size + key % block_size;
  };
  // Each thread copies one 16-byte piece of a (slot, kv head) K|V slice
  // for every kPass-th key of a tile. At D = 96 a slice's 24 pieces do not
  // divide the threads: there pass i's thread tid copies piece c = i NT +
  // tid of the tile's key-major pieces instead (kWalk). At a padded head dim
  // (PAD), piece p of a slice is piece p % kChunks of its K row (p <
  // kChunks) or of its V row, which starts head_dim elements after K's; a
  // piece past head_dim is zero-filled and reads nothing (its source is the
  // slice's start), and where the head is no multiple of 16 bytes its pieces
  // are copied in copy_width pieces by a loop of their own.
  constexpr int kPieces = 2 * L::kChunks;
  constexpr bool kWalk = NT % kPieces != 0;
  static_assert(KT * kPieces % NT == 0, "a tile's pieces split evenly over the threads");
  const int part = tid % kPieces, key0 = tid / kPieces;
  const uint32_t dst0 =
      (part < L::kChunks ? part * 16 : KT * L::kRawRow + (part - L::kChunks) * 16) +
      key0 * L::kRawRow;
  const char* src0 = reinterpret_cast<const char*>(cache + (long long)h * 2 * D) + part * 16;
  const int head_bytes = hd * (int)sizeof(C);
  const int cw = copy_width(head_bytes);
  const char* slice0 = reinterpret_cast<const char*>(cache) + (long long)h * 2 * head_bytes;
  // Piece p's offset in a padded slice (0 for a piece past the head).
  auto piece_src = [&](int p) {
    const int c = p % L::kChunks;
    return piece_bytes(c, head_bytes) > 0 ? (p < L::kChunks ? 0 : head_bytes) + 16 * c : 0;
  };
  const long long slot_bytes = row_stride * (long long)sizeof(C);
  auto issue = [&](int t, int stage) {
    const int* slots = slot_ring + ((t - tb) % (ST + 1)) * KT;
    if constexpr (!PAD) {
      if constexpr (!kWalk) {
        constexpr int kPass = NT / kPieces;
#pragma unroll
        for (int i = 0; i < KT / kPass; ++i) {
          const int slot = slots[key0 + i * kPass];
          cp_async16(ring + stage * L::kStageBytes + dst0 + i * kPass * L::kRawRow,
                     src0 + (long long)max(slot, 0) * slot_bytes, slot >= 0);
        }
      } else {
#pragma unroll
        for (int i = 0; i < KT * kPieces / NT; ++i) {
          const int c = i * NT + tid, key = c / kPieces, piece = c % kPieces;
          const int slot = slots[key];
          const uint32_t dst =
              (piece < L::kChunks ? piece * 16 : KT * L::kRawRow + (piece - L::kChunks) * 16) +
              key * L::kRawRow;
          cp_async16(ring + stage * L::kStageBytes + dst,
                     src0 + (piece - part) * 16 + (long long)max(slot, 0) * slot_bytes,
                     slot >= 0);
        }
      }
    } else {
      constexpr int kCopies = kWalk ? KT * kPieces / NT : KT / (NT / kPieces);
      // Copy i's key and piece: every kPass-th key's piece part, or the walk.
      auto copy_at = [&](int i, int& key, int& piece) {
        if constexpr (!kWalk) {
          key = key0 + i * (NT / kPieces), piece = part;
        } else {
          const int c = i * NT + tid;
          key = c / kPieces, piece = c % kPieces;
        }
      };
      if (cw == 16) {
#pragma unroll
        for (int i = 0; i < kCopies; ++i) {
          int key, piece;
          copy_at(i, key, piece);
          const int slot = slots[key];
          const uint32_t dst =
              (piece < L::kChunks ? piece * 16 : KT * L::kRawRow + (piece - L::kChunks) * 16) +
              key * L::kRawRow;
          cp_async16(ring + stage * L::kStageBytes + dst,
                     slice0 + piece_src(piece) + (long long)max(slot, 0) * slot_bytes,
                     slot >= 0 && piece_bytes(piece % L::kChunks, head_bytes) > 0);
        }
      } else {
#pragma unroll 1
        for (int i = 0; i < kCopies; ++i) {
          int key, piece;
          copy_at(i, key, piece);
          const int slot = slots[key];
          const uint32_t dst =
              (piece < L::kChunks ? piece * 16 : KT * L::kRawRow + (piece - L::kChunks) * 16) +
              key * L::kRawRow;
          cp_async_part(ring + stage * L::kStageBytes + dst,
                        slice0 + piece_src(piece) + (long long)max(slot, 0) * slot_bytes,
                        slot >= 0 ? piece_bytes(piece % L::kChunks, head_bytes) : 0, cw);
        }
      }
    }
    if constexpr (kScaled<C>) {
      if (tid < KT) {
        const int slot = slots[tid];
        cp_async4(sc_base + (stage * KT + tid) * 4, scales + 2LL * (slot >= 0 ? slot : 0),
                  slot >= 0);
      }
    }
  };

  // This lane's two rows, g8 and g8 + 8 of its warp's m16 tile; a warp with
  // no real row only copies.
  const int nrows = ntok * group_rows;
  const int row0 = warp * 16;
  const bool warp_active = row0 < nrows;
  int qpos[2];
  float slope[2];
  long long orow[2];
  bool rvalid[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + g8 + rr * 8;
    const int ti = r / group_rows, gg = g0 + r - ti * group_rows;
    rvalid[rr] = r < nrows && gg < group;
    qpos[rr] = first_pos + ti;
    slope[rr] = (alibi != nullptr && rvalid[rr]) ? alibi[h * group + gg] : 0.f;
    orow[rr] = (long long)(q_start + tok0 + ti) * num_q_heads + h * group + gg;
  }
  // Q's A fragments, in registers for the whole key loop; 0 past head_dim
  // (PAD: load_pair, whose odd head dims are read a half at a time).
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int d = kk * 16 + 2 * c4;
      const Q* qr = q + orow[rr] * hd + d;
      if constexpr (PAD) {
        qf[kk][rr] = rvalid[rr] ? load_pair(qr, d, hd) : 0u;
        qf[kk][2 + rr] = rvalid[rr] ? load_pair(qr + 8, d + 8, hd) : 0u;
      } else {
        qf[kk][rr] = rvalid[rr] ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
        qf[kk][2 + rr] = rvalid[rr] ? *reinterpret_cast<const uint32_t*>(qr + 8) : 0u;
      }
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // Prologue: the slots of the first ST tiles, then ST - 1 tiles in flight.
  // A tile's slots are read from the block table two iterations before its
  // copies are issued, so the load is done by the time it is stored.
  if (tid < KT) {
#pragma unroll
    for (int j = 0; j < ST; ++j)
      if (tb + j < te) slot_ring[j * KT + tid] = slot_of(tb + j);
  }
  int pending = tid < KT && tb + ST < te ? slot_of(tb + ST) : -1;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (tb + j < te) issue(tb + j, j);
    cp_async_commit();
  }

  for (int t = tb; t < te; ++t) {
    const int it = t - tb, stage = it % ST;
    cp_async_wait<ST - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + ST - 1 < te) issue(t + ST - 1, (it + ST - 1) % ST);
    cp_async_commit();
    if (tid < KT && t + ST < te) slot_ring[((it + ST) % (ST + 1)) * KT + tid] = pending;
    pending = tid < KT && t + ST + 1 < te ? slot_of(t + ST + 1) : -1;

    uint32_t kv = ring + stage * L::kStageBytes;
    int row_bytes = L::kRawRow;
    if constexpr (L::kBytes) {
      // Widen the tile's raw K and V rows to Q once, all threads: int8 and
      // e4m3 are exact in bf16 and in fp16.
      for (int c = tid; c < 2 * KT * L::kChunks; c += NT) {
        const int r = c / L::kChunks, piece = c - r * L::kChunks;
        const uint4 w = lds128(kv + r * L::kRawRow + piece * 16);
        const uint32_t dst = wide + r * L::kRow + piece * 32;
        sts128(dst, widen2<C, Q>(w.x, 0), widen2<C, Q>(w.x, 2), widen2<C, Q>(w.y, 0),
               widen2<C, Q>(w.y, 2));
        sts128(dst + 16, widen2<C, Q>(w.z, 0), widen2<C, Q>(w.z, 2), widen2<C, Q>(w.w, 0),
               widen2<C, Q>(w.w, 2));
      }
      __syncthreads();
      kv = wide;
      row_bytes = L::kRow;
    }
    const int kbase = t * KT;
    // A tile at or before the block's first query, and past its window, is
    // visible to every row: no mask.
    const bool masked =
        !(kbase + KT - 1 <= first_pos && (window <= 0 || kbase > last_pos - window));
    const uint32_t sc = sc_base + stage * KT * 4;
    if (warp_active)
      rpa_warp_step<Q, D, kScaled<C>>(qf, kv, kv + KT * row_bytes, row_bytes, sc, kbase, qpos, slope,
                                   alibi != nullptr, masked, scale, window, soft_cap, o, m, l);
  }
  cp_async_wait<0>();
  if (!warp_active) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!rvalid[rr]) continue;
    // Output columns past head_dim are computed and never stored (PAD:
    // store_pair, whose odd head dims are written a half at a time).
    if (nsplit == 1) {
      const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = 8 * n + 2 * c4;
        const uint32_t v = pack2<Q>(o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv);
        if constexpr (PAD)
          store_pair(out + orow[rr] * hd + d, d, hd, v);
        else
          *reinterpret_cast<uint32_t*>(out + orow[rr] * hd + d) = v;
      }
    } else {  // unnormalized, with (m, l), for rpa_combine_kernel
      const long long wrow = (long long)split * num_tokens * num_q_heads + orow[rr];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = 8 * n + 2 * c4;
        if constexpr (PAD)
          store_pair_f32(ws_o + wrow * hd + d, d, hd, o[n][2 * rr], o[n][2 * rr + 1]);
        else
          *reinterpret_cast<float2*>(ws_o + wrow * hd + d) =
              make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
      }
      if (c4 == 0) {
        ws_ml[2 * wrow] = m[rr];
        ws_ml[2 * wrow + 1] = l[rr];
      }
    }
  }
}

// Merges the splits of the rows whose query tile took more than one: one
// block per (token, kv head), its G·D outputs (any group). D is the head
// dim: a width's own (DIM), or, where DIM is 0, head_dim at run time (a
// head dim below its width). Each split's weight is exp(m_i − max m) (0 for
// a split in which the row saw no key); splits are summed in order.
template <typename Q, int DIM>
__global__ void __launch_bounds__(128) rpa_combine_kernel(
    const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
    Q* __restrict__ out, const int* __restrict__ seq_lens,
    const int* __restrict__ query_start_loc, const int* __restrict__ num_seqs,
    int num_tokens, int num_q_heads, int head_dim, int group, int bq, int splits,
    int min_tiles, int window) {
  const int D = DIM ? DIM : head_dim;
  const int t = blockIdx.x, h = blockIdx.y;
  const int n = num_seqs[0];
  if (t >= query_start_loc[n]) return;
  int lo = 0, hi = n - 1;  // the last sequence starting at or before t
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (query_start_loc[mid] <= t) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int q_start = query_start_loc[lo];
  const int q_len = query_start_loc[lo + 1] - q_start;
  const int tok0 = (t - q_start) / bq * bq;
  const int first_pos = seq_lens[lo] - q_len + tok0;
  const int last_pos = first_pos + min(bq, q_len - tok0) - 1;
  int t_lo, n_tiles;
  rpa_tile_keys(first_pos, last_pos, window, t_lo, n_tiles);
  const int nsplit = rpa_split_count(n_tiles, splits, min_tiles);
  if (nsplit <= 1) return;  // the attention block stored this row itself
  const long long split_rows = (long long)num_tokens * num_q_heads;
  for (int i = threadIdx.x; i < group * D; i += blockDim.x) {
    const int gg = i / D, d = i - gg * D;
    const long long row = (long long)t * num_q_heads + h * group + gg;
    float mmax = kNegInf;
    for (int sp = 0; sp < nsplit; ++sp) mmax = fmaxf(mmax, ws_ml[2 * (sp * split_rows + row)]);
    float sum = 0.f, acc = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const long long wrow = sp * split_rows + row;
      const float mi = ws_ml[2 * wrow];
      const float w = mi == kNegInf ? 0.f : expf(mi - mmax);
      sum += w * ws_ml[2 * wrow + 1];
      acc += w * ws_o[wrow * D + d];
    }
    out[row * D + d] = from_float<Q>(sum > 0.f ? acc / sum : 0.f);
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device it runs on.
template <typename Q, typename C, int D, int NW, bool PAD>
cudaError_t rpa_mma_attributes() {
  static atoma::PerDevice state;
  return atoma::once_per_device(state, [] {
    return cudaFuncSetAttribute(rpa_mma_kernel<Q, C, D, NW, PAD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                RpaTile<C, D, NW>::kSmem);
  });
}

template <typename Q, typename C, int D, int NW, bool PAD>
int rpa_mma_blocks_per_sm() {
  using L = RpaTile<C, D, NW>;
  if (rpa_mma_attributes<Q, C, D, NW, PAD>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rpa_mma_kernel<Q, C, D, NW, PAD>,
                                                    L::kThreads, L::kSmem) != cudaSuccess)
    return -1;
  return n;
}

// The slices a token's group is cut into for a tile of NW warps (one while
// it fits the tile's 16 NW rows), and the rows of a slice.
__host__ __device__ constexpr int rpa_group_slices(int group, int warps) {
  return (group + 16 * warps - 1) / (16 * warps);
}

template <typename Q, typename C, int D, int NW, bool PAD>
int launch_rpa_mma(const void* q, const void* cache, const void* scales, const int* bt,
                   const int* sl, const int* qsl, const int* ns, const float* alibi, void* out,
                   void* ws_o, void* ws_ml, int num_tokens, int num_seq_slots, int hq, int hk,
                   int head_dim, int max_pages, int block_size, int splits, int min_tiles,
                   float scale, int window, float soft_cap, cudaStream_t stream) {
  using L = RpaTile<C, D, NW>;
  const cudaError_t opt_in = rpa_mma_attributes<Q, C, D, NW, PAD>();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int group = hq / hk;
  const int slices = rpa_group_slices(group, NW);
  const int group_rows = (group + slices - 1) / slices;
  const int bq = NW * 16 / group_rows;
  if (bq < 1 || block_size <= 0 || block_size % 8 != 0 || splits < 1 || min_tiles < 1 ||
      (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tokens / bq + num_seq_slots, hk * slices, splits);
  rpa_mma_kernel<Q, C, D, NW, PAD><<<grid, L::kThreads, L::kSmem, stream>>>(
      (const Q*)q, (const C*)cache, (const __nv_bfloat16*)scales, bt, sl, qsl, ns,
      alibi, (Q*)out, (float*)ws_o, (float*)ws_ml, num_tokens, hq, hk, head_dim, max_pages,
      block_size, group, group_rows, splits, min_tiles, scale, window, soft_cap);
  return (int)cudaGetLastError();
}

// The merge of split rows (rpa_combine_kernel), launched after a split
// attention kernel (this file's, or fused_split_kernel with bq = 1); out
// of the queries' type Q.
template <typename Q>
int rpa_combine_entry(const void* ws_o, const void* ws_ml, void* out, const void* seq_lens,
                             const void* query_start_loc, const void* num_seqs, int num_tokens,
                             int num_q_heads, int num_kv_heads, int head_dim, int bq, int splits,
                             int min_tiles, int window, void* stream) {
  if (num_tokens <= 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0 || bq < 1 || splits < 2 ||
      min_tiles < 1 || ws_o == nullptr || ws_ml == nullptr || instance_dim(head_dim) == 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(num_tokens, num_kv_heads);
  const int group = num_q_heads / num_kv_heads;
  cudaStream_t st = (cudaStream_t)stream;
#define ATOMA_COMBINE(DIM)                                                                    \
  rpa_combine_kernel<Q, DIM><<<grid, 128, 0, st>>>(                                           \
      (const float*)ws_o, (const float*)ws_ml, (Q*)out, (const int*)seq_lens,                \
      (const int*)query_start_loc, (const int*)num_seqs, num_tokens, num_q_heads, head_dim,  \
      group, bq, splits, min_tiles, window)
  switch (head_dim) {
    case 32: ATOMA_COMBINE(32); break;
    case 64: ATOMA_COMBINE(64); break;
    case 96: ATOMA_COMBINE(96); break;
    case 128: ATOMA_COMBINE(128); break;
    case 256: ATOMA_COMBINE(256); break;
    default: ATOMA_COMBINE(0);
  }
#undef ATOMA_COMBINE
  return (int)cudaGetLastError();
}

template <typename Q, typename C, int DIMS>
int rpa_mma_entry(const void* q, const void* cache, const void* scales, const void* block_tables,
                  const void* seq_lens, const void* query_start_loc, const void* num_seqs,
                  const void* alibi, void* out, void* ws_o, void* ws_ml, int num_tokens,
                  int num_seq_slots, int num_q_heads, int num_kv_heads, int head_dim,
                  int max_pages, int block_size, int warps, int splits, int min_tiles,
                  float scale, int window, float soft_cap, void* stream) {
  if (num_tokens <= 0 || num_seq_slots <= 0) return 0;
  const int* bt = (const int*)block_tables;
  const int* sl = (const int*)seq_lens;
  const int* qsl = (const int*)query_start_loc;
  const int* ns = (const int*)num_seqs;
  const float* al = (const float*)alibi;
  cudaStream_t st = (cudaStream_t)stream;
  // A padded head dim (head_dim < its width) takes the PAD instantiation,
  // 8 warps only (the plan asks for 8: rpa_warps).
  const int dp = instance_dim(head_dim);
  const bool pad = head_dim != dp;
#define ATOMA_RPA_MMA(D, NW, P)                                                               \
  if (dp == D && warps == NW && pad == P)                                                     \
  return launch_rpa_mma<Q, C, D, NW, P>(q, cache, scales, bt, sl, qsl, ns, al, out, ws_o,     \
                                        ws_ml, num_tokens, num_seq_slots, num_q_heads,        \
                                        num_kv_heads, head_dim, max_pages, block_size,        \
                                        splits, min_tiles, scale, window, soft_cap, st)
  if constexpr ((DIMS & kNarrowDims) != 0) {
    ATOMA_RPA_MMA(32, 4, false);
    ATOMA_RPA_MMA(64, 4, false);
    ATOMA_RPA_MMA(128, 4, false);
    ATOMA_RPA_MMA(32, 8, false);
    ATOMA_RPA_MMA(64, 8, false);
    ATOMA_RPA_MMA(128, 8, false);
    ATOMA_RPA_MMA(32, 8, true);
    ATOMA_RPA_MMA(64, 8, true);
    ATOMA_RPA_MMA(128, 8, true);
  }
  if constexpr ((DIMS & kWideDims) != 0) {
    ATOMA_RPA_MMA(96, 4, false);
    ATOMA_RPA_MMA(256, 4, false);
    ATOMA_RPA_MMA(96, 8, false);
    ATOMA_RPA_MMA(256, 8, false);
    ATOMA_RPA_MMA(96, 8, true);
    ATOMA_RPA_MMA(256, 8, true);
  }
#undef ATOMA_RPA_MMA
  return (int)cudaErrorInvalidValue;
}

template <typename Q, typename C, int DIMS>
int rpa_mma_blocks_per_sm_entry(int head_dim, int warps) {
  const int dp = instance_dim(head_dim);
  const bool pad = head_dim != dp;
#define ATOMA_RPA_OCC(D, NW, P) \
  if (dp == D && warps == NW && pad == P) return rpa_mma_blocks_per_sm<Q, C, D, NW, P>()
  if constexpr ((DIMS & kNarrowDims) != 0) {
    ATOMA_RPA_OCC(32, 4, false);
    ATOMA_RPA_OCC(64, 4, false);
    ATOMA_RPA_OCC(128, 4, false);
    ATOMA_RPA_OCC(32, 8, false);
    ATOMA_RPA_OCC(64, 8, false);
    ATOMA_RPA_OCC(128, 8, false);
    ATOMA_RPA_OCC(32, 8, true);
    ATOMA_RPA_OCC(64, 8, true);
    ATOMA_RPA_OCC(128, 8, true);
  }
  if constexpr ((DIMS & kWideDims) != 0) {
    ATOMA_RPA_OCC(96, 4, false);
    ATOMA_RPA_OCC(256, 4, false);
    ATOMA_RPA_OCC(96, 8, false);
    ATOMA_RPA_OCC(256, 8, false);
    ATOMA_RPA_OCC(96, 8, true);
    ATOMA_RPA_OCC(256, 8, true);
  }
#undef ATOMA_RPA_OCC
  return -1;
}

}  // namespace atoma

// The merge of a split attention launch's rows: ws_o f32 [splits, T, Hq,
// head_dim], ws_ml f32 [splits, T, Hq, 2] (splits > 1), out Q [T, Hq,
// head_dim]; bq the
// query tokens a tile (1 for the fused decode kernel), min_tiles and window
// as the attention launch's. One library defines each (paged_attention.cu:
// bf16; paged_attention_f16.cu: SUFFIX _f16, fp16).
#define ATOMA_SPLIT_COMBINE_ENTRY(SUFFIX, Q)                                                  \
  extern "C" int atoma_paged_attention_split_combine##SUFFIX(                                 \
      const void* ws_o, const void* ws_ml, void* out, const void* seq_lens,                   \
      const void* query_start_loc, const void* num_seqs, int num_tokens, int num_q_heads,     \
      int num_kv_heads, int head_dim, int bq, int splits, int min_tiles, int window,          \
      void* stream) {                                                                         \
    return atoma::rpa_combine_entry<Q>(ws_o, ws_ml, out, seq_lens, query_start_loc, num_seqs, \
                                    num_tokens, num_q_heads, num_kv_heads, head_dim, bq,      \
                                    splits, min_tiles, window, stream);                       \
  }

// The tensor-core entry points of one (query type Q, cache kind C) pair at
// the widths of DIMS (a HeadDimSet), for every head_dim whose instance_dim
// is one of them: q and out Q [T, Hq, head_dim]; cache, scales, block
// tables and lengths as the ragged entry's; ws_o f32 [splits, T, Hq,
// head_dim] and ws_ml f32 [splits, T, Hq, 2] when splits > 1 (else null);
// warps 4 or 8 (64 or 128 rows a tile; a group past 16 warps is cut into
// rpa_group_slices slices). A launch with splits > 1 is followed by
// atoma_paged_attention_split_combine.
#define ATOMA_RPA_MMA_ENTRIES(SUFFIX, Q, C, DIMS)                                             \
  extern "C" int atoma_ragged_paged_attention_mma##SUFFIX(                                    \
      const void* q, const void* cache, const void* scales, const void* block_tables,        \
      const void* seq_lens, const void* query_start_loc, const void* num_seqs,               \
      const void* alibi, void* out, void* ws_o, void* ws_ml, int num_tokens,                 \
      int num_seq_slots, int num_q_heads, int num_kv_heads, int head_dim, int max_pages,     \
      int block_size, int warps, int splits, int min_tiles, float scale, int window,         \
      float soft_cap, void* stream) {                                                        \
    return atoma::rpa_mma_entry<Q, C, DIMS>(q, cache, scales, block_tables, seq_lens,              \
                                   query_start_loc, num_seqs, alibi, out, ws_o, ws_ml,       \
                                   num_tokens, num_seq_slots, num_q_heads, num_kv_heads,     \
                                   head_dim, max_pages, block_size, warps, splits,           \
                                   min_tiles, scale, window, soft_cap, stream);              \
  }                                                                                          \
  extern "C" int atoma_rpa_mma_blocks_per_sm##SUFFIX(int head_dim, int warps) {              \
    return atoma::rpa_mma_blocks_per_sm_entry<Q, C, DIMS>(head_dim, warps);                 \
  }
