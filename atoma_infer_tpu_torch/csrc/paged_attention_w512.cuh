// Kernels A, B, D and E at head dims past 256 (the width 512, past 512 in
// column slices of 512 columns) for bf16 and fp16 queries, on the tensor cores, over a cache in the queries'
// dtype, INT8 (+ per-slot scales) or e4m3: the ragged attention (A, D, E;
// the function of rpa_mma_kernel in paged_attention_mma.cuh) and the
// pure-decode attention with the KV write fused in (B and D's and E's fused
// variants; fused_split_kernel's in fused_decode_split.cuh), one kernel for
// both (FUSED). The plain versions: ops/paged_attention.py
// ragged_paged_attention_paged_plain and fused_decode_attention_plain.
//
// Replaces the TPU kernel atoma_infer_tpu/ops/paged_attention.py:_kernel
// (:139) at the head dims past 256 that it takes (nothing in
// ops/paged_attention.py caps the head dim; ops/attention.py
// _pallas_supported checks lane alignment only), reached through
// ragged_paged_attention_pallas (:1058, fuse_write=False),
// ragged_paged_attention_fused (:1093) and ragged_paged_attention_fused_quant
// (:1132); quant=True (INT8) and fp8=True (_e4m3_decode :66-85) on the
// 1-byte caches.
//
// Bound: as at the narrower widths, a decode row's K/V bytes (3.35 TB/s;
// a 1-byte cache halves them), a prefill chunk's operations. What the width
// takes away is room: the narrower kernels keep Q's fragments (D/4
// registers a thread) and O (D/2) through the key loop, 384 registers at
// 512 against the 255 a thread has, and their rings (3 stages of 64 keys
// of 2·D + 16-byte rows; each split-fused warp two stages of 32 K rows) no
// longer fit a block's 227 KB. The design:
//  * One block of 4 warps per (query tile, kv head, group slice, KV split)
//    (ragged) or per (kv head, sequence, KV split) (fused: the token's
//    group of at most 16 q heads). A tile is one m16 tile of 16 (token, q
//    head) rows, token-major as the narrower kernel packs them (16 /
//    group_rows tokens; a group past 16 cut into slices of at most 16 rows,
//    rpa_group_slices at one row tile).
//  * The 4 warps share those rows and split O's 512 columns, 128 a warp (64
//    accumulator registers a thread). Each warp computes the tile's whole
//    S = Q·Kᵀ (every k step: the same sums in every warp, so the warps'
//    online-softmax states agree), then O += P·V on its own columns. Q's A
//    fragments are read by ldmatrix from a Q tile in shared memory, one k
//    step at a time, not kept in registers. S thus costs the tensor cores 4
//    times over: 2.5 times a tile's least operations, where the kernel is
//    bound by operations (prefill).
//  * Keys come in tiles of 32 (half the narrower kernels' 64-key tile; the
//    KV splits still cut whole 64-key tiles, rpa_tile_keys and
//    rpa_split_count, so the plans and the merge are theirs) through a
//    3-stage cp.async ring of K and V rows of 2·512 + 16 bytes (66.5 KB a
//    stage in the queries' dtype; a 1-byte cache stages raw rows of 528
//    bytes and widens each landed tile once into a 66.5 KB tile), beside the
//    16.6 KB Q tile: 217 KB, 186 KB for a 1-byte cache; one block an SM.
//  * The head dim is passed at run time (every head dim past 256 runs this
//    one instantiation): the ring's and the Q tile's columns past
//    it are zero, the copies as wide as a head's bytes allow (copy_width,
//    cp_async_part), S skips the k steps past it and a warp the columns past
//    it (a warp with none only copies), and output columns past it are
//    never stored; Q and the output go a half of a pair at a time at an odd
//    head dim (load_pair, store_pair).
//  * Fused: the last KV split (the one holding pos = seq_len - 1) first
//    stores the token's new K/V slice (INT8: quantized with the token's
//    scales, from its K and V rows' absmax over every kv head or from
//    scales_new; its h = 0 block stores the scales), then reads it back
//    through the ring after a barrier; the new key's INT8 scales are staged
//    from the block's registers, since another kv head's block stores them.
//  * Past 512, column slices (column_slices: ceil(head_dim / 512), the
//    innermost of grid.z): a block owns 512 of O's columns, 128 a warp as
//    above, and computes the tile's whole S over the head dim. Each key tile
//    streams through the same ring as ncs + 1 units of a stage each: for
//    every 512-column chunk u, K's chunk (the stage's K rows) with Q's chunk
//    (its 16 rows, Q-typed, in the stage's V rows; Q is read again for every
//    tile, from L2), S summed over the chunks in order; then V's columns of
//    the slice (its V rows). Every slice sums the same S in the same order,
//    so the slices' online-softmax states agree and nothing crosses them
//    (only slice 0 writes (m, l) to the workspace). The cost: K read once a
//    slice and S computed once a slice (at D = 1,024 a decode row reads
//    1.5 times its least K/V bytes; at 4,096, 4.5 times). Head dims up to 512
//    run one slice, the code above. Fused, past 512: each slice stores only
//    its own columns of the new K and V rows (one block, cs = 0 of kv head 0,
//    the INT8 scales), so no slice can read the new key's other K columns
//    back: its K chunks come from k_new, encoded and decoded as the cache
//    read would give them (INT8 with the token's scales, e4m3), in place of
//    the row the ring copied; its V columns are the slice's own, read back.
//  * KV splits, the f32 workspace and the merge (rpa_combine_kernel) as the
//    narrower kernels'. Score order as theirs: dot (× the INT8 key scale) ×
//    scale, soft cap, ALiBi slope × (kpos − qpos), then the causal / window
//    mask; P rounded to Q after INT8's V scale.

#pragma once

#include "paged_attention_mma.cuh"

namespace atoma {

constexpr int kW512 = 512;
constexpr int kW512Warps = 4;                  // warps a block
constexpr int kW512Cols = kW512 / kW512Warps;  // O's columns a warp
constexpr int kW512KT = 32;                    // keys a ring stage
constexpr int kW512Stages = 3;                 // stages in the ring
constexpr int kW512Rows = 16;                  // rows a tile: one m16 tile

template <typename C>
struct W512Tile {
  static constexpr int kThreads = kW512Warps * 32;
  static constexpr bool kBytes = sizeof(C) == 1;
  static constexpr int kRawRow = kW512 * (int)sizeof(C) + 16;  // padded ring row, bytes
  static constexpr int kRow = 2 * kW512 + 16;                  // padded Q-typed row, bytes
  static constexpr int kChunks = kW512 * (int)sizeof(C) / 16;  // 16-byte pieces of a K (or V) row
  static constexpr int kStageBytes = 2 * kW512KT * kRawRow;    // K rows, then V rows
  static constexpr int kWideBytes = kBytes ? 2 * kW512KT * kRow : 0;
  static constexpr int kQBytes = kW512Rows * kRow;
  static constexpr int kScaleBytes = kScaled<C> ? kW512Stages * kW512KT * 4 : 0;
  static constexpr int kSmem = kW512Stages * kStageBytes + kWideBytes + kQBytes + kScaleBytes +
                               (kW512Stages + 1) * kW512KT * 4;
};

// S += Q·Kᵀ over a key tile of kW512KT keys and nk16 k steps of 16
// columns: Q's A fragments by ldmatrix from the 16 Q-typed rows at qs (rows
// 2·kW512 + 16 bytes apart), K's rows at ks, row_bytes apart. n tile j of s
// holds keys 8j .. 8j+7; lane (g8, c4) holds keys 8j + 2c4 + {0, 1} of rows
// g8 (e = 0, 1) and g8 + 8 (e = 2, 3). Lane l points ldmatrix at Q row
// l % 16, columns (l / 16)·8 of the k step.
template <typename Q>
__device__ __forceinline__ void w512_scores(uint32_t qs, uint32_t ks, int row_bytes, int nk16,
                                            float (&s)[kW512KT / 8][4]) {
  constexpr int NK = kW512KT;
  const int lane = threadIdx.x % 32;
  const uint32_t qa = qs + (lane % 16) * (2 * kW512 + 16) + (lane / 16) * 16;
  const uint32_t kb = ks + ((lane / 16) * 8 + lane % 8) * row_bytes + ((lane / 8) % 2) * 16;
#pragma unroll 4
  for (int kk = 0; kk < nk16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk * 32);
#pragma unroll
    for (int p = 0; p < NK / 16; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, kb + 16 * p * row_bytes + kk * 32);
      mma16<Q>(s[2 * p], a, b[0], b[1]);
      mma16<Q>(s[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// O += P·V on the warp's columns col0 .. col0 + 127 of the V rows at vs
// (row_bytes apart), those below hd, k step qq covering keys 16qq ..
// 16qq+15; P's A fragments are the score accumulators of n tiles 2qq and
// 2qq+1, rounded to Q.
template <typename Q>
__device__ __forceinline__ void w512_pv(const float (&s)[kW512KT / 8][4], uint32_t vs,
                                        int row_bytes, int col0, int hd,
                                        float (&o)[kW512Cols / 8][4]) {
  constexpr int NK = kW512KT;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int qq = 0; qq < NK / 16; ++qq) {
    const uint32_t a[4] = {pack2<Q>(s[2 * qq][0], s[2 * qq][1]),
                           pack2<Q>(s[2 * qq][2], s[2 * qq][3]),
                           pack2<Q>(s[2 * qq + 1][0], s[2 * qq + 1][1]),
                           pack2<Q>(s[2 * qq + 1][2], s[2 * qq + 1][3])};
#pragma unroll
    for (int mm = 0; mm < kW512Cols / 16; ++mm) {
      if (col0 + 16 * mm >= hd) continue;  // warp-uniform: columns past the head
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (16 * qq + ((lane / 8) % 2) * 8 + lane % 8) * row_bytes +
                               (col0 + 16 * mm + (lane / 16) * 8) * 2);
      mma16<Q>(o[2 * mm], a, b[0], b[1]);
      mma16<Q>(o[2 * mm + 1], a, b[2], b[3]);
    }
  }
}

// One warp's work on a key tile of kW512KT keys whose Q-typed K and V rows
// start at shared addresses ks and vs, rows row_bytes apart, the first at
// position kpos0; their INT8 scale pairs at sc. S over the tile's 16 rows
// and nk16 k steps (Q from the Q tile at qs), then O += P·V on the warp's
// columns col0 .. col0 + 127 below hd. Updates the running (m, l, O) of the
// lane's two rows.
template <typename Q, bool SCALED>
__device__ __forceinline__ void w512_warp_step(
    uint32_t qs, uint32_t ks, uint32_t vs, int row_bytes, uint32_t sc, int kpos0,
    const int (&qpos)[2], const float (&slope)[2], bool alibi, bool masked, float scale,
    int window, float soft_cap, int nk16, int col0, int hd, float (&o)[kW512Cols / 8][4],
    float (&m)[2], float (&l)[2]) {
  float s[kW512KT / 8][4];
#pragma unroll
  for (int j = 0; j < kW512KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  w512_scores<Q>(qs, ks, row_bytes, nk16, s);
  rpa_tile_softmax<kW512KT, kW512Cols / 8, SCALED>(s, sc, kpos0, qpos, slope, alibi, masked,
                                                   scale, window, soft_cap, o, m, l);
  w512_pv<Q>(s, vs, row_bytes, col0, hd, o);
}

// q, out: Q [T, Hq, head_dim]; k_new, v_new: Q [T, Hk, head_dim] (FUSED);
// cache [pages, block_size, 2 Hk head_dim] of C, written in place when
// FUSED; scales bf16 [pages, block_size, 2] (INT8) or null; scales_new f32
// [T, 2] or null (FUSED, INT8); ws_o f32 [splits, T, Hq, head_dim] and
// ws_ml f32 [splits, T, Hq, 2] when splits > 1. Ragged: grid (T / tokens +
// S, Hk · slices, splits), a tile's rows group_rows q heads of 16 /
// group_rows tokens. Fused: grid (Hk, S, splits), group_rows = group (1 to
// 16), one query token a sequence.
template <typename Q, typename C, bool FUSED>
__global__ void __launch_bounds__(kW512Warps * 32) rpa_w512_kernel(
    const Q* __restrict__ q, const Q* __restrict__ k_new, const Q* __restrict__ v_new,
    C* cache, __nv_bfloat16* scales, const float* __restrict__ scales_new,
    const int* __restrict__ slot_mapping, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, const int* __restrict__ query_start_loc,
    const int* __restrict__ num_seqs, const float* __restrict__ alibi, Q* __restrict__ out,
    float* __restrict__ ws_o, float* __restrict__ ws_ml, int num_tokens, int num_q_heads,
    int num_kv_heads, int head_dim, int max_pages, int block_size, long long num_slots,
    int group, int group_rows, int splits, int min_tiles, float scale, int window,
    float soft_cap) {
  using L = W512Tile<C>;
  constexpr int KT = kW512KT, ST = kW512Stages, NT = L::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int seq_s;
  __shared__ float red_s[2 * kW512Warps];
  const uint32_t ring = smem_addr(smem);
  const uint32_t wide = ring + ST * L::kStageBytes;
  const uint32_t qs = wide + L::kWideBytes;
  const uint32_t sc_base = qs + L::kQBytes;
  int* slot_ring = reinterpret_cast<int*>(smem + ST * L::kStageBytes + L::kWideBytes +
                                          L::kQBytes + L::kScaleBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, c4 = lane % 4;
  // blockIdx.z: the KV split, and within it the column slice cs, whose
  // columns c0 .. c0 + 511 of V and of the output the block owns (one slice
  // up to 512).
  const int hd = head_dim, ncs = column_slices(hd);
  const int split = blockIdx.z / ncs, cs = blockIdx.z - split * ncs, c0 = cs * kW512;
  int s, h, g0, tok0, ntok, q_start, q_len;
  if constexpr (FUSED) {
    h = blockIdx.x, s = blockIdx.y, g0 = 0, tok0 = 0, ntok = 1;
    if (s >= num_seqs[0]) return;
    q_start = query_start_loc[s];
    q_len = query_start_loc[s + 1] - q_start;
    if (q_len != 1) return;  // decode: one query token
  } else {
    // Which sequence's query tile this block is (rpa_mma_kernel's rule).
    const int slices = (group + group_rows - 1) / group_rows;
    const int bq = kW512Rows / group_rows;
    const int x = blockIdx.x;
    h = blockIdx.y / slices;
    g0 = (blockIdx.y - h * slices) * group_rows;
    if (tid == 0) seq_s = -1;
    __syncthreads();
    const int n_seqs = num_seqs[0];
    for (int i = tid; i < n_seqs; i += NT) {
      const int a = query_start_loc[i], b = query_start_loc[i + 1];
      if (a / bq + i <= x && x < b / bq + i + 1) seq_s = i;
    }
    __syncthreads();
    s = seq_s;
    if (s < 0) return;
    q_start = query_start_loc[s];
    q_len = query_start_loc[s + 1] - q_start;
    tok0 = (x - (q_start / bq + s)) * bq;
    if (tok0 >= q_len) return;
    ntok = min(bq, q_len - tok0);
  }
  const int first_pos = seq_lens[s] - q_len + tok0, last_pos = first_pos + ntok - 1;
  int t_lo, n_tiles;
  rpa_tile_keys(first_pos, last_pos, window, t_lo, n_tiles);
  const int nsplit = rpa_split_count(n_tiles, splits, min_tiles);
  if (split >= nsplit) return;
  // The split's 64-key tiles, counted in tiles of KT keys.
  constexpr int kSub = kRpaKT / KT;
  const int tb = kSub * (t_lo + (int)((long long)n_tiles * split / nsplit));
  const int te = kSub * (t_lo + (int)((long long)n_tiles * (split + 1) / nsplit));
  const int key_lo = window > 0 ? max(0, first_pos - window + 1) : 0;
  const long long row_stride = 2LL * num_kv_heads * hd;
  const int* bt = block_tables + (long long)s * max_pages;
  const int head_bytes = hd * (int)sizeof(C);
  const long long slot_bytes = row_stride * (long long)sizeof(C);

  // Fused: the last split stores the token's new K/V slice (and its INT8
  // scales), read back through the ring after the prologue's barrier; past
  // 512 each column slice stores its own columns of K and V.
  uint32_t new_scales = 0u;  // the token's INT8 (K, V) scales, a bf16 pair
  float inv_k = 1.f, inv_v = 1.f;
  bool write = false;  // this block stores the new key's row
  if constexpr (FUSED) {
    const bool last = split == nsplit - 1;
    const long long slot = slot_mapping[q_start];
    write = last && slot >= 0 && slot < num_slots;
    if constexpr (kScaled<C>) {
      if (last) {  // block-uniform: row_absmax holds a barrier
        __nv_bfloat16 bk, bv;
        if (scales_new != nullptr) {  // grid-uniform
          bk = __float2bfloat16_rn(scales_new[2 * q_start]);
          bv = __float2bfloat16_rn(scales_new[2 * q_start + 1]);
        } else {
          float mk, mv;
          row_absmax(k_new + (long long)q_start * num_kv_heads * hd,
                     v_new + (long long)q_start * num_kv_heads * hd, num_kv_heads * hd, red_s,
                     mk, mv);
          bk = kv_scale(mk);
          bv = kv_scale(mv);
        }
        inv_k = 1.f / __bfloat162float(bk);
        inv_v = 1.f / __bfloat162float(bv);
        new_scales = (uint32_t)__bfloat16_as_ushort(bk) |
                     (uint32_t)__bfloat16_as_ushort(bv) << 16;
        if (write && h == 0 && cs == 0 && tid == 0) {
          scales[2 * slot] = bk;
          scales[2 * slot + 1] = bv;
        }
      }
    }
    if (write) {
      const Q* kn = k_new + ((long long)q_start * num_kv_heads + h) * hd;
      const Q* vn = v_new + ((long long)q_start * num_kv_heads + h) * hd;
      const int w = min(kW512, hd - c0);  // the slice's columns: all of hd up to 512
      C* dst = cache + slot * row_stride + (long long)h * 2 * hd + c0;
      for (int i = tid; i < 2 * w; i += NT) {
        if (i < w)
          dst[i] = encode<C>(to_float(kn[c0 + i]), inv_k);
        else
          dst[hd + i - w] = encode<C>(to_float(vn[c0 + i - w]), inv_v);
      }
    }
  }

  // This lane's two rows, g8 and g8 + 8 of the tile (every warp's).
  const int nrows = ntok * group_rows;
  int qpos[2];
  float slope[2];
  long long orow[2];
  bool rvalid[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g8 + rr * 8;
    const int ti = r / group_rows, gg = g0 + r - ti * group_rows;
    rvalid[rr] = r < nrows && gg < group;
    qpos[rr] = first_pos + ti;
    slope[rr] = (alibi != nullptr && rvalid[rr]) ? alibi[h * group + gg] : 0.f;
    orow[rr] = (long long)(q_start + tok0 + ti) * num_q_heads + h * group + gg;
  }

  auto slot_of = [&](int t) {
    const int key = t * KT + tid;
    if (key < key_lo || key > last_pos) return -1;
    return bt[key / block_size] * block_size + key % block_size;
  };
  const int cw = copy_width(head_bytes);
  // The tile's INT8 scale pairs into the stage's slots (the new key's from
  // the block's registers: another block stores them).
  auto issue_scales = [&](int t, const int* slots, int stage) {
    if constexpr (kScaled<C>) {
      if (tid < KT) {
        const int slot = slots[tid];
        const uint32_t sdst = sc_base + (stage * KT + tid) * 4;
        if (FUSED && t * KT + tid == last_pos && split == nsplit - 1)
          sts32(sdst, new_scales);
        else
          cp_async4(sdst, scales + 2LL * (slot >= 0 ? slot : 0), slot >= 0);
      }
    }
  };

  const int col0 = warp * kW512Cols;
  const bool warp_active = c0 + col0 < hd;
  float o[kW512Cols / 8][4];
#pragma unroll
  for (int n = 0; n < kW512Cols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (ncs == 1) {
    // The Q tile: row r the tile's row r, 0 past head_dim and on rows past
    // the tile or the group.
    for (int i = tid; i < kW512Rows * (kW512 / 2); i += NT) {
      const int r = i / (kW512 / 2), d = 2 * (i % (kW512 / 2));
      const int ti = r / group_rows, gg = g0 + r - ti * group_rows;
      uint32_t v = 0u;
      if (r < nrows && gg < group && d < hd)
        v = load_pair(
            q + ((long long)(q_start + tok0 + ti) * num_q_heads + h * group + gg) * hd + d, d,
            hd);
      sts32(qs + r * L::kRow + 2 * d, v);
    }
    // Each thread copies one 16-byte piece of a (slot, kv head) K|V slice
    // for every kPass-th key of a tile: piece p of a slice is piece p %
    // kChunks of its K row (p < kChunks) or of its V row, which starts
    // head_dim elements after K's; a piece past head_dim is zero-filled and
    // reads nothing, and where the head is no multiple of 16 bytes its
    // pieces are copied in copy_width pieces by a loop of their own.
    constexpr int kPieces = 2 * L::kChunks;
    static_assert(NT % kPieces == 0 && KT * kPieces % NT == 0, "pieces split evenly");
    constexpr int kPass = NT / kPieces;
    const int part = tid % kPieces, key0 = tid / kPieces;
    const int pchunk = part % L::kChunks;
    const int pbytes = piece_bytes(pchunk, head_bytes);
    const char* src0 = reinterpret_cast<const char*>(cache) + (long long)h * 2 * head_bytes +
                       (pbytes > 0 ? (part < L::kChunks ? 0 : head_bytes) + 16 * pchunk : 0);
    const uint32_t dst0 =
        (part < L::kChunks ? part * 16 : KT * L::kRawRow + (part - L::kChunks) * 16) +
        key0 * L::kRawRow;
    auto issue = [&](int t, int stage) {
      const int* slots = slot_ring + ((t - tb) % (ST + 1)) * KT;
      const uint32_t dst = ring + stage * L::kStageBytes + dst0;
      if (cw == 16) {
#pragma unroll
        for (int i = 0; i < KT / kPass; ++i) {
          const int slot = slots[key0 + i * kPass];
          cp_async16(dst + i * kPass * L::kRawRow, src0 + (long long)max(slot, 0) * slot_bytes,
                     slot >= 0 && pbytes > 0);
        }
      } else {
#pragma unroll 1
        for (int i = 0; i < KT / kPass; ++i) {
          const int slot = slots[key0 + i * kPass];
          cp_async_part(dst + i * kPass * L::kRawRow,
                        src0 + (long long)max(slot, 0) * slot_bytes, slot >= 0 ? pbytes : 0, cw);
        }
      }
      issue_scales(t, slots, stage);
    };
    const int nk16 = (hd + 15) / 16;

    // Prologue: the slots of the first ST tiles, then ST - 1 tiles in
    // flight. A tile's slots are read from the block table two iterations
    // before its copies are issued. The barrier also orders the Q tile and
    // the fused write before the ring's reads.
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
      // A tile at or before the block's first query, and past its window,
      // is visible to every row: no mask.
      const bool masked =
          !(kbase + KT - 1 <= first_pos && (window <= 0 || kbase > last_pos - window));
      if (warp_active)
        w512_warp_step<Q, kScaled<C>>(qs, kv, kv + KT * row_bytes, row_bytes,
                                      sc_base + stage * KT * 4, kbase, qpos, slope,
                                      alibi != nullptr, masked, scale, window, soft_cap, nk16,
                                      col0, hd, o, m, l);
    }
  } else {
    // Past 512, column slice cs of ncs: each key tile streams through the
    // ring as ncs + 1 units of a stage each: for chunk u < ncs, K's columns
    // 512u .. 512u + 511 (the stage's K rows) with Q's (16 Q-typed rows in
    // its V rows), S summed over the chunks in order; then V's columns c0 ..
    // c0 + 511 (its V rows). A tile's slots are read from the block table
    // in the iteration before its first unit's copies are issued.
    const int U = ncs + 1, n_units = (te - tb) * U;
    const int cwq = copy_width(hd * 2);  // Q's rows: 16-bit values
    constexpr int kQPieces = 2 * kW512 / 16;  // 16-byte pieces of a Q chunk's row
    const Q* kn = FUSED ? k_new + ((long long)q_start * num_kv_heads + h) * hd : nullptr;
    auto write_slots = [&](int t) {
      if (tid < KT) slot_ring[((t - tb) % (ST + 1)) * KT + tid] = slot_of(t);
    };
    auto issue_unit = [&](int j, int stage) {
      const int t = tb + j / U, u = j - (j / U) * U;
      const int* slots = slot_ring + ((t - tb) % (ST + 1)) * KT;
      const uint32_t base = ring + stage * L::kStageBytes;
      // K's chunk u, or V's chunk cs: pieces 16 bytes wide, 0 past hd.
      const int chunk = u < ncs ? u : cs;
      const int half = u < ncs ? 0 : head_bytes;
      const uint32_t rows = u < ncs ? base : base + KT * L::kRawRow;
      for (int i = tid; i < KT * L::kChunks; i += NT) {
        const int r = i / L::kChunks, p = i - r * L::kChunks;
        const int pg = chunk * L::kChunks + p;
        const int pb = piece_bytes(pg, head_bytes);
        const int slot = slots[r];
        const char* src = reinterpret_cast<const char*>(cache) +
                          (long long)max(slot, 0) * slot_bytes + (long long)h * 2 * head_bytes +
                          (pb > 0 ? half + 16 * pg : 0);
        const uint32_t dst = rows + r * L::kRawRow + 16 * p;
        if (cw == 16)
          cp_async16(dst, src, slot >= 0 && pb > 0);
        else
          cp_async_part(dst, src, slot >= 0 ? pb : 0, cw);
      }
      if (u < ncs) {
        // Q's chunk u: the tile's rows, 0 past hd and on rows past the tile
        // or the group, in pieces as wide as Q's rows allow.
        for (int i = tid; i < kW512Rows * kQPieces; i += NT) {
          const int r = i / kQPieces, p = i - r * kQPieces;
          const int ti = r / group_rows, gg = g0 + r - ti * group_rows;
          const int e0 = u * kW512 + 8 * p;
          const int nb = r < nrows && gg < group ? min(16, max(0, 2 * (hd - e0))) : 0;
          const Q* src =
              nb > 0
                  ? q + ((long long)(q_start + tok0 + ti) * num_q_heads + h * group + gg) * hd +
                        e0
                  : q;
          const uint32_t dst = base + KT * L::kRawRow + r * L::kRow + 16 * p;
          if (cwq == 16)
            cp_async16(dst, src, nb > 0);
          else
            cp_async_part(dst, reinterpret_cast<const char*>(src), nb, cwq);
        }
        if (u == ncs - 1) issue_scales(t, slots, stage);
      }
    };

    write_slots(tb);
    __syncthreads();  // the slots, and the fused write, before the ring's reads
#pragma unroll
    for (int j = 0; j < ST - 1; ++j) {
      if (j < n_units) issue_unit(j, j);
      cp_async_commit();
    }
    float sacc[KT / 8][4];
    for (int it = 0; it < n_units; ++it) {
      const int stage = it % ST, t = tb + it / U, u = it - (it / U) * U;
      cp_async_wait<ST - 2>();
      __syncthreads();  // unit it landed; every warp is done with unit it - 1
      if (it + ST - 1 < n_units) issue_unit(it + ST - 1, (it + ST - 1) % ST);
      cp_async_commit();
      if ((it + ST) % U == 0 && it + ST < n_units) write_slots(tb + (it + ST) / U);

      const uint32_t base = ring + stage * L::kStageBytes;
      const bool k_unit = u < ncs;
      uint32_t rows = k_unit ? base : base + KT * L::kRawRow;
      int row_bytes = L::kRawRow;
      // Fused: the new key (in the last split) takes K's chunk from k_new,
      // encoded and decoded as the cache holds it: other slices' blocks
      // store its other columns.
      const int r_new = write && k_unit ? last_pos - t * KT : -1;
      const bool new_here = r_new >= 0 && r_new < KT;
      if constexpr (L::kBytes) {
        // Widen the unit's raw rows to Q once (the new key's row apart).
        const uint32_t dst_rows = k_unit ? wide : wide + KT * L::kRow;
        for (int c = tid; c < KT * L::kChunks; c += NT) {
          const int r = c / L::kChunks, piece = c - r * L::kChunks;
          if (r == r_new) continue;
          const uint4 w = lds128(rows + r * L::kRawRow + piece * 16);
          const uint32_t dst = dst_rows + r * L::kRow + piece * 32;
          sts128(dst, widen2<C, Q>(w.x, 0), widen2<C, Q>(w.x, 2), widen2<C, Q>(w.y, 0),
                 widen2<C, Q>(w.y, 2));
          sts128(dst + 16, widen2<C, Q>(w.z, 0), widen2<C, Q>(w.z, 2), widen2<C, Q>(w.w, 0),
                 widen2<C, Q>(w.w, 2));
        }
        rows = dst_rows;
        row_bytes = L::kRow;
      }
      if (new_here) {
        for (int e = tid; e < kW512 / 2; e += NT) {
          const int d = u * kW512 + 2 * e;
          const float x = d < hd ? to_float(encode<C>(to_float(kn[d]), inv_k)) : 0.f;
          const float y = d + 1 < hd ? to_float(encode<C>(to_float(kn[d + 1]), inv_k)) : 0.f;
          sts32(rows + r_new * row_bytes + 4 * e, pack2<Q>(x, y));
        }
      }
      if (L::kBytes || new_here) __syncthreads();
      if (!warp_active) continue;
      if (k_unit) {
        if (u == 0) {
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
        }
        w512_scores<Q>(base + KT * L::kRawRow, rows, row_bytes,
                       (min(kW512, hd - u * kW512) + 15) / 16, sacc);
        if (u == ncs - 1) {
          const int kbase = t * KT;
          const bool masked =
              !(kbase + KT - 1 <= first_pos && (window <= 0 || kbase > last_pos - window));
          rpa_tile_softmax<KT, kW512Cols / 8, kScaled<C>>(
              sacc, sc_base + stage * KT * 4, kbase, qpos, slope, alibi != nullptr, masked,
              scale, window, soft_cap, o, m, l);
        }
      } else {
        w512_pv<Q>(sacc, rows, row_bytes, col0, hd - c0, o);
      }
    }
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
    if (nsplit == 1) {
      const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
#pragma unroll
      for (int n = 0; n < kW512Cols / 8; ++n) {
        const int d = c0 + col0 + 8 * n + 2 * c4;
        store_pair(out + orow[rr] * hd + d, d, hd,
                   pack2<Q>(o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv));
      }
    } else {  // unnormalized, with (m, l), for rpa_combine_kernel
      const long long wrow = (long long)split * num_tokens * num_q_heads + orow[rr];
#pragma unroll
      for (int n = 0; n < kW512Cols / 8; ++n) {
        const int d = c0 + col0 + 8 * n + 2 * c4;
        store_pair_f32(ws_o + wrow * hd + d, d, hd, o[n][2 * rr], o[n][2 * rr + 1]);
      }
      if (warp == 0 && c4 == 0 && cs == 0) {  // every slice's (m, l) are the same
        ws_ml[2 * wrow] = m[rr];
        ws_ml[2 * wrow + 1] = l[rr];
      }
    }
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device it runs on.
template <typename Q, typename C, bool FUSED>
cudaError_t w512_attributes() {
  static atoma::PerDevice state;
  return atoma::once_per_device(state, [] {
    return cudaFuncSetAttribute(rpa_w512_kernel<Q, C, FUSED>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                W512Tile<C>::kSmem);
  });
}

template <typename Q, typename C, bool FUSED>
int w512_blocks_per_sm() {
  if (w512_attributes<Q, C, FUSED>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rpa_w512_kernel<Q, C, FUSED>,
                                                    W512Tile<C>::kThreads,
                                                    W512Tile<C>::kSmem) != cudaSuccess)
    return -1;
  return n;
}

// The ragged entry (rpa_mma_entry's arguments): warps must be kW512Warps, a
// tile one m16 tile whose 4 warps split the columns.
template <typename Q, typename C>
int rpa_w512_entry(const void* q, const void* cache, const void* scales, const void* block_tables,
                   const void* seq_lens, const void* query_start_loc, const void* num_seqs,
                   const void* alibi, void* out, void* ws_o, void* ws_ml, int num_tokens,
                   int num_seq_slots, int num_q_heads, int num_kv_heads, int head_dim,
                   int max_pages, int block_size, int warps, int splits, int min_tiles,
                   float scale, int window, float soft_cap, void* stream) {
  if (num_tokens <= 0 || num_seq_slots <= 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0 || instance_dim(head_dim) != kW512 ||
      warps != kW512Warps || block_size <= 0 || block_size % 8 != 0 || splits < 1 ||
      min_tiles < 1 || (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t opt_in = w512_attributes<Q, C, false>();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int group = num_q_heads / num_kv_heads;
  const int slices = rpa_group_slices(group, 1);
  const int group_rows = (group + slices - 1) / slices;
  const int bq = kW512Rows / group_rows;
  const dim3 grid(num_tokens / bq + num_seq_slots, num_kv_heads * slices,
                  splits * column_slices(head_dim));
  rpa_w512_kernel<Q, C, false><<<grid, W512Tile<C>::kThreads, W512Tile<C>::kSmem,
                                 (cudaStream_t)stream>>>(
      (const Q*)q, nullptr, nullptr, (C*)cache, (__nv_bfloat16*)scales, nullptr, nullptr,
      (const int*)block_tables, (const int*)seq_lens, (const int*)query_start_loc,
      (const int*)num_seqs, (const float*)alibi, (Q*)out, (float*)ws_o, (float*)ws_ml,
      num_tokens, num_q_heads, num_kv_heads, head_dim, max_pages, block_size, 0, group,
      group_rows, splits, min_tiles, scale, window, soft_cap);
  return (int)cudaGetLastError();
}

// The fused entry (fused_split_entry's arguments): 1 to 16 q heads per kv
// head.
template <typename Q, typename C>
int fused_w512_entry(const void* q, const void* k_new, const void* v_new, void* cache,
                     void* scales, const void* scales_new, const void* slot_mapping,
                     const void* block_tables, const void* seq_lens,
                     const void* query_start_loc, const void* num_seqs, const void* alibi,
                     void* out, void* ws_o, void* ws_ml, int num_tokens, int num_seq_slots,
                     int num_q_heads, int num_kv_heads, int head_dim, int max_pages,
                     int block_size, long long num_slots, int splits, int min_tiles,
                     float scale, int window, float soft_cap, void* stream) {
  if (num_seq_slots <= 0 || num_tokens <= 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0 || instance_dim(head_dim) != kW512 ||
      splits < 1 || min_tiles < 1 || block_size <= 0 || block_size % 8 != 0 ||
      num_slots > 0x7FFFFFFFLL || (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int group = num_q_heads / num_kv_heads;
  if (group < 1 || group > kW512Rows) return (int)cudaErrorInvalidValue;
  const cudaError_t opt_in = w512_attributes<Q, C, true>();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(num_kv_heads, num_seq_slots, splits * column_slices(head_dim));
  rpa_w512_kernel<Q, C, true><<<grid, W512Tile<C>::kThreads, W512Tile<C>::kSmem,
                                (cudaStream_t)stream>>>(
      (const Q*)q, (const Q*)k_new, (const Q*)v_new, (C*)cache, (__nv_bfloat16*)scales,
      (const float*)scales_new, (const int*)slot_mapping, (const int*)block_tables,
      (const int*)seq_lens, (const int*)query_start_loc, (const int*)num_seqs,
      (const float*)alibi, (Q*)out, (float*)ws_o, (float*)ws_ml, num_tokens, num_q_heads,
      num_kv_heads, head_dim, max_pages, block_size, num_slots, group, group, splits,
      min_tiles, scale, window, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace atoma

// The width-512 entry points of one (query type Q, cache kind C) pair,
// with the narrower widths' signatures (ATOMA_RPA_MMA_ENTRIES and
// ATOMA_FUSED_SPLIT_ENTRIES) and names (SUFFIX ends in _w512, or
// _w512_f16): the ragged entry takes warps = 4 (one 16-row tile, its
// columns split over the 4 warps; a group past 16 in slices of at most 16
// rows), the fused one 1 to 16 q heads per kv head; a launch with splits >
// 1 is followed by atoma_paged_attention_split_combine.
#define ATOMA_W512_ENTRIES(SUFFIX, Q, C)                                                      \
  extern "C" int atoma_ragged_paged_attention_mma##SUFFIX(                                    \
      const void* q, const void* cache, const void* scales, const void* block_tables,        \
      const void* seq_lens, const void* query_start_loc, const void* num_seqs,               \
      const void* alibi, void* out, void* ws_o, void* ws_ml, int num_tokens,                 \
      int num_seq_slots, int num_q_heads, int num_kv_heads, int head_dim, int max_pages,     \
      int block_size, int warps, int splits, int min_tiles, float scale, int window,         \
      float soft_cap, void* stream) {                                                        \
    return atoma::rpa_w512_entry<Q, C>(q, cache, scales, block_tables, seq_lens,            \
                                       query_start_loc, num_seqs, alibi, out, ws_o, ws_ml,   \
                                       num_tokens, num_seq_slots, num_q_heads, num_kv_heads, \
                                       head_dim, max_pages, block_size, warps, splits,       \
                                       min_tiles, scale, window, soft_cap, stream);          \
  }                                                                                          \
  extern "C" int atoma_rpa_mma_blocks_per_sm##SUFFIX(int head_dim, int warps) {              \
    return atoma::instance_dim(head_dim) == atoma::kW512 && warps == atoma::kW512Warps       \
               ? atoma::w512_blocks_per_sm<Q, C, false>()                                    \
               : -1;                                                                         \
  }                                                                                          \
  extern "C" int atoma_fused_decode_attention_split##SUFFIX(                                  \
      const void* q, const void* k_new, const void* v_new, void* cache, void* scales,        \
      const void* scales_new, const void* slot_mapping, const void* block_tables,            \
      const void* seq_lens, const void* query_start_loc, const void* num_seqs,               \
      const void* alibi, void* out, void* ws_o, void* ws_ml, int num_tokens,                 \
      int num_seq_slots, int num_q_heads, int num_kv_heads, int head_dim, int max_pages,     \
      int block_size, long long num_slots, int splits, int min_tiles, float scale,           \
      int window, float soft_cap, void* stream) {                                            \
    return atoma::fused_w512_entry<Q, C>(                                                    \
        q, k_new, v_new, cache, scales, scales_new, slot_mapping, block_tables, seq_lens,    \
        query_start_loc, num_seqs, alibi, out, ws_o, ws_ml, num_tokens, num_seq_slots,       \
        num_q_heads, num_kv_heads, head_dim, max_pages, block_size, num_slots, splits,       \
        min_tiles, scale, window, soft_cap, stream);                                         \
  }                                                                                          \
  extern "C" int atoma_fused_split_blocks_per_sm##SUFFIX(int head_dim, int group) {          \
    return atoma::instance_dim(head_dim) == atoma::kW512 && group >= 1 &&                    \
                   group <= atoma::kW512Rows                                                 \
               ? atoma::w512_blocks_per_sm<Q, C, true>()                                     \
               : -1;                                                                         \
  }
