// Kernels B, D and E's fused variants for bf16 and fp16 queries: pure-decode
// attention with the KV-cache write fused in, each row's keys split across
// blocks. The same function as fused_decode_kernel (paged_attention.cuh) and
// as the plain version (ops/paged_attention.py: fused_decode_attention_plain):
// each decode row stores its new K/V slice in its slot (INT8: quantized with
// the token's per-slot scales from the whole K and V rows, or from
// scales_new where the caller passes them; e4m3: clipped to ±448 and
// rounded), then attends over its cache, the new position read back in the
// cache's type. Under tensor parallelism a rank's K and V rows hold only its
// kv heads, so the model passes each token's scales taken over every rank's
// heads in scales_new ([T, 2] f32, rounded through bf16; JAX's scales_new at
// ops/paged_attention.py:1143,1157).
//
// Replaces the TPU kernel atoma_infer_tpu/ops/paged_attention.py:_kernel
// (:139) with fuse_write=True, reached through ragged_paged_attention_fused
// (:1093) and ragged_paged_attention_fused_quant (:1132; e4m3 through
// _e4m3_decode :66-85).
//
// Bound: a decode row reads each cached K/V byte once for about 2 flops, so
// bytes (3.35 TB/s; a 1-byte cache halves them). At decode sizes a block
// waits on memory, so what the design does is keep the next keys in flight
// while a warp computes, read every line whole, and keep the longest row
// from setting the time:
//  * Split-KV across blocks: the grid is (kv head, sequence slot, split),
//    the kv heads of a row fastest, so that the blocks reading the same
//    slots' rows (each head a slice of a row) run together.
//    The host picks an upper bound on splits from shapes alone (sequence
//    slots × kv heads against the card's occupancy and the block table's
//    width: ops/paged_attention.py fused_split_plan); a block takes
//    min(splits, ceil(its row's 64-key tiles / min_tiles)) splits of its own
//    row's key range (rpa_split_count, the ragged kernel's rule), whole
//    tiles each, so a short row stays whole and a split past its row's
//    range exits at once. Unsplit rows store their output; split rows store
//    unnormalized (m, l, O) in an f32 workspace, merged in split order by
//    rpa_combine_kernel (paged_attention_mma.cuh, its own launch; no
//    atomics). No host read of seq_lens: the launch is CUDA-graph capturable.
//  * The write happens once: only the last split, whose range holds pos =
//    seq_len - 1, stores the new slice (and, for INT8, computes the row's
//    absmax or reads scales_new; its h = 0 block stores the slot's scales),
//    then attends it from
//    the cache after its barrier; the current slot's scales come from its
//    registers. No other split reads the slot, so blocks never race.
//  * Each warp takes 32 keys a round. Their K rows come through the warp's
//    own two-stage cp.async ring in shared memory: the next round's rows
//    are copied while this round computes, each copy instruction 16 bytes a
//    lane over whole rows. The block-table entry of a round is read two
//    rounds ahead.
//  * Q·Kᵀ and P·V on the tensor cores (mma.sync m16n8k16 bf16, f32 sums),
//    the G query heads as rows of an m16 tile (the rest zero), 32 keys a
//    round. Groups of 1 to 8 fill rows 0..G-1 and are instantiated one by
//    one; groups of 9 to 16 (Mistral-Large-2's 12, Llama-3.1-405B's 16)
//    fill both halves, heads 0-7 in rows 0-7 and 8..G-1 in rows 8-15, in
//    one instantiation (G = kFsTwoHalves) that takes the group at run
//    time. A lane then holds two score rows (heads gid and gid + 8), each
//    with its own online-softmax state and its own rescale of O; O costs
//    no register more (the m16n8 accumulator holds rows gid + 8 anyway),
//    Q's A fragments and the score state twice as many. Q·Kᵀ: each lane
//    reads its B fragments straight from its key's ring row, 16 bytes at a
//    time, with the dims taken in the order of those
//    reads (Q's A fragments follow the same order, built once); rows are
//    padded so that the reads meet no bank conflict. P·V: P's A fragments
//    are the score accumulators (rounded to bf16 after INT8's V scale, as
//    the TPU kernel does); V's B fragments are built in registers from one
//    coalesced load a key and lane, with output column n of n8 tile m
//    holding dim D/8 n + m, so that the column a lane holds is a contiguous
//    run of D/8 dims; keys are paired into B registers by prmt (bf16) or
//    widened in pairs (1-byte values, exact). No FMA per key and head is
//    left on the CUDA cores.
//  * The softmax state is a score row's: the lanes of head g hold its max
//    and a partial sum and rescale their own O accumulators. A key's INT8
//    scales come as one 32-bit load of its bf16 pair and reach the score
//    lanes through shared memory.
// Score order as the other kernels': dot (× the INT8 key scale) × scale,
// soft cap, ALiBi slope × (kpos − pos); f32 online softmax; INT8 folds the
// V scale into p before P·V.
//
// fp16 queries (Q = __half; bf16 is Q = __nv_bfloat16) run the same kernel
// on mma.sync's f16 form: q, k_new, v_new and out fp16, the 1-byte caches
// widened to fp16 (exact), P rounded to fp16; INT8 scales stay bf16.
// Any head dim from 1 to 256 over every cache kind, at the instantiation
// width D (32, 64, 96, 128 or 256; instance_dim) with the head dim passed at
// run time, as paged_attention_mma.cuh takes it (257 to 512:
// paged_attention_w512.cuh). A head dim below its width runs the PAD
// instantiation, one a width, G = kFsTwoHalves (any group of 1 to 16 at run
// time): the ring's K columns and q_s's from head_dim to D are zero
// (cp.async's source size of 0), a V run's elements past head_dim are 0 and
// never read (load_run_padded), the output columns past head_dim are never
// stored, and a head of no multiple of 16 bytes is copied and read in
// narrower pieces (down to single bytes for an odd head of a 1-byte cache;
// q_s, the write and the output go element by element, so odd head dims
// need nothing more); the other instantiations run the code they ran
// before. A source instantiates the
// narrow widths (32, 64, 128), the wide ones (96, 256) or both
// (HeadDimSet). At D = 96 a K row is 12 16-byte pieces
// in the queries' dtype and 6 in a 1-byte cache, neither of which divides a
// warp's 32 lanes, so the ring's copies walk the round's pieces key-major.
// A 192-byte row already starts 64 bytes from the next modulo 128, so a
// load phase's two keys meet no bank conflict unpadded, and a lane's V run
// of 12 dims (24 bytes, 8-byte aligned) is read 8 bytes at a time. A
// 96-byte row is no multiple of 64 bytes, so Q·Kᵀ reads it in 8-byte pieces
// (three rounds of 32 bytes; four keys a load phase, 32 bytes apart modulo
// 128 unpadded), and its V run of 12 bytes is read 4 bytes at a time. At D =
// 256 O takes 128 registers a thread, so V's runs of 32 dims are read in two
// halves; the ring is 144 KB a block in the queries' dtype (one block an SM)
// and 80 KB in a 1-byte cache (two); what does not fit spills (the build log
// counts it). The two-half instantiation spills at D = 256, and in a 1-byte
// cache, held to three blocks an SM, at D = 128 too (60-76 bytes on an H100
// build).
//
// Measurement hooks, all off in the build the port uses (ops/cuda_lib.py);
// tools/rpa_ablation.py --mode fused builds and times them:
//   ATOMA_FS_MINB=n    at least n resident blocks an SM in __launch_bounds__;
//   ATOMA_FS_SEQ_MAJOR the grid (sequence slot, kv head, split) instead;
//   ATOMA_FS_SHAPES_D128_G4  only D = 128 and 64 at G = 4 instantiated.

#pragma once

#include "paged_attention_mma.cuh"

namespace atoma {

constexpr int kFsWarps = 4;   // warps a block; a warp takes 32 keys a round
// The G of the instantiation that fills both halves of the m16 tile, for
// groups of 9 to 16 passed at run time.
constexpr int kFsTwoHalves = 16;
// Resident blocks an SM the compiler must leave room for: 3 for 1-byte
// caches (at most 170 registers a thread; uncapped, INT8 at D = 128 fits 2
// blocks an SM and runs 11% slower on an H100: tools/rpa_ablation.py) up to
// D = 128, 2 at D = 256, where shared memory holds no third block and O
// alone takes 128 registers; none for bf16, whose ring already holds a D =
// 128 block to 3.
#ifdef ATOMA_FS_MINB
template <typename C, int D>
constexpr int kFsMinBlocks = ATOMA_FS_MINB;
#else
template <typename C, int D>
constexpr int kFsMinBlocks = sizeof(C) == 1 ? (D > 128 ? 2 : 3) : 1;
#endif

template <typename C, int D>
struct FsTile {
  static constexpr int kChunks = D * (int)sizeof(C) / 16;  // 16-byte pieces of a K row
  static constexpr int kBytes = D * (int)sizeof(C);
  // Bytes a lane reads from its key's row for one Q·Kᵀ piece, four lanes a
  // row: 16 where the row is a multiple of 64 bytes, else 8 (1-byte caches
  // at D = 32 and 96).
  static constexpr int kPiece = kBytes % 64 == 0 ? 16 : 8;
  // A K row in the ring, padded so that the rows one shared load phase
  // reads (2 keys of 16-byte pieces, or 4 keys of 8-byte ones) start 16 or
  // 8 banks apart: no bank conflict.
  static constexpr int kRow = kPiece == 16 ? (kBytes + 64 + 127) / 128 * 128 - 64 : kBytes;
  static constexpr int kStage = 32 * kRow;                  // a round's 32 K rows
  static constexpr int kRing = 2 * kStage;                  // a warp's two stages
};

// The block's dynamic shared memory: the warps' rings, which the warps'
// partial outputs (NW G D floats) reuse after the key loop.
template <typename C, int D, int G>
constexpr int fs_smem_bytes() {
  return kFsWarps * FsTile<C, D>::kRing > kFsWarps * G * D * 4 ? kFsWarps * FsTile<C, D>::kRing
                                                                : kFsWarps * G * D * 4;
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// A lane's run of N contiguous cache elements of one V row as raw words
// (N sizeof(C) bytes: 4 to 32), zero where the key is past the range.
template <typename C, int N>
struct VRun {
  static constexpr int kWords = N * (int)sizeof(C) / 4;
  uint32_t w[kWords];
};

// Runs of a multiple of 16 bytes are read 16 bytes at a time; of 8 bytes
// (24 at D = 96 in bf16: a run starts 24 gid bytes into its row, so only 8
// are aligned), 8 at a time; else 4 (12 at D = 96 in a 1-byte cache).
template <typename C, int N>
__device__ __forceinline__ VRun<C, N> load_run(const C* p, bool valid) {
  VRun<C, N> r;
#pragma unroll
  for (int i = 0; i < VRun<C, N>::kWords; ++i) r.w[i] = 0u;
  if (!valid) return r;
  if constexpr (VRun<C, N>::kWords % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VRun<C, N>::kWords; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(p) + 4 * i);
      r.w[i] = v.x, r.w[i + 1] = v.y, r.w[i + 2] = v.z, r.w[i + 3] = v.w;
    }
  } else if constexpr (VRun<C, N>::kWords % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VRun<C, N>::kWords; i += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(reinterpret_cast<const char*>(p) + 4 * i);
      r.w[i] = v.x, r.w[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VRun<C, N>::kWords; ++i)
      r.w[i] = *reinterpret_cast<const uint32_t*>(reinterpret_cast<const char*>(p) + 4 * i);
  }
  return r;
}

// load_run's piece: 16, 8 or 4 bytes.
template <typename C, int N>
struct RunPiece {
  static constexpr int kBytes =
      VRun<C, N>::kWords % 4 == 0 ? 16 : VRun<C, N>::kWords % 2 == 0 ? 8 : 4;
};

// load_run at a padded head dim: the run's first nbytes (those inside the
// head), the rest 0. Where the head's copy width cw is at least load_run's
// piece, in those pieces; else (the run then starts only cw aligned) in
// 4-byte reads, or 2-byte ones at a copy width of 2, or 1-byte ones at 1.
template <typename C, int N>
__device__ __forceinline__ VRun<C, N> load_run_padded(const C* p, bool valid, int nbytes,
                                                      int cw) {
  constexpr int kWords = VRun<C, N>::kWords, kPiece = RunPiece<C, N>::kBytes;
  VRun<C, N> r;
  const char* b = reinterpret_cast<const char*>(p);
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = 0u;
  if (!valid) return r;
  if (cw >= kPiece) {
#pragma unroll
    for (int i = 0; i < kWords; i += kPiece / 4) {
      if (4 * i >= nbytes) continue;
      if constexpr (kPiece == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(b + 4 * i);
        r.w[i] = v.x, r.w[i + 1] = v.y, r.w[i + 2] = v.z, r.w[i + 3] = v.w;
      } else if constexpr (kPiece == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(b + 4 * i);
        r.w[i] = v.x, r.w[i + 1] = v.y;
      } else {
        r.w[i] = *reinterpret_cast<const uint32_t*>(b + 4 * i);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      if (4 * i >= nbytes) continue;
      if (cw >= 4) {
        r.w[i] = *reinterpret_cast<const uint32_t*>(b + 4 * i);
      } else if (cw == 2) {
        const uint32_t hi =
            4 * i + 2 < nbytes ? *reinterpret_cast<const uint16_t*>(b + 4 * i + 2) : 0u;
        r.w[i] = *reinterpret_cast<const uint16_t*>(b + 4 * i) | hi << 16;
      } else {  // an odd head of a 1-byte cache
        uint32_t w = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * i + k < nbytes) w |= (uint32_t)(uint8_t)b[4 * i + k] << (8 * k);
        r.w[i] = w;
      }
    }
  }
  return r;
}

// Element m of two runs (two keys' values of one dim) as a Q pair, lo in
// the low half: the B register of P·V's mma (exact for every cache kind).
template <typename C, typename Q>
__device__ __forceinline__ uint32_t key_pair(const uint32_t* lo, const uint32_t* hi, int m) {
  if constexpr (sizeof(C) == 2) {
    return __byte_perm(lo[m >> 1], hi[m >> 1], m & 1 ? 0x7632 : 0x5410);
  } else if constexpr (kScaled<C>) {
    return widen_pair_t<Q>(lo[m >> 2], hi[m >> 2], m & 3);
  } else {
    const int j = m & 3;
    return widen2<C, Q>(__byte_perm(lo[m >> 2], hi[m >> 2], j | ((4 + j) << 4)), 0);
  }
}

// q, k_new, v_new: Q [T, H, head_dim] (H = Hq or Hk); cache [pages,
// block_size, 2 Hk head_dim] of C; scales: bf16 [pages, block_size, 2]
// (INT8) or null; scales_new: f32 [T, 2] (INT8, the new tokens' scales) or
// null; out Q [T, Hq, head_dim]; ws_o f32 [splits, T, Hq, head_dim] and
// ws_ml f32 [splits, T, Hq, 2] when splits > 1; group: the query heads a kv
// head (G, or 9 to 16 when G is kFsTwoHalves); head_dim at most D.
// Grid (Hk, sequence slots, splits), kFsWarps * 32 threads,
// fs_smem_bytes<C, D, G>() bytes of dynamic shared memory.
template <typename Q, typename C, int D, int G, bool PAD = false>
__global__ void __launch_bounds__(kFsWarps * 32, kFsMinBlocks<C, D>) fused_split_kernel(
    const Q* __restrict__ q, const Q* __restrict__ k_new,
    const Q* __restrict__ v_new, C* cache, __nv_bfloat16* scales,
    const float* __restrict__ scales_new, const int* __restrict__ slot_mapping,
    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    const int* __restrict__ query_start_loc,
    const int* __restrict__ num_seqs, const float* __restrict__ alibi,
    Q* __restrict__ out, float* __restrict__ ws_o, float* __restrict__ ws_ml,
    int num_tokens, int num_kv_heads, int head_dim, int max_pages, int block_size,
    long long num_slots, int splits, int min_tiles, float scale, int window, float soft_cap,
    int group) {
  static_assert(G <= 8 || G == kFsTwoHalves, "one half of the tile, or both");
  using L = FsTile<C, D>;
  constexpr int NW = kFsWarps;
  constexpr int NH = G == kFsTwoHalves ? 2 : 1;  // halves of the m16 tile the heads fill
  const int ng = NH == 2 ? group : G;            // query heads a kv head
  constexpr int NT = D / 8;  // P·V's n8 tiles; a lane's V run is NT dims
  constexpr int VC = NT > 16 ? 16 : NT;  // dims of a run loaded at once
  constexpr int EPL = L::kPiece / (int)sizeof(C);  // K elements a lane's piece
  constexpr int SPC = EPL / 4;                     // k16 steps a piece feeds
  extern __shared__ __align__(16) unsigned char fs_ring[];
  __shared__ float q_s[G * D];
  __shared__ float m_s[NW][G];
  __shared__ float l_s[NW][G];
  __shared__ float red_s[2 * NW];
  __shared__ float2 kv_s[NW][32];  // INT8: a round's (K, V) scales by key

#ifdef ATOMA_FS_SEQ_MAJOR
  const int s = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
#else
  const int h = blockIdx.x, s = blockIdx.y, split = blockIdx.z;
#endif
  if (s >= num_seqs[0]) return;
  const int t = query_start_loc[s];
  if (query_start_loc[s + 1] - t != 1) return;  // decode: one query token
  const int seq_len = seq_lens[s];
  const int pos = seq_len - 1;
  // This block's share of the row's keys: whole 64-key tiles, the ragged
  // kernel's split rule, the window's first key to pos.
  int t_lo, n_tiles;
  rpa_tile_keys(pos, pos, window, t_lo, n_tiles);
  const int nsplit = rpa_split_count(n_tiles, splits, min_tiles);
  if (split >= nsplit) return;
  const int kv_begin = window > 0 ? max(0, pos - window + 1) : 0;
  const int key_lo =
      max(kv_begin, (t_lo + (int)((long long)n_tiles * split / nsplit)) * kRpaKT);
  const int key_hi =
      min(seq_len, (t_lo + (int)((long long)n_tiles * (split + 1) / nsplit)) * kRpaKT);
  const bool last = split == nsplit - 1;  // the split that holds pos

  const int num_q_heads = num_kv_heads * ng;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hd = PAD ? head_dim : D;  // D itself but at a padded head dim
  const long long row_stride = 2LL * num_kv_heads * hd;
  const long long q_base = ((long long)t * num_q_heads + (long long)h * ng) * hd;
  for (int i = tid; i < ng * D; i += NW * 32) {
    if constexpr (PAD) {  // q_s is D wide, 0 past head_dim
      const int g = i / D, d = i - g * D;
      q_s[i] = d < hd ? to_float(q[q_base + g * hd + d]) : 0.f;
    } else {
      q_s[i] = to_float(q[q_base + i]);
    }
  }

  const long long slot = slot_mapping[t];
  const bool write = last && slot >= 0 && slot < num_slots;
  float k_sc = 1.f, v_sc = 1.f, inv_k = 1.f, inv_v = 1.f;
  if constexpr (kScaled<C>) {
    if (last) {  // block-uniform: row_absmax holds a barrier
      __nv_bfloat16 bk, bv;
      if (scales_new != nullptr) {  // grid-uniform
        bk = __float2bfloat16_rn(scales_new[2 * t]);
        bv = __float2bfloat16_rn(scales_new[2 * t + 1]);
      } else {
        const Q* kn_row = k_new + (long long)t * num_kv_heads * hd;
        const Q* vn_row = v_new + (long long)t * num_kv_heads * hd;
        float mk, mv;
        row_absmax(kn_row, vn_row, num_kv_heads * hd, red_s, mk, mv);
        bk = kv_scale(mk);
        bv = kv_scale(mv);
      }
      k_sc = __bfloat162float(bk);
      v_sc = __bfloat162float(bv);
      inv_k = 1.f / k_sc;
      inv_v = 1.f / v_sc;
      if (write && h == 0 && tid == 0) {
        scales[2 * slot] = bk;
        scales[2 * slot + 1] = bv;
      }
    }
  }
  if (write) {
    const Q* kn = k_new + ((long long)t * num_kv_heads + h) * hd;
    const Q* vn = v_new + ((long long)t * num_kv_heads + h) * hd;
    C* dst = cache + slot * row_stride + (long long)h * 2 * hd;
    for (int i = tid; i < 2 * hd; i += NW * 32)
      dst[i] = i < hd ? encode<C>(to_float(kn[i]), inv_k) : encode<C>(to_float(vn[i - hd]), inv_v);
  }
  __syncthreads();  // q_s staged; the new slice stored (last split)

  // Q·Kᵀ on the tensor cores (mma.sync m16n8k16 on Q, f32 sums): A holds
  // the query heads as rows 0..G-1 of an m16 tile (two halves: heads 0-7
  // in rows 0-7, 8..group-1 in rows 8-15; the rest zero), B a key's K row
  // as a column. k runs over the dims in the order the K
  // fragments read them: lane (gid, tig) reads kPiece bytes of its key's
  // row at byte 4 kPiece c + kPiece tig, EPL elements feeding SPC k16 steps
  // (step c SPC + i: dims d = 4 EPL c + EPL tig + 4 i, b0 = (d, d + 1), b1 =
  // (d + 2, d + 3), 1-byte values widened to Q exactly by widen2);
  // A's k index follows the same lanes, so the sum is the dot product. The
  // lane's rows of the score tile are head gid (half r = 0) and, with two
  // halves, head gid + 8 (r = 1): each row's online-softmax state (m, l) is
  // the lane's, l a partial sum over the lane's keys.
  const int gid = lane >> 2, tig = lane & 3;
  // A's registers of each k16 step by half: (a0, a2) for row gid, (a1, a3)
  // for row gid + 8 (zero with one half: rows 8-15 then hold no head).
  uint32_t qf[D / 16][2 * NH];
  float slope[NH], m_row[NH], l_row[NH];
#pragma unroll
  for (int r = 0; r < NH; ++r) {
    const int g = gid + 8 * r;
#pragma unroll
    for (int st = 0; st < D / 16; ++st) {
      const int d = (st / SPC) * 4 * EPL + tig * EPL + 4 * (st % SPC);
      qf[st][2 * r] = g < ng ? pack2<Q>(q_s[g * D + d], q_s[g * D + d + 1]) : 0u;
      qf[st][2 * r + 1] = g < ng ? pack2<Q>(q_s[g * D + d + 2], q_s[g * D + d + 3]) : 0u;
    }
    slope[r] = alibi != nullptr && g < ng ? alibi[h * ng + g] : 0.f;
    m_row[r] = kNegInf;
    l_row[r] = 0.f;
  }
  // P·V on the tensor cores too: O (rows the heads) += P (A: the score
  // accumulators, rounded to Q after INT8's V scale) · V (B: keys x
  // dims). Output column n of n8 tile m is dim NT n + m, so the B column a
  // lane holds, gid, is the contiguous run of dims NT gid .. NT gid + NT - 1
  // of each of its keys: one coalesced load a key, the keys paired into B
  // registers by prmt (bf16) or widened in pairs (1-byte).
  float o[NT][4];
#pragma unroll
  for (int mt = 0; mt < NT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;
  const int* bt = block_tables + (long long)s * max_pages;
  const C* kbase = cache + (long long)h * 2 * hd;
  const C* vrun = kbase + hd + NT * gid;
  // At a padded head dim (PAD): a K row's bytes and copy width, and how
  // much of each of the lane's V runs lies inside the head.
  const int head_bytes = hd * (int)sizeof(C);
  const int cw = copy_width(head_bytes);
  int run_bytes[NT / VC];  // a V run's bytes inside the head, by c0
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += VC)
    run_bytes[c0 / VC] = min(VC, max(0, hd - NT * gid - c0)) * (int)sizeof(C);

  // A lane's key of the round starting at `base` is base + lane; its slot
  // (an int: the entry point takes caches of fewer than 2^31 slots).
  auto slot_at = [&](int base, int page) {
    return base + lane < key_hi ? page * block_size + (base + lane) % block_size : 0;
  };
  auto page_at = [&](int base) {
    return base + lane < key_hi ? bt[(base + lane) / block_size] : 0;
  };
  // The warp's ring: copy c of a round is chunk lane % kChunks of key
  // c * (32 / kChunks) + lane / kChunks, whose slot comes from that key's
  // lane. Keys past the range are zero-filled. At D = 96 a row's 12 chunks
  // (6 in a 1-byte cache) do not divide the lanes: there copy c is piece p
  // = 32 c + lane of the round's key-major pieces, chunk p % kChunks of key
  // p / kChunks (kWalk).
  constexpr bool kWalk = 32 % L::kChunks != 0;
  const uint32_t ring = smem_addr(fs_ring) + warp * L::kRing;
  // At a padded head dim (PAD) a chunk past head_dim is zero-filled and
  // reads nothing, and a head of no multiple of 16 bytes is copied in
  // copy_width pieces (cp_async_part) by a loop of its own.
  const int lane_bytes = PAD && !kWalk ? piece_bytes(lane % L::kChunks, head_bytes) : 16;
  const char* kbytes = reinterpret_cast<const char*>(kbase) +
                       (kWalk || lane_bytes == 0 ? 0 : (lane % L::kChunks) * 16);
  auto issue = [&](int base, int kslot, int stage) {
    if constexpr (PAD) {
      if (cw != 16) {
#pragma unroll 1
        for (int c = 0; c < L::kChunks; ++c) {
          int key, chunk;
          if constexpr (!kWalk) {
            key = c * (32 / L::kChunks) + lane / L::kChunks, chunk = lane % L::kChunks;
          } else {
            key = (32 * c + lane) / L::kChunks, chunk = (32 * c + lane) % L::kChunks;
          }
          const long long ks = __shfl_sync(0xffffffffu, kslot, key);
          const int n = base + key < key_hi ? piece_bytes(chunk, head_bytes) : 0;
          cp_async_part(ring + stage * L::kStage + key * L::kRow + chunk * 16,
                        n > 0 ? reinterpret_cast<const char*>(kbase) + chunk * 16 +
                                    ks * row_stride * (long long)sizeof(C)
                              : reinterpret_cast<const char*>(kbase),
                        n, cw);
        }
        return;
      }
    }
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
      if constexpr (!kWalk) {
        const int key = c * (32 / L::kChunks) + lane / L::kChunks;
        const long long ks = __shfl_sync(0xffffffffu, kslot, key);
        const bool ok = base + key < key_hi && (!PAD || lane_bytes > 0);
        cp_async16(ring + stage * L::kStage + key * L::kRow + (lane % L::kChunks) * 16,
                   ok ? kbytes + ks * row_stride * (long long)sizeof(C) : kbytes, ok);
      } else {
        const int p = 32 * c + lane, key = p / L::kChunks, chunk = p % L::kChunks;
        const long long ks = __shfl_sync(0xffffffffu, kslot, key);
        const bool ok = base + key < key_hi && (!PAD || 16 * chunk < head_bytes);
        cp_async16(ring + stage * L::kStage + key * L::kRow + chunk * 16,
                   ok ? kbytes + chunk * 16 + ks * row_stride * (long long)sizeof(C) : kbytes,
                   ok);
      }
    }
  };

  int base = key_lo + warp * 32;
  int kslot = slot_at(base, page_at(base));
  int page = page_at(base + NW * 32);  // the next round's entry
  if (base < key_hi) issue(base, kslot, 0);
  cp_async_commit();
  for (int it = 0; base < key_hi; base += NW * 32, ++it) {
    const int kpos = base + lane;
    const bool valid = kpos < key_hi;
    const int next_slot = slot_at(base + NW * 32, page);
    page = page_at(base + 2 * NW * 32);
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kScaled<C>) {  // the key's (K, V) scale pair, one 32-bit load
      if (kpos == pos) {
        ksc = k_sc;
        vsc = v_sc;
      } else if (valid) {
        const uint32_t pair = *reinterpret_cast<const uint32_t*>(scales + 2LL * kslot);
        ksc = __uint_as_float(pair << 16);
        vsc = __uint_as_float(pair & 0xFFFF0000u);
      }
    }
    // Copy the next round's K rows, then wait for this round's.
    if (base + NW * 32 < key_hi) issue(base + NW * 32, next_slot, (it + 1) & 1);
    cp_async_commit();
    if constexpr (kScaled<C>) kv_s[warp][lane] = make_float2(ksc, vsc);
    cp_async_wait<1>();
    __syncwarp();  // the round's K rows (and INT8 scales) are in shared memory

    // S = Q·Kᵀ for the round's 32 keys: n8 tile j is keys 8 j .. 8 j + 7;
    // the lane holds head gid's scores of keys 8 j + 2 tig + {0, 1} in
    // sc[j][0..1], and head gid + 8's in sc[j][2..3].
    float sc[4][4];
    const uint32_t stage = ring + (it & 1) * L::kStage;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t row = stage + (8 * j + gid) * L::kRow + L::kPiece * tig;
#pragma unroll
      for (int c = 0; c < L::kBytes / (4 * L::kPiece); ++c) {
        uint32_t w[4];
        if constexpr (L::kPiece == 16) {
          const uint4 w4 = lds128(row + 64 * c);
          w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
        } else {
          const uint2 w2 = lds64(row + 32 * c);
          w[0] = w2.x, w[1] = w2.y;
        }
#pragma unroll
        for (int i = 0; i < SPC; ++i) {
          const int st = c * SPC + i;
          uint32_t b0, b1;
          if constexpr (sizeof(C) == 2) {
            b0 = w[2 * i];
            b1 = w[2 * i + 1];
          } else {
            b0 = widen2<C, Q>(w[i], 0);
            b1 = widen2<C, Q>(w[i], 2);
          }
          uint32_t a[4] = {qf[st][0], 0u, qf[st][1], 0u};
          if constexpr (NH == 2) a[1] = qf[st][2], a[3] = qf[st][3];
          if (st == 0)
            mma16_fresh<Q>(sc[j], a, b0, b1);
          else
            mma16<Q>(sc[j], a, b0, b1);
        }
      }
    }
    // Scores in the plain version's order, then each row's online softmax
    // over the lane quad (the row's 32 keys: 8 a lane). Half r's scores are
    // sc[j][2 r + e].
    float mx[NH], alpha[NH];
#pragma unroll
    for (int r = 0; r < NH; ++r) mx[r] = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * tig + e;
        float ks = 1.f;
        if constexpr (kScaled<C>) ks = kv_s[warp][key].x;
#pragma unroll
        for (int r = 0; r < NH; ++r) {
          float& v = sc[j][2 * r + e];
          v = base + key < key_hi
                  ? score_mod(v * ks, scale, soft_cap, slope[r], base + key, pos)
                  : kNegInf;
          mx[r] = fmaxf(mx[r], v);
        }
      }
#pragma unroll
    for (int r = 0; r < NH; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);  // finite: the round's first key is valid
      alpha[r] = expf(m_row[r] - m_new);
      l_row[r] *= alpha[r];
      m_row[r] = m_new;
    }
    // P's A registers of the round's two k16 steps by half: (a0, a2), and
    // (a1, a3) for rows 8-15.
    uint32_t pa[NH][2][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < NH; ++r) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sc[j][2 * r + e] - m_row[r]);
          l_row[r] += p;
          float vs = 1.f;
          if constexpr (kScaled<C>) vs = kv_s[warp][8 * j + 2 * tig + e].y;
          pv[e] = p * vs;  // INT8: V's scale folds into p
        }
        pa[r][j >> 1][j & 1] = pack2<Q>(pv[0], pv[1]);
      }
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      o[mt][0] *= alpha[0], o[mt][1] *= alpha[0];
      if constexpr (NH == 2) o[mt][2] *= alpha[1], o[mt][3] *= alpha[1];
    }
    // P·V, k16 step q: keys 16 q + 2 tig + {0, 1} (b0) and + {8, 9} (b1);
    // at D = 256 the runs in two halves of VC = 16 dims, so that the four
    // keys' pieces take 32 registers beside O's 128.
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int c0 = 0; c0 < NT; c0 += VC) {
        VRun<C, VC> v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = 16 * q + 2 * tig + (i & 1) + 8 * (i >> 1);
          const long long vs = __shfl_sync(0xffffffffu, kslot, key);
          if constexpr (PAD) {
            v[i] = load_run_padded<C, VC>(vrun + vs * row_stride + c0, base + key < key_hi,
                                          run_bytes[c0 / VC], cw);
          } else {
            v[i] = load_run<C, VC>(vrun + vs * row_stride + c0, base + key < key_hi);
          }
        }
        uint32_t a[4] = {pa[0][q][0], 0u, pa[0][q][1], 0u};
        if constexpr (NH == 2) a[1] = pa[1][q][0], a[3] = pa[1][q][1];
#pragma unroll
        for (int mt = 0; mt < VC; ++mt)
          mma16<Q>(o[c0 + mt], a, key_pair<C, Q>(v[0].w, v[1].w, mt),
                   key_pair<C, Q>(v[2].w, v[3].w, mt));
      }
    }
    __syncwarp();  // this round's stage (and INT8 scales) are read: both may be refilled
    kslot = next_slot;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < NH; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }

  // Merge the warps' (m, l, O) states; O goes through the rings' shared
  // memory, free now.
  float* acc_s = reinterpret_cast<float*>(fs_ring);
  __syncthreads();  // every warp is done with its ring
#pragma unroll
  for (int r = 0; r < NH; ++r) {
    const int g = gid + 8 * r;
    if (g < ng) {
      if (tig == 0) {
        m_s[warp][g] = m_row[r];
        l_s[warp][g] = l_row[r];
      }
#pragma unroll
      for (int mt = 0; mt < NT; ++mt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc_s[(warp * ng + g) * D + NT * (2 * tig + e) + mt] = o[mt][2 * r + e];
    }
  }
  __syncthreads();
  const long long row0 = (long long)t * num_q_heads + (long long)h * ng;
  // The output's W = head_dim dims a head (the constant D but at PAD);
  // acc_s is D wide.
  auto store = [&](auto width) {
    const int W = width;
    for (int i = tid; i < ng * W; i += NW * 32) {
      const int g = i / W, d = i - g * W;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, m_s[w][g]);
      float sum = 0.f, ov = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = m_s[w][g] == kNegInf ? 0.f : expf(m_s[w][g] - mx);
        sum += l_s[w][g] * c;
        ov += acc_s[(w * ng + g) * D + d] * c;
      }
      if (nsplit == 1) {
        out[q_base + i] = from_float<Q>(sum > 0.f ? ov / sum : 0.f);
      } else {  // unnormalized, with (m, l), for rpa_combine_kernel
        const long long wrow = (long long)split * num_tokens * num_q_heads + row0 + g;
        ws_o[wrow * W + d] = ov;
        if (d == 0) {
          ws_ml[2 * wrow] = mx;
          ws_ml[2 * wrow + 1] = sum;
        }
      }
    }
  };
  if constexpr (PAD) {
    store(hd);
  } else {
    store(FixedDim<D>{});
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once per
// device and library: internal linkage, so that another library built from
// this header (the measurement tools' variants) keeps its own flags.
namespace {
template <typename Q, typename C, int D, int G, bool PAD = false>
cudaError_t fused_split_attributes() {
  static atoma::PerDevice state;
  return atoma::once_per_device(state, [] {
    return cudaFuncSetAttribute(fused_split_kernel<Q, C, D, G, PAD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                fs_smem_bytes<C, D, G>());
  });
}
}  // namespace

template <typename Q, typename C, int D, int G, bool PAD = false>
int fused_split_blocks_per_sm() {
  if (fused_split_attributes<Q, C, D, G, PAD>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_split_kernel<Q, C, D, G, PAD>,
                                                    kFsWarps * 32,
                                                    fs_smem_bytes<C, D, G>()) != cudaSuccess)
    return -1;
  return n;
}

template <typename Q, typename C, int DIMS>
int fused_split_entry(const void* q, const void* k_new, const void* v_new, void* cache,
                      void* scales, const void* scales_new, const void* slot_mapping,
                      const void* block_tables, const void* seq_lens,
                      const void* query_start_loc, const void* num_seqs,
                      const void* alibi, void* out, void* ws_o, void* ws_ml, int num_tokens,
                      int num_seq_slots, int num_q_heads, int num_kv_heads, int head_dim,
                      int max_pages, int block_size, long long num_slots, int splits,
                      int min_tiles, float scale, int window, float soft_cap, void* stream) {
  if (num_seq_slots <= 0 || num_tokens <= 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0 || splits < 1 || min_tiles < 1 ||
      block_size <= 0 || num_slots > 0x7FFFFFFFLL ||
      (splits > 1 && (ws_o == nullptr || ws_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int group = num_q_heads / num_kv_heads;
  // The instantiation: the group itself up to 8, both halves of the tile
  // from 9 to 16; the width that holds the head dim, and below it the PAD
  // instantiation of both halves, which takes any group to 16.
  const int inst = group <= 8 ? group : (group <= kFsTwoHalves ? kFsTwoHalves : 0);
  const int dp = instance_dim(head_dim);
  const bool pad = head_dim != dp;
#ifdef ATOMA_FS_SEQ_MAJOR
  const dim3 grid(num_seq_slots, num_kv_heads, splits);
#else
  const dim3 grid(num_kv_heads, num_seq_slots, splits);
#endif
  cudaStream_t st = (cudaStream_t)stream;
#define ATOMA_FS_P(D, G, P)                                                                    \
  if (dp == D && (P ? pad && inst != 0 : !pad && inst == G)) {                                 \
    const cudaError_t opt_in = fused_split_attributes<Q, C, D, G, P>();                        \
    if (opt_in != cudaSuccess) return (int)opt_in;                                             \
    fused_split_kernel<Q, C, D, G, P><<<grid, kFsWarps * 32, fs_smem_bytes<C, D, G>(), st>>>( \
        (const Q*)q, (const Q*)k_new, (const Q*)v_new,                                         \
        (C*)cache, (__nv_bfloat16*)scales, (const float*)scales_new, (const int*)slot_mapping,  \
        (const int*)block_tables,                                                              \
        (const int*)seq_lens, (const int*)query_start_loc, (const int*)num_seqs,               \
        (const float*)alibi, (Q*)out, (float*)ws_o, (float*)ws_ml, num_tokens,                \
        num_kv_heads, head_dim, max_pages, block_size, num_slots, splits, min_tiles, scale,    \
        window, soft_cap, group);                                                              \
    return (int)cudaGetLastError();                                                            \
  }
#define ATOMA_FS(D, G) ATOMA_FS_P(D, G, false)
#ifdef ATOMA_FS_SHAPES_D128_G4
  ATOMA_FS(64, 4)
  ATOMA_FS(128, 4)
#else
#define ATOMA_FS_D(D) \
  ATOMA_FS(D, 1) ATOMA_FS(D, 2) ATOMA_FS(D, 3) ATOMA_FS(D, 4) ATOMA_FS(D, 5) ATOMA_FS(D, 6) \
  ATOMA_FS(D, 7) ATOMA_FS(D, 8) ATOMA_FS(D, kFsTwoHalves) ATOMA_FS_P(D, kFsTwoHalves, true)
  if constexpr ((DIMS & kNarrowDims) != 0) {
    ATOMA_FS_D(32)
    ATOMA_FS_D(64)
    ATOMA_FS_D(128)
  }
  if constexpr ((DIMS & kWideDims) != 0) {
    ATOMA_FS_D(96)
    ATOMA_FS_D(256)
  }
#undef ATOMA_FS_D
#endif
#undef ATOMA_FS
#undef ATOMA_FS_P
  return (int)cudaErrorInvalidValue;
}

template <typename Q, typename C, int DIMS>
int fused_split_blocks_per_sm_entry(int head_dim, int group) {
  const int dp = instance_dim(head_dim);
#ifdef ATOMA_FS_SHAPES_D128_G4
  if ((dp == 64 || dp == 128) && group == 4)
    return dp == 64 ? fused_split_blocks_per_sm<Q, C, 64, 4>()
                          : fused_split_blocks_per_sm<Q, C, 128, 4>();
  return -1;
#endif
#define ATOMA_FS_OCC(D)                                              \
  if (dp == D && head_dim != dp)                                     \
    return group >= 1 && group <= kFsTwoHalves                       \
               ? fused_split_blocks_per_sm<Q, C, D, kFsTwoHalves, true>() \
               : -1;                                                 \
  if (dp == D) {                                                     \
    switch (group) {                                                 \
      case 1: return fused_split_blocks_per_sm<Q, C, D, 1>();        \
      case 2: return fused_split_blocks_per_sm<Q, C, D, 2>();        \
      case 3: return fused_split_blocks_per_sm<Q, C, D, 3>();        \
      case 4: return fused_split_blocks_per_sm<Q, C, D, 4>();        \
      case 5: return fused_split_blocks_per_sm<Q, C, D, 5>();        \
      case 6: return fused_split_blocks_per_sm<Q, C, D, 6>();        \
      case 7: return fused_split_blocks_per_sm<Q, C, D, 7>();        \
      case 8: return fused_split_blocks_per_sm<Q, C, D, 8>();        \
      default:                                                       \
        return group > 8 && group <= kFsTwoHalves                    \
                   ? fused_split_blocks_per_sm<Q, C, D, kFsTwoHalves>() \
                   : -1;                                             \
    }                                                                \
  }
  if constexpr ((DIMS & kNarrowDims) != 0) {
    ATOMA_FS_OCC(32)
    ATOMA_FS_OCC(64)
    ATOMA_FS_OCC(128)
  }
  if constexpr ((DIMS & kWideDims) != 0) {
    ATOMA_FS_OCC(96)
    ATOMA_FS_OCC(256)
  }
#undef ATOMA_FS_OCC
  return -1;
}

}  // namespace atoma

// The split fused-decode entry points of one (query type Q, cache kind C)
// pair at the widths of DIMS (a HeadDimSet), for every head_dim whose
// instance_dim is one of them: q, k_new, v_new and out Q; scales_new f32
// [T, 2] or null (INT8: the new tokens' scales, else taken from their
// rows); the rest as the fused entry's, plus
// ws_o f32 [splits, T, Hq, head_dim] and ws_ml f32 [splits, T, Hq, 2] when splits
// > 1 (else null), the most splits a row takes and the fewest 64-key tiles
// a split holds. The merge of split rows is a separate launch
// (atoma_paged_attention_split_combine).
#define ATOMA_FUSED_SPLIT_ENTRIES(SUFFIX, Q, C, DIMS)                                         \
  extern "C" int atoma_fused_decode_attention_split##SUFFIX(                                  \
      const void* q, const void* k_new, const void* v_new, void* cache, void* scales,        \
      const void* scales_new, const void* slot_mapping, const void* block_tables,            \
      const void* seq_lens, const void* query_start_loc, const void* num_seqs,               \
      const void* alibi, void* out,                                                          \
      void* ws_o, void* ws_ml, int num_tokens, int num_seq_slots, int num_q_heads,           \
      int num_kv_heads, int head_dim, int max_pages, int block_size, long long num_slots,    \
      int splits, int min_tiles, float scale, int window, float soft_cap, void* stream) {    \
    return atoma::fused_split_entry<Q, C, DIMS>(                                             \
        q, k_new, v_new, cache, scales, scales_new, slot_mapping, block_tables, seq_lens,    \
        query_start_loc, num_seqs, alibi, out, ws_o, ws_ml, num_tokens, num_seq_slots,       \
        num_q_heads, num_kv_heads, head_dim, max_pages, block_size, num_slots, splits,       \
        min_tiles, scale, window, soft_cap, stream);                                         \
  }                                                                                          \
  extern "C" int atoma_fused_split_blocks_per_sm##SUFFIX(int head_dim, int group) {          \
    return atoma::fused_split_blocks_per_sm_entry<Q, C, DIMS>(head_dim, group);              \
  }
