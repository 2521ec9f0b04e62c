// The W8A8 rate probe's matmul on the tensor cores: out[M,N] = x[M,K] @ w[K,N]
// in f32, with no scales.
//
// Replaces kernel I, the TPU kernel of tools/w8a8_probe.py (`matmul` :33, body
// `kern` :20), in both of its forms:
//   * mixed (probe_mma<false>): x bf16, w int8, products summed in f32;
//   * int8  (probe_mma<true>):  x int8, w int8, an exact int32 sum converted
//     once to f32 with round-to-nearest (__int2float_rn), as the TPU kernel's
//     `.astype(f32)` of its int32 accumulator does at its last k step.
// Both run on the tensor cores through warp-level mma.sync: m16n8k32
// s8.s8.s32 for int8, m16n8k16 bf16 (f32 accumulate) for mixed, whose int8
// weights are widened to bf16 exactly on their way from shared memory into
// the B fragments. The TPU kernel's grid (n_n, n_k), its 1024 x 2048 blocks
// and its VMEM accumulator are TPU blocking and are not carried over.
//
// Bound at the probe's shape (M = 184, K = 4096, N = 14336): the weight, 58.7
// MB, is most of the 70.8 MB the call must move (21.1 us at 3.35 TB/s); the
// bf16 products need 21.8 us at 989 TFLOP/s and the int8 ones 10.9 us at
// 1,979 TOP/s, so mixed is bounded by operations and int8 by bytes.
//
// The design, and what it does about that:
//  * One block per 128 output columns over all of M (up to 192 rows: twelve
//    m16 tiles, rows past M zero-filled and never stored; a larger M takes
//    more blocks along grid y). At the probe's shape that is 112 blocks on
//    the H100's 132 SMs, one wave, and each weight byte is read from device
//    memory once and staged once. x (1.5 MB in bf16) is re-read from L2 by
//    every column block.
//  * A ring of kStages = 4 k tiles in dynamic shared memory, filled with
//    cp.async.cg in 16-byte copies: while the tensor cores work on tile t,
//    tiles t+1..t+3 are in flight. A tile is 128 bytes of every x row (64 k
//    of bf16, 128 k of int8) and the matching 64 or 128 rows of w's 128
//    columns: 32 KB (mixed) or 40 KB (int8) a stage. Tiles land as they are
//    in memory, [row][k] for x and [k][n] for w: no register staging and no
//    transpose pass. One cp.async.wait_group and one barrier a tile, placed
//    before the tile's last k step, so that the next tile's first fragments
//    load while that step's mma run.
//  * 8 warps: 2 along M (96 rows, 6 m16 tiles each) by 4 along N (32
//    columns, 4 n8 tiles each), 96 accumulators a thread; each B fragment
//    serves 6 mma, and each weight byte is widened by 2 warps. A fragments
//    come from x with ldmatrix.x4 (int8 x as pairs of bytes: its k32
//    fragment has the bf16 k16 fragment's layout), its 16-byte chunks
//    swizzled by row so that each 8x8 matrix falls in distinct banks. The
//    fragments of k step s+1 are loaded before the mma of step s: with 2
//    warps a sub-partition, a warp that waited on its loads would leave the
//    tensor core idle.
//  * B fragments come straight from the raw [k][n] weight tile. The output
//    columns of one mma may be any 8 physical columns, as long as the
//    epilogue stores with the same map, so n8 tile j of a warp's 32 columns
//    takes physical columns {4g + j : g = 0..7}. Lane (g, tig) then loads
//    the 32-bit word of columns 4g..4g+3 at the k rows its fragment needs:
//    int8 rows 4 tig + i and 16 + 4 tig + i (i = 0..3), turned by a 4 x 4
//    byte transpose (__byte_perm) into the B registers of four n8 tiles;
//    bf16 rows 2 tig, 2 tig + 1, 2 tig + 8 and 2 tig + 9, widened pair by
//    pair. w's 16-byte chunks are swizzled by the row bits that tell those
//    rows apart, so the 32 words of one load fall in 32 banks.
//  * Widening without an int-to-float conversion: a byte pair is placed by
//    one prmt in the low bytes of the two halves of a word; one lop3 gives
//    bf16 128 + (v & 127), another bf16 128 + (v & 128) (the byte's sign
//    bit lands on the exponent's low bit: 128 or 256), and one bf16x2 fma
//    subtracts them: v, exactly, for every int8 v.
//  * The epilogue undoes the column map (a thread's accumulators for one row
//    are 8 adjacent columns) into an output tile staged in shared memory,
//    then stores whole rows: 512 bytes a warp instruction.
//
// Measurement hooks, all off in the build the port uses (ops/cuda_lib.py);
// tools/probe_ablation.py builds and times them to show where the time goes:
//   ATOMA_PROBE_STAGES=n    a ring of n k tiles instead of 4;
//   ATOMA_PROBE_NO_MMA      every mma replaced by nothing (its fragments kept
//                           live), so the loop only moves and converts data;
//   ATOMA_PROBE_NO_WIDEN    mixed's widening replaced by a raw word;
//   ATOMA_PROBE_MMA_ONLY    no copies and no fragment loads: the mma alone.
// The results of all but the first are wrong by design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_once.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kMTiles = 6;      // m16 tiles a warp: 96 rows
constexpr int kNTiles = 4;      // n8 tiles a warp: 32 columns
constexpr int kBM = 2 * 16 * kMTiles;  // 192 rows a block
constexpr int kBN = 128;        // output columns a block
constexpr int kRowBytes = 128;  // bytes of one x row and of one w row in a tile
#ifndef ATOMA_PROBE_STAGES
#define ATOMA_PROBE_STAGES 4
#endif
constexpr int kStages = ATOMA_PROBE_STAGES;  // k tiles in the cp.async ring
constexpr int kKSteps = 4;      // mma k steps a tile: 32 bytes of an x row each
constexpr int kOutStride = kBN + 4;  // floats a row of the staged output tile

template <bool INT8>
struct Form {
  static constexpr int kXBytes = INT8 ? 1 : 2;        // bytes of an x element
  static constexpr int kBK = kRowBytes / kXBytes;     // k a tile: 128 or 64
  static constexpr int kXTile = kBM * kRowBytes;      // 24 KB
  static constexpr int kWTile = kBK * kBN;            // 16 KB or 8 KB
  static constexpr int kStage = kXTile + kWTile;
  // The ring, 160 KB or 128 KB; the epilogue reuses it for the 99 KB output tile.
  static constexpr int kSmem = kStages * kStage > kBM * kOutStride * 4
                                   ? kStages * kStage : kBM * kOutStride * 4;
  static constexpr int kXCopies = kBM * 8 / kThreads;   // 16-byte copies a thread a tile
  static constexpr int kWCopies = kBK * 8 / kThreads;
  static constexpr int kBWords = INT8 ? 8 : 4;        // B words a lane a k step
  // The rows one B load reads differ in bits 2-3 (int8: 4 tig + i) or 1-2
  // (bf16: 2 tig + c) of the row, and w's chunks are swizzled by those bits.
  static constexpr int kSwzShift = INT8 ? 2 : 1;
};

// Kernel I's widening, or under ATOMA_PROBE_NO_WIDEN a raw word.
__device__ __forceinline__ uint32_t probe_widen(uint32_t lo, uint32_t hi, int j) {
#ifdef ATOMA_PROBE_NO_WIDEN
  return j & 1 ? hi : lo;
#endif
  return widen_pair(lo, hi, j);
}

// One thread's share of a stage's cp.async copies, its addresses computed
// once. Copy i of x covers row r0 + 32 i, chunk c; copy i of w covers k row
// r0 + 32 i of the tile, chunk c (r0 = tid / 8, c = tid % 8). Chunks are
// swizzled: x's by the row's low 3 bits, w's by its bits kSwzShift and
// kSwzShift + 1; a multiple of 32 rows leaves both unchanged.
template <bool INT8>
struct Copier {
  using F = Form<INT8>;
  const uint8_t* x;      // the operands' bases: the source of a zero-filled copy
  const int8_t* w;
  const uint8_t* x_src;  // x row m0 + r0, chunk c of tile 0
  const int8_t* w_src;   // w row r0, columns n0 + 16 c
  long long x_step;      // bytes between x copies (32 rows)
  int x_valid;           // bit i: copy i's row lies below M
  int x_chunk_bytes;     // byte of x's row the chunk starts at in tile 0
  int row0;
  uint32_t x_dst, w_dst; // offsets in a stage of copy 0
  int N, K;

  __device__ __forceinline__ Copier(const uint8_t* x_, const int8_t* w_, int M, int N_, int K_,
                                    int m0, int n0)
      : x(x_), w(w_), N(N_), K(K_) {
    const int t = threadIdx.x, c = t & 7;
    row0 = t >> 3;
    x_step = 32LL * K * F::kXBytes;
    x_chunk_bytes = 16 * c;
    x_src = x + (long long)(m0 + row0) * K * F::kXBytes + x_chunk_bytes;
    w_src = w + (long long)row0 * N + n0 + 16 * c;
    x_valid = 0;
#pragma unroll
    for (int i = 0; i < F::kXCopies; ++i) x_valid |= (m0 + row0 + 32 * i < M) << i;
    x_dst = row0 * kRowBytes + ((c ^ (row0 & 7)) << 4);
    w_dst = F::kXTile + row0 * kRowBytes + ((c ^ (((row0 >> F::kSwzShift) & 3) << 1)) << 4);
  }

  // Issue tile kt's copies into the stage at shared address `stage`: rows
  // past M, bytes past K and k rows past K are zero-filled.
  __device__ __forceinline__ void load(uint32_t stage, int kt) const {
#ifdef ATOMA_PROBE_MMA_ONLY
    return;
#endif
    const long long kb = (long long)kt * kRowBytes;
    const bool k_ok = kb + x_chunk_bytes < (long long)K * F::kXBytes;
#pragma unroll
    for (int i = 0; i < F::kXCopies; ++i) {
      const bool ok = k_ok && ((x_valid >> i) & 1);
      cp_async16(stage + x_dst + i * 32 * kRowBytes, ok ? x_src + kb + i * x_step : x, ok);
    }
    const int k0 = kt * F::kBK;
#pragma unroll
    for (int i = 0; i < F::kWCopies; ++i) {
      const bool ok = k0 + row0 + 32 * i < K;
      cp_async16(stage + w_dst + i * 32 * kRowBytes,
                 ok ? w_src + (long long)(k0 + 32 * i) * N : w, ok);
    }
  }
};

// One k step's fragments: A (ldmatrix) and B (converted from raw words).
struct Frags {
  uint32_t a[kMTiles][4];
  uint32_t b[kNTiles][2];
};

// x: [M, K] int8 (INT8) or bf16, w: [K, N] int8, out: [M, N] f32, all
// contiguous and 16-byte aligned; K % 64 == 0, N % 128 == 0, any M >= 1 (the
// wrapper checks). Grid: (N / 128, ceil(M / 192)), 256 threads,
// Form<INT8>::kSmem bytes of dynamic shared memory.
template <bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
    probe_mma(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
              float* __restrict__ out, int M, int N, int K) {
  using F = Form<INT8>;
  extern __shared__ __align__(128) uint8_t smem[];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp >> 2) * (16 * kMTiles), wn = (warp & 3) * 32;
  const uint32_t smem0 = smem_addr(smem);

  // A: lane l gives row (l & 15) of its m16 tile and chunk (l >> 4) of the
  // k step's two; every row a lane gives is = l (mod 8), so its swizzle is
  // l & 7. B: lane (g, tig) reads word g & 3 of chunk wn / 16 + (g >> 2) of
  // rows whose swizzle is always tig << 1 (first row: 4 tig for int8, 2 tig
  // for bf16).
  const uint32_t a_off = (wm + (lane & 15)) * kRowBytes;
  const uint32_t b_off = F::kXTile + (INT8 ? 4 : 2) * tig * kRowBytes +
                         (((wn / 16 + (g >> 2)) ^ (tig << 1)) << 4) + 4 * (g & 3);

  // A fragments of k step ks into `a`, B's raw words into `bw`.
  auto load_frags = [&](uint32_t stage, int ks, uint32_t (&a)[kMTiles][4],
                        uint32_t (&bw)[F::kBWords]) {
#ifdef ATOMA_PROBE_MMA_ONLY
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mi][r] = stage + 16 * (4 * mi + r) + ks;
#pragma unroll
    for (int i = 0; i < F::kBWords; ++i) bw[i] = stage + i + ks;
    return;
#endif
    const uint32_t a_chunk = ((2 * ks + (lane >> 4)) ^ (lane & 7)) << 4;
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
      ldmatrix_x4(a[mi], stage + a_off + mi * 16 * kRowBytes + a_chunk);
    if constexpr (INT8) {
      // k rows 32 ks + 4 tig + i, then 16 more (i = 0..3).
      const uint32_t base = stage + b_off + 32 * ks * kRowBytes;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bw[i] = lds32(base + i * kRowBytes);
        bw[4 + i] = lds32(base + (16 + i) * kRowBytes);
      }
    } else {
      // k rows 16 ks + 2 tig + {0, 1, 8, 9}.
      const uint32_t base = stage + b_off + 16 * ks * kRowBytes;
      bw[0] = lds32(base);
      bw[1] = lds32(base + kRowBytes);
      bw[2] = lds32(base + 8 * kRowBytes);
      bw[3] = lds32(base + 9 * kRowBytes);
    }
  };
  // Raw B words into the B registers of the warp's 4 n8 tiles.
  auto convert = [&](const uint32_t (&bw)[F::kBWords], uint32_t (&b)[kNTiles][2]) {
    if constexpr (INT8) {
      uint32_t t0[4], t1[4];
      transpose4x4(bw, t0);
      transpose4x4(bw + 4, t1);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        b[j][0] = t0[j];
        b[j][1] = t1[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        b[j][0] = probe_widen(bw[0], bw[1], j);
        b[j][1] = probe_widen(bw[2], bw[3], j);
      }
    }
  };

  using Acc = typename std::conditional<INT8, int, float>::type;
  Acc acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const Copier<INT8> copier(x, w, M, N, K, m0, n0);
  const int num_tiles = (K + F::kBK - 1) / F::kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_tiles) copier.load(smem0 + s * F::kStage, s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // tile 0 has landed (this thread's copies)
  __syncthreads();               // ... everyone's

  // Each k step loads the next step's fragments first, issues its own mma,
  // then converts the next step's B words while the tensor core works.
  Frags frag[2];
  {
    uint32_t bw[F::kBWords];
    load_frags(smem0, 0, frag[0].a, bw);
    convert(bw, frag[0].b);
  }
  for (int kt = 0; kt < num_tiles; ++kt) {
    const uint32_t stage = smem0 + (kt % kStages) * F::kStage;
    // Tile kt - 1's stage is free: every warp passed the last barrier after
    // its final read of it. Refill it with tile kt + kStages - 1.
    const int fill = kt + kStages - 1;
    if (fill < num_tiles) copier.load(smem0 + (fill % kStages) * F::kStage, fill);
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const Frags& cur = frag[ks & 1];
      Frags& nxt = frag[(ks + 1) & 1];
      uint32_t bw[F::kBWords];
      bool more = true;
      if (ks + 1 < kKSteps) {
        load_frags(stage, ks + 1, nxt.a, bw);
      } else {
        cp_async_wait<kStages - 2>();  // tile kt + 1 has landed
        __syncthreads();
        more = kt + 1 < num_tiles;
        if (more) load_frags(smem0 + ((kt + 1) % kStages) * F::kStage, 0, nxt.a, bw);
      }
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
#ifdef ATOMA_PROBE_NO_MMA
          asm volatile("" ::"r"(cur.a[mi][0]), "r"(cur.a[mi][1]), "r"(cur.a[mi][2]),
                       "r"(cur.a[mi][3]), "r"(cur.b[j][0]), "r"(cur.b[j][1]));
#else
          if constexpr (INT8)
            mma_int8(acc[mi][j], cur.a[mi], cur.b[j][0], cur.b[j][1]);
          else
            mma_bf16(acc[mi][j], cur.a[mi], cur.b[j][0], cur.b[j][1]);
#endif
        }
      if (more) convert(bw, nxt.b);
    }
  }

  // The epilogue stages the block's output tile in shared memory (the ring
  // is idle now), then each warp stores whole 512-byte rows: stored straight
  // from the fragments, every instruction would fill half of each 32-byte
  // sector it touches. Accumulator r of n8 tile j holds row g + 8 (r / 2)
  // and logical column 2 tig + (r % 2), which is physical column wn + 8 tig
  // + 4 (r % 2) + j: a row's 8 values are adjacent. A staged row is padded
  // by 4 words, so the 8 lanes of one 16-byte store phase hit 32 banks.
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[8];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const Acc a = acc[mi][j][2 * half + c];
          if constexpr (INT8)
            v[4 * c + j] = __int2float_rn(a);
          else
            v[4 * c + j] = a;
        }
      float4* dst = reinterpret_cast<float4*>(
          tile + (wm + 16 * mi + g + 8 * half) * kOutStride + wn + 8 * tig);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  __syncthreads();
  const int rows = min(kBM, M - m0);
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float4 v = *reinterpret_cast<const float4*>(tile + r * kOutStride + 4 * lane);
    *reinterpret_cast<float4*>(out + (long long)(m0 + r) * N + n0 + 4 * lane) = v;
  }
}

template <bool INT8>
int launch(const void* x, const void* w, void* out, int M, int N, int K, void* stream) {
  if (M < 1 || K < 64 || K % 64 != 0 || N < kBN || N % kBN != 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once on each
  // device it runs on.
  static atoma::PerDevice state;
  const cudaError_t opt_in = atoma::once_per_device(state, [] {
    return cudaFuncSetAttribute(probe_mma<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Form<INT8>::kSmem);
  });
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  probe_mma<INT8><<<grid, kThreads, Form<INT8>::kSmem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w), static_cast<float*>(out), M,
      N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 [M, K], w: int8 [K, N], out: f32 [M, N]; contiguous and 16-byte
// aligned, K % 64 == 0, N % 128 == 0. Returns the launch's cudaError_t.
extern "C" int atoma_probe_mixed(const void* x, const void* w, void* out, int M, int N,
                                 int K, void* stream) {
  return launch<false>(x, w, out, M, N, K, stream);
}

// x: int8 [M, K], the rest as above.
extern "C" int atoma_probe_int8(const void* x, const void* w, void* out, int M, int N,
                                int K, void* stream) {
  return launch<true>(x, w, out, M, N, K, stream);
}
