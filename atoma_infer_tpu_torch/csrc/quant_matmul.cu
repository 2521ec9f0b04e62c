// Grouped dequantize-matmuls for weight-quantized linears:
//   y[M,N] = sum_g (x[:, group g] @ q[group g, :]) * s[g, :]
//
// Replaces the TPU kernels of atoma_infer_tpu/ops/quant_kernels.py, all
// reached through quantized_matmul_pallas:
//   * kernel F: _kernel_i8 with _scaled_dot, INT8 weights [K, N]. bf16
//     activations take the tensor cores (qmm_mma_kernel<8, ...>) where the
//     shape allows; f32 activations and other shapes take the CUDA cores
//     (qmm_float_kernel<T, 8>);
//   * kernel G: _kernel_i4, INT4 weights packed two per byte [K/2, N],
//     group-local halves (rows g*G + r in the low nibble, rows g*G + G/2 + r
//     in the high nibble), each stored as q + 8: qmm_mma_kernel<4, ...> or
//     qmm_float_kernel<T, 4>, by the same rule;
//   * kernel H: the ATOMA_W8A8 branch, int8 activations (quantized per
//     token by the caller) against int8 or int4 weights, each group's dot an
//     exact int32, times the group's scale in f32, times the token's scale
//     on the output. On the int8 tensor cores (qmm_w8a8_mma_kernel, mma.sync
//     m16n8k32 s8) where the shape allows (N % 16 == 0, groups of whole k32
//     steps: G % 32 == 0 for int8, G % 64 == 0 for int4, 16-byte aligned
//     operands); other shapes on the CUDA cores (qmm_w8a8_kernel, __dp4a).
// Scales s are bf16 [K/G, N]. Every group's dot is accumulated on its own
// (f32 for F and G, int32 for H) and multiplied by that group's scale before
// it is added into the f32 output sum: the rounding structure of _scaled_dot
// and of the XLA branch of ops/quant.py. Activations stay as given: bf16
// values are exact in f32, and f32 activations are not rounded to bf16 (the
// TPU kernel casts them), so the f32 instantiation is the f32 function; on
// the tensor cores an f32 activation would be rounded to bf16, so f32 never
// goes there.
//
// Bound at decode (M <= 64 rows): bytes. Each weight is one byte (half a
// byte for int4) and does 2*M flops, below the card's balance point until M
// is in the hundreds, so the floor is the weight bytes over 3.35 TB/s. A
// prefill chunk (M = 256) is bound by operations on the tensor cores.
//
// The tensor-core route (qmm_mma_kernel), what its design does about that:
//  * mma.sync m16n8k16 bf16 with f32 accumulators. The weight tile is staged
//    raw, as [k][n] bytes, and widened to bf16 on its way into the B
//    fragments (no int-to-float conversion: prmt, lop3 and one bf16x2 fma,
//    mma_sm90.cuh), through kernel I's column map. An int4 tile feeds two
//    passes: its low nibbles against the x columns of the group's first
//    half, its high nibbles against the second half.
//  * The tile follows M: a block holds 16 (decode), 32, 64 or 128 activation
//    rows (MT m16 tiles on each of WM warps along M) by 128 columns (4 warps
//    along N), so each mma serves a whole decode batch and each staged
//    weight byte is widened once per block, for every row of it.
//  * A ring of k tiles of 128 k in dynamic shared memory, filled by
//    cp.async (MmaTile): for INT8 3 stages of 128 weight rows (16 KB), for
//    INT4 4 stages of 64 packed rows (8 KB), each with the matching x columns
//    of the block's rows and the scale rows of the groups that end in the
//    tile (each read once per block). The host (mma_plan in
//    ops/quant_kernels.py) splits K, in whole groups, until the grid fills
//    one wave of the blocks the occupancy calculator puts on the card at
//    once (atoma_qmm_mma_blocks_per_sm: 3 to 4 an SM at 16 rows, 1 at 128);
//    split_reduce_kernel sums the f32 partials in a fixed order.
//  * Per-group f32 accumulators beside the running totals, both in
//    registers; a group's dots are scaled into the totals when it ends.
//
// The CUDA-core route (qmm_float_kernel, and H):
//  * one block covers kRows = 4 activation rows and a slab of columns.
//    Neighbouring lanes take neighbouring 8-column slices of a weight row
//    (8-byte loads, a warp reads 256 contiguous bytes a row). Where a call
//    has few (M tile, column slice, group) chains of loads to run, as the
//    small decode shapes do, a warp's lanes are 8 column slices × 4 row
//    slices instead (RS = 4): each group's rows are split over the row
//    slices, whose partial dots are summed by warp shuffles (exactly, for
//    H) before the scale, so 4× the threads each wait on a quarter of the
//    chain;
//  * the M tiles of one column slab are the fastest grid index, so they run
//    at the same time and read the slab once from device memory and again
//    from L2: every weight byte crosses the memory bus once per step;
//  * the warps of a block form up to 8 group slices that take different
//    groups (split-K inside the block, summed through shared memory in a
//    fixed order), and a small
//    decode grid is split over K across blocks as well (partials in an f32
//    workspace, summed in a fixed order by a second kernel), so decode
//    shapes put two blocks on every SM;
//  * the block's activation rows are staged in shared memory, once per
//    round of groups, in the layout each inner loop reads with one load.
// Its products run on the CUDA cores, one int-to-float conversion and one
// fma per weight per row, and prefill rows re-read the weight slab from L2
// once per 4-row tile: decode takes 3-10x its bytes bound and a prefill
// chunk far more (PERF.md). Kernel H's tensor-core route (qmm_w8a8_mma_kernel,
// below qmm_mma_kernel) reuses MmaTile's tile, ring and K splits with int8
// x and exact int32 group dots.
//
// fp16 activations (float16 models) take the tensor-core route of F and G
// with the template's X = __half: mma.sync's f16 form, the weights widened
// to fp16 (exact: int8 and int4 values are fp16 values), the output rounded
// to fp16; kernel H writes fp16 output (OutT = __half). The TPU kernels
// round activations to bf16 before the dot (quant_kernels.py:287) because
// the MXU takes bf16; the card takes fp16 operands as they are, so they are
// not rounded. fp16 activations never take the CUDA-core route: a shape it
// does not admit raises in the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_once.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;              // activation rows per block
constexpr int kStageBytes = 32768;    // shared memory for staged activations

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// VEC consecutive weight bytes of one row as 32-bit words: VEC = 8 is one
// 8-byte load, VEC = 1 one byte in the low bits.
template <int VEC>
__device__ __forceinline__ void load_row(const int8_t* p, uint32_t (&w)[(VEC + 3) / 4]) {
  if constexpr (VEC == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = (uint32_t)(uint8_t)__ldg(p);
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int c) {
  return (w[c >> 2] >> (8 * (c & 3))) & 0xFFu;
}

// Per-column words of 4 consecutive rows: a[i] holds row i's bytes, the
// result col[c] holds column c's bytes of rows 0..3 (row 0 lowest), the
// layout __dp4a takes.
template <int VEC>
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4][(VEC + 3) / 4],
                                           uint32_t (&col)[VEC]) {
  if constexpr (VEC == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t t0 = __byte_perm(a[0][h], a[1][h], 0x5140);
      const uint32_t t1 = __byte_perm(a[0][h], a[1][h], 0x7362);
      const uint32_t t2 = __byte_perm(a[2][h], a[3][h], 0x5140);
      const uint32_t t3 = __byte_perm(a[2][h], a[3][h], 0x7362);
      col[4 * h + 0] = __byte_perm(t0, t2, 0x5410);
      col[4 * h + 1] = __byte_perm(t0, t2, 0x7632);
      col[4 * h + 2] = __byte_perm(t1, t3, 0x5410);
      col[4 * h + 3] = __byte_perm(t1, t3, 0x7632);
    }
  } else {
    col[0] = a[0][0] | (a[1][0] << 8) | (a[2][0] << 16) | (a[3][0] << 24);
  }
}

// A thread's place in its block: group slice s (warps s, s + ks, ...), row
// slice rs of its warp (rsplit of them), column slice col of the block (bn
// columns).
struct Lanes {
  int s, rs, col, bn;
};

template <int RS>
__device__ __forceinline__ Lanes lanes(int ks, int vec) {
  constexpr int kColLanes = 32 / RS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Lanes l;
  l.s = warp % ks;
  l.rs = lane / kColLanes;
  l.col = (warp / ks) * kColLanes + lane % kColLanes;
  l.bn = (kThreads / 32 / ks) * kColLanes * vec;
  return l;
}

// Sum a value over the RS row slices of a warp (the high lane bits).
template <int RS, typename A>
__device__ __forceinline__ A row_slices_sum(A v) {
#pragma unroll
  for (int o = 32 / RS; o < 32; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum the block's group slices in a fixed order and store: the output row
// scaled by act[row] (W8A8) and cast to T, or the f32 partial of this K
// split into the workspace. Row slice 0 of each column holds the totals.
template <typename T, int VEC>
__device__ __forceinline__ void reduce_store(const float (&total)[kRows][VEC],
                                             float* red, int ks, const Lanes& l,
                                             int m0, int nb0, int M, int N,
                                             const float* act, T* out, float* ws) {
  const int bn = l.bn;
  __syncthreads();  // the staging buffer is reused
  if (l.rs == 0) {
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        red[(l.s * kRows + m) * bn + l.col * VEC + c] = total[m][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * bn; i += kThreads) {
    const int m = i / bn;
    const int col = i - m * bn;
    const int row = m0 + m;
    const int n = nb0 + col;
    if (row >= M || n >= N) continue;
    float sum = 0.f;
    for (int ss = 0; ss < ks; ++ss) sum += red[(ss * kRows + m) * bn + col];
    if (ws != nullptr) {
      ws[((long long)blockIdx.z * M + row) * N + n] = sum;
    } else {
      out[(long long)row * N + n] = from_float<T>(act != nullptr ? sum * act[row] : sum);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels F and G: bf16 or f32 activations, int8 or int4 weights.
// Grid (M tiles, column slabs, K splits); block = ks group slices of
// kThreads/ks threads (see Lanes); slice s takes groups gb + s of each
// round gb. Staged activations
// are f32 [slice][part][row][m], so one float4 load gives a row's 4 values.
// ---------------------------------------------------------------------------
template <typename T, int BITS, int VEC, int RS>
__global__ void __launch_bounds__(kThreads)
qmm_float_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                 const __nv_bfloat16* __restrict__ scales, T* __restrict__ out,
                 float* __restrict__ ws, int M, int N, int K, int G, int ks,
                 int gps, int rc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kParts = BITS == 8 ? 1 : 2;
  constexpr int kW = (VEC + 3) / 4;
  const Lanes l = lanes<RS>(ks, VEC);
  const int s = l.s;
  const int m0 = blockIdx.x * kRows;
  const int nb0 = blockIdx.y * l.bn;
  const int n0 = nb0 + l.col * VEC;
  const bool active = n0 < N;
  const int g_begin = blockIdx.z * gps;
  const int g_end = min(K / G, g_begin + gps);
  const int wrows = G / kParts;  // weight rows of one group (= rows of a part)

  float total[kRows][VEC];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) total[m][c] = 0.f;

  for (int gb = g_begin; gb < g_end; gb += ks) {
    const int g = gb + s;
    const bool has_group = active && g < g_end;
    float gacc[kRows][VEC];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c) gacc[m][c] = 0.f;

    for (int j = 0; j < wrows; j += rc) {
      const int rows = min(rc, wrows - j);
      const int n_stage = ks * kParts * kRows * rc;
      for (int i = threadIdx.x; i < n_stage; i += kThreads) {
        const int r = i % rc;
        const int m = (i / rc) % kRows;
        const int sp = i / (rc * kRows);
        const int gg = gb + sp / kParts;
        const int part = sp % kParts;
        float v = 0.f;
        if (r < rows && gg < g_end && m0 + m < M)
          v = to_float(x[(long long)(m0 + m) * K + (long long)gg * G + part * wrows + j + r]);
        smem[(sp * rc + r) * kRows + m] = v;
      }
      __syncthreads();
      if (has_group) {
        const int8_t* qp = q + ((long long)g * wrows + j) * N + n0;
        const float* xs = smem + s * kParts * rc * kRows;
#pragma unroll 4
        for (int r = l.rs; r < rows; r += RS) {
          uint32_t w[kW];
          load_row<VEC>(qp + (long long)r * N, w);
          const float4 xa4 = *reinterpret_cast<const float4*>(xs + r * kRows);
          const float xa[kRows] = {xa4.x, xa4.y, xa4.z, xa4.w};
          if constexpr (BITS == 8) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              const float wv = (float)(int8_t)byte_of(w, c);
#pragma unroll
              for (int m = 0; m < kRows; ++m) gacc[m][c] = fmaf(xa[m], wv, gacc[m][c]);
            }
          } else {
            const float4 xb4 = *reinterpret_cast<const float4*>(xs + (rc + r) * kRows);
            const float xb[kRows] = {xb4.x, xb4.y, xb4.z, xb4.w};
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              const uint32_t b = byte_of(w, c);
              const float lo = (float)((int)(b & 15u) - 8);
              const float hi = (float)((int)(b >> 4) - 8);
#pragma unroll
              for (int m = 0; m < kRows; ++m) {
                gacc[m][c] = fmaf(xa[m], lo, gacc[m][c]);
                gacc[m][c] = fmaf(xb[m], hi, gacc[m][c]);
              }
            }
          }
        }
      }
      __syncthreads();
    }
    if (g < g_end) {  // the same for the whole warp
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c) gacc[m][c] = row_slices_sum<RS>(gacc[m][c]);
      if (active) {
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float sc = __bfloat162float(scales[(long long)g * N + n0 + c]);
#pragma unroll
          for (int m = 0; m < kRows; ++m) total[m][c] = fmaf(gacc[m][c], sc, total[m][c]);
        }
      }
    }
  }
  reduce_store<T, VEC>(total, smem, ks, l, m0, nb0, M, N, nullptr, out, ws);
}

// ---------------------------------------------------------------------------
// Kernel H: int8 activations (per-token scales act[M]), int8 or int4
// weights. Each group's dot is an exact int32 built from __dp4a over 4 rows
// at a time; int4 nibbles are unbiased per byte (__vsub4) before the dot.
// Staged activations are int8 [slice][part][m][row], so one 32-bit load
// gives 4 consecutive rows of one activation row.
// ---------------------------------------------------------------------------
template <typename T, int BITS, int VEC, int RS>
__global__ void __launch_bounds__(kThreads)
qmm_w8a8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ q,
                const __nv_bfloat16* __restrict__ scales,
                const float* __restrict__ act, T* __restrict__ out,
                float* __restrict__ ws, int M, int N, int K, int G, int ks,
                int gps, int rc) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  int8_t* xs8 = reinterpret_cast<int8_t*>(smem4);
  constexpr int kParts = BITS == 8 ? 1 : 2;
  constexpr int kW = (VEC + 3) / 4;
  const Lanes l = lanes<RS>(ks, VEC);
  const int s = l.s;
  const int m0 = blockIdx.x * kRows;
  const int nb0 = blockIdx.y * l.bn;
  const int n0 = nb0 + l.col * VEC;
  const bool active = n0 < N;
  const int g_begin = blockIdx.z * gps;
  const int g_end = min(K / G, g_begin + gps);
  const int wrows = G / kParts;
  const int rc4 = rc / 4;

  float total[kRows][VEC];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) total[m][c] = 0.f;

  for (int gb = g_begin; gb < g_end; gb += ks) {
    const int g = gb + s;
    const bool has_group = active && g < g_end;
    int gacc[kRows][VEC];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int c = 0; c < VEC; ++c) gacc[m][c] = 0;

    for (int j = 0; j < wrows; j += rc) {
      const int rows = min(rc, wrows - j);  // a multiple of 4
      const int n_words = ks * kParts * kRows * rc4;
      uint32_t* xw_all = reinterpret_cast<uint32_t*>(xs8);
      for (int i = threadIdx.x; i < n_words; i += kThreads) {
        const int r = (i % rc4) * 4;
        const int m = (i / rc4) % kRows;
        const int sp = i / (rc4 * kRows);
        const int gg = gb + sp / kParts;
        const int part = sp % kParts;
        uint32_t v = 0;
        if (r < rows && gg < g_end && m0 + m < M)
          v = __ldg(reinterpret_cast<const uint32_t*>(
              xq + (long long)(m0 + m) * K + (long long)gg * G + part * wrows + j + r));
        xw_all[i] = v;
      }
      __syncthreads();
      if (has_group) {
        const int8_t* qp = q + ((long long)g * wrows + j) * N + n0;
        const int* xw = reinterpret_cast<const int*>(xs8) + s * kParts * kRows * rc4;
#pragma unroll 2
        for (int r = 4 * l.rs; r < rows; r += 4 * RS) {
          uint32_t a[4][kW];
#pragma unroll
          for (int i = 0; i < 4; ++i) load_row<VEC>(qp + (long long)(r + i) * N, a[i]);
          uint32_t col[VEC];
          transpose4<VEC>(a, col);
          int xa[kRows];
#pragma unroll
          for (int m = 0; m < kRows; ++m) xa[m] = xw[m * rc4 + r / 4];
          if constexpr (BITS == 8) {
#pragma unroll
            for (int c = 0; c < VEC; ++c)
#pragma unroll
              for (int m = 0; m < kRows; ++m) gacc[m][c] = __dp4a(xa[m], (int)col[c], gacc[m][c]);
          } else {
            int xb[kRows];
#pragma unroll
            for (int m = 0; m < kRows; ++m) xb[m] = xw[(kRows + m) * rc4 + r / 4];
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              const int lo = (int)__vsub4(col[c] & 0x0F0F0F0Fu, 0x08080808u);
              const int hi = (int)__vsub4((col[c] >> 4) & 0x0F0F0F0Fu, 0x08080808u);
#pragma unroll
              for (int m = 0; m < kRows; ++m) {
                gacc[m][c] = __dp4a(xa[m], lo, gacc[m][c]);
                gacc[m][c] = __dp4a(xb[m], hi, gacc[m][c]);
              }
            }
          }
        }
      }
      __syncthreads();
    }
    if (g < g_end) {  // the same for the whole warp
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < VEC; ++c) gacc[m][c] = row_slices_sum<RS>(gacc[m][c]);
      if (active) {
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const float sc = __bfloat162float(scales[(long long)g * N + n0 + c]);
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            total[m][c] = fmaf((float)gacc[m][c], sc, total[m][c]);
        }
      }
    }
  }
  reduce_store<T, VEC>(total, red, ks, l, m0, nb0, M, N, act, out, ws);
}

// Sum the K splits' partials in order, scale by act (W8A8), cast, store.
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ ws,
                                    const float* __restrict__ act,
                                    T* __restrict__ out, int M, int N,
                                    int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += ws[z * mn + i];
  out[i] = from_float<T>(act != nullptr ? sum * act[i / N] : sum);
}

// ---------------------------------------------------------------------------
// Kernels F and G on the tensor cores (bf16 activations, see the note at the
// top). Grid (column blocks of kMmaBN, row blocks of kBM, K splits); WM
// warps along M (MT m16 tiles each) by 4 along N (32 columns: four n8 tiles
// each). Weight rows are int8 rows (F) or packed int4 rows (G), rg of them
// a group, 16 of them a weight step. A k tile is 128 k: 8 int8 steps, or 4
// packed int4 steps each read twice (low nibbles, then high ones), and the
// matching x columns in two 64-column sub-tiles (int8: the tile's first
// and second half; int4: the partners of the low and of the high nibbles).
// Pass u of a tile is one mma k16 step: int8 weight step u against x
// sub-tile u / 4, int4 weight step u / 2 against sub-tile u % 2.
// ---------------------------------------------------------------------------
constexpr int kMmaBN = 128;      // output columns a block
constexpr int kMmaPasses = 8;    // k16 mma passes a tile: 128 k
constexpr int kScaleRow = kMmaBN * 2;  // bytes of one group's scales for the block

template <int BITS, int MT, int WM>
struct MmaTile {
  static constexpr int kThreads = 128 * WM;
  static constexpr int kBM = 16 * MT * WM;             // activation rows a block
  static constexpr int kWRows = BITS == 8 ? 128 : 64;  // weight rows a tile
  static constexpr int kWSteps = kWRows / 16;          // weight steps a tile
  static constexpr int kXTile = 2 * kBM * 128;         // two sub-tiles, 128 bytes a row each
  static constexpr int kWTile = kWRows * kMmaBN;       // 16 KB or 8 KB
  static constexpr int kStage = kXTile + kWTile + kWSteps * kScaleRow;
#ifdef ATOMA_QMM_STAGES
  static constexpr int kStages = ATOMA_QMM_STAGES;
#else
  static constexpr int kStages = BITS == 8 ? 3 : 4;    // k tiles in the cp.async ring
#endif
  static constexpr int kSmem = kStages * kStage;
  static constexpr int kRowStep = kThreads / 8;        // rows one round of 16-byte copies covers
  // Pass u's weight step, x sub-tile, chunk pair in the sub-tile, and
  // whether it is the first or last pass of its weight step (int4: the low
  // or the high nibbles).
  __host__ __device__ static constexpr int wstep(int u) { return BITS == 8 ? u : u >> 1; }
  __host__ __device__ static constexpr int xsub(int u) { return BITS == 8 ? u >> 2 : u & 1; }
  __host__ __device__ static constexpr int xpair(int u) { return BITS == 8 ? u & 3 : u >> 1; }
  __host__ __device__ static constexpr bool first(int u) { return BITS == 8 || !(u & 1); }
  __host__ __device__ static constexpr bool last(int u) { return BITS == 8 || (u & 1); }
};

// Byte j of `lo` and of `hi`, their low (high == 0) or high nibbles, each an
// int4 stored as q + 8, as the bf16 pair (q of lo, q of hi), exactly: a
// nibble n under bf16 128's exponent is 128 + n (0x4300 | n), and one bf16x2
// fma subtracts 136.
__device__ __forceinline__ uint32_t widen_nibbles(uint32_t lo, uint32_t hi, int j, int high) {
  uint32_t p = __byte_perm(lo, hi, pair_selector(j));
  if (high) p >>= 4;
  const uint32_t v = (p & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// The same as an fp16 pair: under fp16 1024's exponent (0x6400) a nibble n
// is 1024 + n, and one f16x2 fma subtracts 1032.
__device__ __forceinline__ uint32_t widen_nibbles_f16(uint32_t lo, uint32_t hi, int j, int high) {
  uint32_t p = __byte_perm(lo, hi, pair_selector(j));
  if (high) p >>= 4;
  const uint32_t v = (p & 0x000F000Fu) | 0x64006400u;
  uint32_t d;
  asm("fma.rn.f16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3C003C00u), "r"(0xE408E408u));
  return d;
}

template <typename X>
__device__ __forceinline__ uint32_t widen_nibbles_t(uint32_t lo, uint32_t hi, int j, int high) {
  if constexpr (std::is_same<X, __half>::value)
    return widen_nibbles_f16(lo, hi, j, high);
  else
    return widen_nibbles(lo, hi, j, high);
}

// One mma pass's operands: A fragments of the warp's m16 tiles, B fragments
// of its four n8 tiles, and, for a pass that ends a group, the thread's 8
// scales (bf16, its columns wn + 8 tig .. + 7).
template <int MT>
struct MmaFrags {
  uint32_t a[MT][4];
  uint32_t b[4][2];
  uint4 sc;
};

// x: X [M, K] (bf16 or fp16); q: int8 [K, N] or packed int4 [K/2, N];
// scales: bf16 [K/G, N]; out: X [M, N]; ws: f32 [splits, M, N] or null (one
// split). All 16-byte aligned, N % 16 == 0, G % 16 == 0 (int8) or G % 32 ==
// 0 (int4): the wrapper and the entry point check.
template <int BITS, int MT, int WM, typename X = __nv_bfloat16>
__global__ void __launch_bounds__(128 * WM)
    qmm_mma_kernel(const X* __restrict__ x, const int8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ scales, X* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int K, int G, int gps) {
  using T = MmaTile<BITS, MT, WM>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kMmaBN, m0 = blockIdx.y * T::kBM;
  const int wn = (warp & 3) * 32, wm = (warp >> 2) * 16 * MT;
  const int rg = BITS == 8 ? G : G / 2;  // weight rows a group
  const int g_begin = blockIdx.z * gps;
  const int g_end = min(K / G, g_begin + gps);
  const int r_begin = g_begin * rg, r_end = g_end * rg;
  const int num_tiles = (r_end - r_begin + T::kWRows - 1) / T::kWRows;
  const uint32_t smem0 = smem_addr(smem);

  // The ring's copies, tile by tile in order (each call loads the next
  // tile), addresses computed once and advanced. Thread tid copies 16-byte
  // chunk cc = tid % 8 of rows tid / 8 + kRowStep i. Weights: chunks of a
  // row swizzled by its bits 1-2 (the rows one B load reads differ there),
  // rows past the split zero-filled. x: chunks 2 p, 2 p + 1 of sub-tile h
  // hold the 16 x columns of chunk pair p, swizzled by the row's low 3 bits;
  // int8: columns k0 + 64 h + 16 p of the tile starting at k0; int4: packed
  // row R of group gr pairs with x column R + gr rg (low) and R + (gr + 1) rg
  // (high). Rows past M and steps past the split are zero: a zero int4 byte
  // is -8, so x must be. Scales: weight step s's group row in slot s, copied
  // only where the step ends its group. Groups are tracked by the rows left
  // in the current one, with no division.
  const int cc = tid & 7, cr = tid >> 3;
  const int xp = cc >> 1;    // the chunk pair of this thread's x chunks
  const int ss = tid >> 4;   // the weight step of its scale chunk (tid < 16 kWSteps)
  const int sc = tid & 15;   // ... and the chunk
  const int8_t* wsrc = q + (long long)(r_begin + cr) * N + n0 + 16 * cc;
  const long long wstep = (long long)T::kRowStep * N;
  const uint32_t wdst = T::kXTile + cr * 128 + ((cc ^ (((cr >> 1) & 3) << 1)) << 4);
  const bool wcol_ok = n0 + 16 * cc < N;
  const X* xsrc = x + (long long)(m0 + cr) * K + 16 * xp + 8 * (cc & 1);
  const long long xstep = (long long)T::kRowStep * K;
  const uint32_t xdst = cr * 128 + ((cc ^ (cr & 7)) << 4);
  uint32_t xrows_ok = 0;
#pragma unroll
  for (int i = 0; i < T::kBM / T::kRowStep; ++i)
    xrows_ok |= (uint32_t)(m0 + cr + i * T::kRowStep < M) << i;
  const bool scol_ok = n0 + 8 * sc < N;
  int load_r = r_begin, load_g = g_begin, load_left = rg;  // at the next tile to load
  auto load_tile = [&](uint32_t st) {
#ifdef ATOMA_QMM_MMA_ONLY
    return;
#endif
    const int rows_left = r_end - load_r;
#pragma unroll
    for (int i = 0; i < T::kWRows / T::kRowStep; ++i) {
      const bool ok = wcol_ok && cr + i * T::kRowStep < rows_left;
      cp_async16(st + wdst + i * T::kRowStep * 128, ok ? wsrc + i * wstep : q, ok);
    }
    wsrc += (long long)T::kWRows * N;
    // The groups of the tile's weight steps: this thread's x step's (int4)
    // and scale step's.
    int g = load_g, left = load_left, x_g = 0, s_g = 0;
    bool s_end = false;
#pragma unroll
    for (int s = 0; s < T::kWSteps; ++s) {
      if (s == xp) x_g = g;
      if (s == ss) s_g = g, s_end = left == 16;
      left -= 16;
      if (left == 0) ++g, left = rg;
    }
    load_g = g;
    load_left = left;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // The weight step of these chunks, and the x column of pair 0.
      const int step = BITS == 8 ? 4 * h + xp : xp;
      const int xk = BITS == 8 ? load_r + 64 * h : load_r + (x_g + h) * rg;
      const bool step_ok = 16 * step < rows_left;
#pragma unroll
      for (int i = 0; i < T::kBM / T::kRowStep; ++i) {
        const bool ok = step_ok && ((xrows_ok >> i) & 1);
        cp_async16(st + xdst + (h * T::kBM + i * T::kRowStep) * 128,
                   ok ? xsrc + i * xstep + xk : x, ok);
      }
    }
    if (tid < T::kWSteps * 16 && s_end && 16 * ss < rows_left)
      cp_async16(st + T::kXTile + T::kWTile + ss * kScaleRow + 16 * sc,
                 scol_ok ? scales + (long long)s_g * N + n0 + 8 * sc : scales, scol_ok);
    load_r += T::kWRows;
  };
  // How many of the next tile's weight steps hold rows (the split's last
  // tile may end early), and which of them start a group (bit s of starts)
  // or end one (bit s of ends); called for the tiles in order.
  int use_r = r_begin, use_left = rg;  // at the next tile to consume
  auto steps_of = [&](int& valid, uint32_t& starts, uint32_t& ends) {
    valid = min(T::kWSteps, (r_end - use_r) / 16);
    starts = ends = 0;
#pragma unroll
    for (int s = 0; s < T::kWSteps; ++s) {
      if (s < valid) {
        if (use_left == rg) starts |= 1u << s;
        use_left -= 16;
        if (use_left == 0) ends |= 1u << s, use_left = rg;
      }
    }
    use_r += T::kWRows;
  };

  // Fragment addresses. A: lane l gives row l % 16 of an m16 tile and chunk
  // l / 16 of the pass's two; its swizzle is l % 8. B: the raw [k][n] weight
  // tile read through a column map: n8 tile j of the warp's 32 columns takes
  // physical columns {wn + 4 gid + j}, so lane (gid, tig) loads the word of
  // columns wn + 4 gid .. + 3 at rows 16 s + 2 tig + {0, 1, 8, 9}, whose
  // swizzle is tig << 1, and byte j of it feeds n8 tile j.
  const uint32_t a_off = (wm + (lane & 15)) * 128;
  const uint32_t b_off = T::kXTile + 2 * tig * 128 +
                         (((wn / 16 + (gid >> 2)) ^ (tig << 1)) << 4) + 4 * (gid & 3);
  const uint32_t s_off = T::kXTile + T::kWTile + 2 * (wn + 8 * tig);
  auto load_a = [&](uint32_t st, int u, uint32_t (&a)[MT][4]) {
#ifdef ATOMA_QMM_MMA_ONLY
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mi][r] = st + 16 * (4 * mi + r) + u;
    return;
#endif
    const uint32_t chunk = ((2 * T::xpair(u) + (lane >> 4)) ^ (lane & 7)) << 4;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      ldmatrix_x4(a[mi], st + T::xsub(u) * T::kBM * 128 + a_off + mi * 16 * 128 + chunk);
  };
  auto load_b = [&](uint32_t st, int s, uint32_t (&bw)[4]) {
#ifdef ATOMA_QMM_MMA_ONLY
#pragma unroll
    for (int i = 0; i < 4; ++i) bw[i] = st + i + s;
    return;
#endif
    const uint32_t base = st + b_off + 16 * s * 128;
    bw[0] = lds32(base);
    bw[1] = lds32(base + 128);
    bw[2] = lds32(base + 8 * 128);
    bw[3] = lds32(base + 9 * 128);
  };
  // B fragments of pass u from its weight step's raw words.
  auto convert = [&](const uint32_t (&bw)[4], int u, uint32_t (&b)[4][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#ifdef ATOMA_QMM_NO_WIDEN
      b[j][0] = j & 1 ? bw[1] : bw[0];
      b[j][1] = j & 1 ? bw[3] : bw[2];
      continue;
#endif
      if constexpr (BITS == 8) {
        b[j][0] = widen_pair_t<X>(bw[0], bw[1], j);
        b[j][1] = widen_pair_t<X>(bw[2], bw[3], j);
      } else {
        b[j][0] = widen_nibbles_t<X>(bw[0], bw[1], j, u & 1);
        b[j][1] = widen_nibbles_t<X>(bw[2], bw[3], j, u & 1);
      }
    }
  };

  // acc: the current group's dots (written afresh by its first pass);
  // tot: the scaled sum over groups.
  float acc[MT][4][4], tot[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = tot[mi][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_tiles) load_tile(smem0 + s * T::kStage);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // tile 0 has landed (this thread's copies)
  __syncthreads();               // ... everyone's

  // As in kernel I: each pass loads the next pass's fragments first (after
  // the tile's barrier, from the next stage), issues its own mma, then
  // widens the next pass's B words while the tensor core works. Scales are
  // read with the fragments, before the barrier after which a stage may be
  // refilled.
  int valid = 0, next_valid = 0;
  uint32_t starts = 0, ends = 0, next_starts = 0, next_ends = 0;
  steps_of(valid, starts, ends);
  MmaFrags<MT> frag[2];
  uint32_t bw[4];
  load_a(smem0, 0, frag[0].a);
  load_b(smem0, 0, bw);
  convert(bw, 0, frag[0].b);
  if (T::last(0) && (ends & 1)) frag[0].sc = lds128(smem0 + s_off);
  for (int kt = 0; kt < num_tiles; ++kt) {
    const uint32_t stage = smem0 + (kt % kStages) * T::kStage;
    // Tile kt - 1's stage is free: every warp passed the last barrier after
    // its final read of it. Refill it with tile kt + kStages - 1.
    if (kt + kStages - 1 < num_tiles) load_tile(smem0 + ((kt + kStages - 1) % kStages) * T::kStage);
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < kMmaPasses; ++u) {
      const int s = T::wstep(u);
      MmaFrags<MT>& cur = frag[u & 1];
      MmaFrags<MT>& nxt = frag[(u + 1) & 1];
      bool more = true;
      if (u + 1 < kMmaPasses) {
        const int ns = T::wstep(u + 1);
        load_a(stage, u + 1, nxt.a);
        if (ns != s) load_b(stage, ns, bw);
        if (T::last(u + 1) && ((ends >> ns) & 1)) nxt.sc = lds128(stage + s_off + ns * kScaleRow);
      } else {
        cp_async_wait<kStages - 2>();  // tile kt + 1 has landed
        __syncthreads();
        more = kt + 1 < num_tiles;
        if (more) {
          const uint32_t next = smem0 + ((kt + 1) % kStages) * T::kStage;
          steps_of(next_valid, next_starts, next_ends);
          load_a(next, 0, nxt.a);
          load_b(next, 0, bw);
          if (T::last(0) && (next_ends & 1)) nxt.sc = lds128(next + s_off);
        }
      }
      // A group's first pass writes its dots afresh (no zeroing pass over
      // the accumulators after the previous group's end).
      const bool fresh = T::first(u) && ((starts >> s) & 1);
      if (s < valid) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#ifdef ATOMA_QMM_NO_MMA
            asm volatile("" ::"r"(cur.a[mi][0]), "r"(cur.a[mi][1]), "r"(cur.a[mi][2]),
                         "r"(cur.a[mi][3]), "r"(cur.b[j][0]), "r"(cur.b[j][1]));
#else
            if (fresh)
              mma16_fresh<X>(acc[mi][j], cur.a[mi], cur.b[j][0], cur.b[j][1]);
            else
              mma16<X>(acc[mi][j], cur.a[mi], cur.b[j][0], cur.b[j][1]);
#endif
          }
      }
      if (more) convert(bw, (u + 1) % kMmaPasses, nxt.b);
      if (T::last(u) && ((ends >> s) & 1)) {
        // The group's dots are complete: scale them into the total. The
        // accumulator r of n8 tile j holds column 4 (r % 2) + j of the 8.
        const uint32_t words[4] = {cur.sc.x, cur.sc.y, cur.sc.z, cur.sc.w};
        float scale[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          scale[c] = __uint_as_float(c & 1 ? words[c >> 1] & 0xFFFF0000u : words[c >> 1] << 16);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              tot[mi][j][r] = fmaf(acc[mi][j][r], scale[4 * (r & 1) + j], tot[mi][j][r]);
      }
    }
    valid = next_valid;
    starts = next_starts;
    ends = next_ends;
  }

  // Accumulator r of n8 tile j holds row gid + 8 (r / 2) and logical column
  // 2 tig + r % 2, which is physical column wn + 8 tig + 4 (r % 2) + j: a
  // row's 8 values are adjacent, one 16-byte store (bf16) or two (f32).
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * mi + gid + 8 * half;
      const int col = n0 + wn + 8 * tig;
      if (row >= M || col >= N) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[4 * c + j] = tot[mi][j][2 * half + c];
      if (ws != nullptr) {
        float4* dst = reinterpret_cast<float4*>(ws + ((long long)blockIdx.z * M + row) * N + col);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(out + (long long)row * N + col) =
            make_uint4(pack2<X>(v[0], v[1]), pack2<X>(v[2], v[3]), pack2<X>(v[4], v[5]),
                       pack2<X>(v[6], v[7]));
      }
    }
}

// ---------------------------------------------------------------------------
// Kernel H on the int8 tensor cores (int8 activations, see the note at the
// top). The tile, grid and ring are MmaTile's; what differs:
//  * x is int8, so a 128-byte row chunk of the x tile holds 128 k, and an
//    int8 m16n8k32 A fragment has the byte layout of a bf16 m16n8k16 one:
//    the same ldmatrix_x4 over two 16-byte chunks gives it;
//  * a weight step is 32 rows (one k32 mma). A k tile is 128 weight rows
//    (16 KB): INT8 128 k, 4 passes against one x sub-tile; INT4 128 packed
//    rows (256 k), each step read twice (low nibbles against the x columns
//    of the group's first half, high nibbles against its second half), 8
//    passes against two x sub-tiles;
//  * B fragments come from the raw tile as kernel I's int8 form takes them:
//    lane (gid, tig) loads the words of columns wn + 4 gid .. + 3 at rows
//    32 s + 4 tig + i and + 16 (i = 0..3), and transpose4x4 turns each four
//    into the B registers of four n8 tiles. INT4 nibbles are unbiased by 8
//    per byte (__vsub4). No widening: the products are exact integers;
//  * the group's dots accumulate in int32 (exact: |x|, |q| <= 127 over at
//    most 2^17 rows, the wrapper checks), converted once (cvt.rn.f32.s32)
//    and scaled into the f32 totals by fmaf when the group ends, as the
//    CUDA-core H does; the token's scale multiplies the output in the
//    epilogue, or in split_reduce_kernel when K is split.
// ---------------------------------------------------------------------------
template <int BITS, int MT, int WM>
struct W8a8Tile {
  static constexpr int kThreads = 128 * WM;
  static constexpr int kBM = 16 * MT * WM;              // activation rows a block
  static constexpr int kWRows = 128;                    // weight rows a tile (16 KB)
  static constexpr int kWSteps = kWRows / 32;           // k32 weight steps a tile
  static constexpr int kXSubs = BITS == 8 ? 1 : 2;      // x sub-tiles, 128 bytes a row each
  static constexpr int kPasses = kWSteps * kXSubs;      // mma passes a tile
  static constexpr int kXTile = kXSubs * kBM * 128;
  static constexpr int kWTile = kWRows * kMmaBN;
  static constexpr int kStage = kXTile + kWTile + kWSteps * kScaleRow;
#ifdef ATOMA_QMM_STAGES
  static constexpr int kStages = ATOMA_QMM_STAGES;
#else
  static constexpr int kStages = 3;                     // k tiles in the cp.async ring
#endif
  static constexpr int kSmem = kStages * kStage;
  static constexpr int kRowStep = kThreads / 8;
  // Pass u's weight step (and x chunk pair) and x sub-tile; whether it is
  // the first or last pass of its weight step.
  __host__ __device__ static constexpr int wstep(int u) { return BITS == 8 ? u : u >> 1; }
  __host__ __device__ static constexpr int xsub(int u) { return BITS == 8 ? 0 : u & 1; }
  __host__ __device__ static constexpr bool first(int u) { return BITS == 8 || !(u & 1); }
  __host__ __device__ static constexpr bool last(int u) { return BITS == 8 || (u & 1); }
};


// Four bytes of packed int4 (stored as q + 8), their low (high == 0) or high
// nibbles as four int8 values q.
__device__ __forceinline__ uint32_t unbias_nibbles(uint32_t w, int high) {
  return __vsub4((high ? w >> 4 : w) & 0x0F0F0F0Fu, 0x08080808u);
}

template <int MT>
struct W8a8Frags {
  uint32_t a[MT][4];
  uint32_t b[4][2];
  uint4 sc;
};

// xq: int8 [M, K]; q: int8 [K, N] or packed int4 [K/2, N]; scales: bf16
// [K/G, N]; act: f32 [M]; out: OutT [M, N]; ws: f32 [splits, M, N] or null
// (one split). All 16-byte aligned, N % 16 == 0, G % 32 == 0 (int8) or
// G % 64 == 0 (int4): the wrapper and the entry point check.
template <int BITS, int MT, int WM, typename OutT>
__global__ void __launch_bounds__(128 * WM)
    qmm_w8a8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ q,
                        const __nv_bfloat16* __restrict__ scales, const float* __restrict__ act,
                        OutT* __restrict__ out, float* __restrict__ ws, int M, int N, int K,
                        int G, int gps) {
  using T = W8a8Tile<BITS, MT, WM>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kMmaBN, m0 = blockIdx.y * T::kBM;
  const int wn = (warp & 3) * 32, wm = (warp >> 2) * 16 * MT;
  const int rg = BITS == 8 ? G : G / 2;  // weight rows a group
  const int g_begin = blockIdx.z * gps;
  const int g_end = min(K / G, g_begin + gps);
  const int r_begin = g_begin * rg, r_end = g_end * rg;
  const int num_tiles = (r_end - r_begin + T::kWRows - 1) / T::kWRows;
  const uint32_t smem0 = smem_addr(smem);

  // The ring's copies (see qmm_mma_kernel). Thread tid copies 16-byte chunk
  // cc = tid % 8 of rows tid / 8 + kRowStep i. Weights: chunks swizzled by
  // the row's bits 2-3 (the rows one B load reads, 4 tig + i, differ there).
  // x: chunk cc of sub-tile h holds 16 x columns of weight step cc / 2:
  // int8 columns k0 + 16 cc of the tile starting at k0; int4 packed rows
  // R .. R + 15 (R = r0 + 16 cc) of group gr pair with x columns R + gr rg
  // (low, h = 0) and R + (gr + 1) rg (high, h = 1). Chunks swizzled by the
  // row's low 3 bits. Rows past M and steps past the split are zero (a zero
  // int4 byte is -8, so x must be). Scales: weight step s's group row in
  // slot s, copied only where the step ends its group.
  const int cc = tid & 7, cr = tid >> 3;
  const int xs = cc >> 1;    // the weight step of this thread's x chunk
  const int ss = tid >> 4;   // the weight step of its scale chunk (tid < 16 kWSteps)
  const int sc = tid & 15;   // ... and the chunk
  const int8_t* wsrc = q + (long long)(r_begin + cr) * N + n0 + 16 * cc;
  const long long wstep = (long long)T::kRowStep * N;
  const uint32_t wdst = T::kXTile + cr * 128 + ((cc ^ (((cr >> 2) & 3) << 1)) << 4);
  const bool wcol_ok = n0 + 16 * cc < N;
  const int8_t* xsrc = xq + (long long)(m0 + cr) * K + 16 * cc;
  const long long xstep = (long long)T::kRowStep * K;
  const uint32_t xdst = cr * 128 + ((cc ^ (cr & 7)) << 4);
  uint32_t xrows_ok = 0;
#pragma unroll
  for (int i = 0; i < T::kBM / T::kRowStep; ++i)
    xrows_ok |= (uint32_t)(m0 + cr + i * T::kRowStep < M) << i;
  const bool scol_ok = n0 + 8 * sc < N;
  int load_r = r_begin, load_g = g_begin, load_left = rg;  // at the next tile to load
  auto load_tile = [&](uint32_t st) {
#ifdef ATOMA_QMM_MMA_ONLY
    return;
#endif
    const int rows_left = r_end - load_r;
#pragma unroll
    for (int i = 0; i < T::kWRows / T::kRowStep; ++i) {
      const bool ok = wcol_ok && cr + i * T::kRowStep < rows_left;
      cp_async16(st + wdst + i * T::kRowStep * 128, ok ? wsrc + i * wstep : q, ok);
    }
    wsrc += (long long)T::kWRows * N;
    int g = load_g, left = load_left, x_g = 0, s_g = 0;
    bool s_end = false;
#pragma unroll
    for (int s = 0; s < T::kWSteps; ++s) {
      if (s == xs) x_g = g;
      if (s == ss) s_g = g, s_end = left == 32;
      left -= 32;
      if (left == 0) ++g, left = rg;
    }
    load_g = g;
    load_left = left;
    const bool step_ok = 32 * xs < rows_left;
#pragma unroll
    for (int h = 0; h < T::kXSubs; ++h) {
      const int xk = BITS == 8 ? load_r : load_r + (x_g + h) * rg;
#pragma unroll
      for (int i = 0; i < T::kBM / T::kRowStep; ++i) {
        const bool ok = step_ok && ((xrows_ok >> i) & 1);
        cp_async16(st + xdst + (h * T::kBM + i * T::kRowStep) * 128,
                   ok ? xsrc + i * xstep + xk : xq, ok);
      }
    }
    if (tid < T::kWSteps * 16 && s_end && 32 * ss < rows_left)
      cp_async16(st + T::kXTile + T::kWTile + ss * kScaleRow + 16 * sc,
                 scol_ok ? scales + (long long)s_g * N + n0 + 8 * sc : scales, scol_ok);
    load_r += T::kWRows;
  };
  // How many of the next tile's weight steps hold rows, and which of them
  // start a group (bit s of starts) or end one (bit s of ends); called for
  // the tiles in order.
  int use_r = r_begin, use_left = rg;
  auto steps_of = [&](int& valid, uint32_t& starts, uint32_t& ends) {
    valid = min(T::kWSteps, (r_end - use_r) / 32);
    starts = ends = 0;
#pragma unroll
    for (int s = 0; s < T::kWSteps; ++s) {
      if (s < valid) {
        if (use_left == rg) starts |= 1u << s;
        use_left -= 32;
        if (use_left == 0) ends |= 1u << s, use_left = rg;
      }
    }
    use_r += T::kWRows;
  };

  // Fragment addresses. A: lane l gives row l % 16 of an m16 tile and chunk
  // l / 16 of the step's pair; its swizzle is l % 8. B: lane (gid, tig)
  // reads the word of columns wn + 4 gid .. + 3 (chunk wn / 16 + gid / 4,
  // word gid % 4) at rows 32 s + 4 tig + i and 32 s + 16 + 4 tig + i, whose
  // swizzle is tig << 1.
  const uint32_t a_off = (wm + (lane & 15)) * 128;
  const uint32_t b_off = T::kXTile + 4 * tig * 128 +
                         (((wn / 16 + (gid >> 2)) ^ (tig << 1)) << 4) + 4 * (gid & 3);
  const uint32_t s_off = T::kXTile + T::kWTile + 2 * (wn + 8 * tig);
  auto load_a = [&](uint32_t st, int u, uint32_t (&a)[MT][4]) {
#ifdef ATOMA_QMM_MMA_ONLY
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mi][r] = st + 16 * (4 * mi + r) + u;
    return;
#endif
    const uint32_t chunk = ((2 * T::wstep(u) + (lane >> 4)) ^ (lane & 7)) << 4;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      ldmatrix_x4(a[mi], st + T::xsub(u) * T::kBM * 128 + a_off + mi * 16 * 128 + chunk);
  };
  auto load_b = [&](uint32_t st, int s, uint32_t (&bw)[8]) {
#ifdef ATOMA_QMM_MMA_ONLY
#pragma unroll
    for (int i = 0; i < 8; ++i) bw[i] = st + i + s;
    return;
#endif
    const uint32_t base = st + b_off + 32 * s * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bw[i] = lds32(base + i * 128);
      bw[4 + i] = lds32(base + (16 + i) * 128);
    }
  };
  // B fragments of pass u from its weight step's raw words.
  auto convert = [&](const uint32_t (&bw)[8], int u, uint32_t (&b)[4][2]) {
    uint32_t t0[4], t1[4];
    transpose4x4(bw, t0);
    transpose4x4(bw + 4, t1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (BITS == 8) {
        b[j][0] = t0[j];
        b[j][1] = t1[j];
      } else {
        b[j][0] = unbias_nibbles(t0[j], u & 1);
        b[j][1] = unbias_nibbles(t1[j], u & 1);
      }
    }
  };

  // acc: the current group's exact dots (written afresh by its first
  // pass); tot: the scaled sum over groups.
  int acc[MT][4][4];
  float tot[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0, tot[mi][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_tiles) load_tile(smem0 + s * T::kStage);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();

  int valid = 0, next_valid = 0;
  uint32_t starts = 0, ends = 0, next_starts = 0, next_ends = 0;
  steps_of(valid, starts, ends);
  W8a8Frags<MT> frag[2];
  uint32_t bw[8];
  load_a(smem0, 0, frag[0].a);
  load_b(smem0, 0, bw);
  convert(bw, 0, frag[0].b);
  if (T::last(0) && (ends & 1)) frag[0].sc = lds128(smem0 + s_off);
  for (int kt = 0; kt < num_tiles; ++kt) {
    const uint32_t stage = smem0 + (kt % kStages) * T::kStage;
    if (kt + kStages - 1 < num_tiles) load_tile(smem0 + ((kt + kStages - 1) % kStages) * T::kStage);
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < T::kPasses; ++u) {
      const int s = T::wstep(u);
      W8a8Frags<MT>& cur = frag[u & 1];
      W8a8Frags<MT>& nxt = frag[(u + 1) & 1];
      bool more = true;
      if (u + 1 < T::kPasses) {
        const int ns = T::wstep(u + 1);
        load_a(stage, u + 1, nxt.a);
        if (ns != s) load_b(stage, ns, bw);
        if (T::last(u + 1) && ((ends >> ns) & 1)) nxt.sc = lds128(stage + s_off + ns * kScaleRow);
      } else {
        cp_async_wait<kStages - 2>();  // tile kt + 1 has landed
        __syncthreads();
        more = kt + 1 < num_tiles;
        if (more) {
          const uint32_t next = smem0 + ((kt + 1) % kStages) * T::kStage;
          steps_of(next_valid, next_starts, next_ends);
          load_a(next, 0, nxt.a);
          load_b(next, 0, bw);
          if (T::last(0) && (next_ends & 1)) nxt.sc = lds128(next + s_off);
        }
      }
      const bool fresh = T::first(u) && ((starts >> s) & 1);
      if (s < valid) {
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#ifdef ATOMA_QMM_NO_MMA
            asm volatile("" ::"r"(cur.a[mi][0]), "r"(cur.a[mi][1]), "r"(cur.a[mi][2]),
                         "r"(cur.a[mi][3]), "r"(cur.b[j][0]), "r"(cur.b[j][1]));
#else
            if (fresh)
              mma_int8_fresh(acc[mi][j], cur.a[mi], cur.b[j][0], cur.b[j][1]);
            else
              mma_int8(acc[mi][j], cur.a[mi], cur.b[j][0], cur.b[j][1]);
#endif
          }
      }
      if (more) convert(bw, (u + 1) % T::kPasses, nxt.b);
      if (T::last(u) && ((ends >> s) & 1)) {
        // The group's dots are complete and exact: convert, scale into the
        // total. Accumulator r of n8 tile j holds column 4 (r % 2) + j of
        // the thread's 8.
        const uint32_t words[4] = {cur.sc.x, cur.sc.y, cur.sc.z, cur.sc.w};
        float scale[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          scale[c] = __uint_as_float(c & 1 ? words[c >> 1] & 0xFFFF0000u : words[c >> 1] << 16);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              tot[mi][j][r] = fmaf(__int2float_rn(acc[mi][j][r]), scale[4 * (r & 1) + j],
                                   tot[mi][j][r]);
      }
    }
    valid = next_valid;
    starts = next_starts;
    ends = next_ends;
  }

  // The epilogue as qmm_mma_kernel's: a row's 8 values are adjacent; the
  // token's scale multiplies them unless K is split.
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * mi + gid + 8 * half;
      const int col = n0 + wn + 8 * tig;
      if (row >= M || col >= N) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) v[4 * c + j] = tot[mi][j][2 * half + c];
      if (ws != nullptr) {
        float4* dst = reinterpret_cast<float4*>(ws + ((long long)blockIdx.z * M + row) * N + col);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        continue;
      }
      const float a = act[row];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] *= a;
      if constexpr (sizeof(OutT) == 2) {
        *reinterpret_cast<uint4*>(out + (long long)row * N + col) =
            make_uint4(pack2<OutT>(v[0], v[1]), pack2<OutT>(v[2], v[3]),
                       pack2<OutT>(v[4], v[5]), pack2<OutT>(v[6], v[7]));
      } else {
        float4* dst = reinterpret_cast<float4*>(out + (long long)row * N + col);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
}

struct Plan {
  dim3 grid;
  int rc;
  size_t smem;
  int splits;
};

// Checks shared by every entry point; returns false on what the kernels do
// not take. rows_per_word: 1 (float staging), 4 (int8 staging, __dp4a).
bool make_plan(int M, int N, int K, int G, int bits, int vec, int ks,
               int rsplit, int gps, int stage_elt_bytes, int rows_per_word,
               const void* q, const void* ws, Plan* p) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || K % G != 0) return false;
  if (bits != 8 && bits != 4) return false;
  const int parts = bits == 8 ? 1 : 2;
  if (G % parts != 0) return false;
  const int wrows = G / parts;
  if (wrows % rows_per_word != 0) return false;
  if (ks != 1 && ks != 2 && ks != 4 && ks != 8) return false;
  if (rsplit != 1 && rsplit != 4) return false;
  if (vec == 8) {
    if (N % 8 != 0 || (uintptr_t)q % 8 != 0) return false;
  } else if (vec != 1) {
    return false;
  }
  const int groups = K / G;
  if (gps <= 0) return false;
  const int splits = (groups + gps - 1) / gps;
  if (splits > 1 && ws == nullptr) return false;
  int rc = kStageBytes / (ks * parts * kRows * stage_elt_bytes);
  rc -= rc % rows_per_word;
  if (rc <= 0) return false;
  if (rc > wrows) rc = wrows;
  const int bn = (kThreads / 32 / ks) * (32 / rsplit) * vec;
  const size_t stage = (size_t)ks * parts * kRows * rc * stage_elt_bytes;
  const size_t red = (size_t)kRows * bn * ks * sizeof(float);
  p->grid = dim3((M + kRows - 1) / kRows, (N + bn - 1) / bn, splits);
  p->rc = rc;
  p->smem = stage > red ? stage : red;
  p->splits = splits;
  return true;
}

template <typename T>
void launch_reduce(const Plan& p, const float* ws, const float* act, void* out,
                   int M, int N, cudaStream_t stream) {
  if (p.splits <= 1) return;
  const long long mn = (long long)M * N;
  split_reduce_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      ws, act, (T*)out, M, N, p.splits);
}

template <typename T, int BITS>
void launch_float(const Plan& p, const void* x, const void* q, const void* scales,
                  void* out, void* ws, int M, int N, int K, int G, int vec,
                  int ks, int rsplit, int gps, cudaStream_t stream) {
  float* w = p.splits > 1 ? (float*)ws : nullptr;
  const auto* s = (const __nv_bfloat16*)scales;
  const auto* xt = (const T*)x;
  const auto* qb = (const int8_t*)q;
  if (vec == 8 && rsplit == 1) {
    qmm_float_kernel<T, BITS, 8, 1><<<p.grid, kThreads, p.smem, stream>>>(
        xt, qb, s, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  } else if (vec == 8) {
    qmm_float_kernel<T, BITS, 8, 4><<<p.grid, kThreads, p.smem, stream>>>(
        xt, qb, s, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  } else if (rsplit == 1) {
    qmm_float_kernel<T, BITS, 1, 1><<<p.grid, kThreads, p.smem, stream>>>(
        xt, qb, s, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  } else {
    qmm_float_kernel<T, BITS, 1, 4><<<p.grid, kThreads, p.smem, stream>>>(
        xt, qb, s, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  }
  launch_reduce<T>(p, w, nullptr, out, M, N, stream);
}

template <typename T, int BITS>
void launch_w8a8(const Plan& p, const void* xq, const void* q, const void* scales,
                 const void* act, void* out, void* ws, int M, int N, int K,
                 int G, int vec, int ks, int rsplit, int gps, cudaStream_t stream) {
  float* w = p.splits > 1 ? (float*)ws : nullptr;
  const auto* s = (const __nv_bfloat16*)scales;
  const float* a = (const float*)act;
  const auto* xb = (const int8_t*)xq;
  const auto* qb = (const int8_t*)q;
  if (vec == 8 && rsplit == 1) {
    qmm_w8a8_kernel<T, BITS, 8, 1><<<p.grid, kThreads, p.smem, stream>>>(
        xb, qb, s, a, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  } else if (vec == 8) {
    qmm_w8a8_kernel<T, BITS, 8, 4><<<p.grid, kThreads, p.smem, stream>>>(
        xb, qb, s, a, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  } else if (rsplit == 1) {
    qmm_w8a8_kernel<T, BITS, 1, 1><<<p.grid, kThreads, p.smem, stream>>>(
        xb, qb, s, a, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  } else {
    qmm_w8a8_kernel<T, BITS, 1, 4><<<p.grid, kThreads, p.smem, stream>>>(
        xb, qb, s, a, (T*)out, w, M, N, K, G, ks, gps, p.rc);
  }
  launch_reduce<T>(p, w, a, out, M, N, stream);
}

template <int BITS>
int qmm_float_entry(const void* x, const void* q, const void* scales, void* out,
                    void* ws, int M, int N, int K, int G, int x_is_bf16,
                    int vec, int ks, int rsplit, int gps, void* stream) {
  Plan p;
  if (!make_plan(M, N, K, G, BITS, vec, ks, rsplit, gps, sizeof(float), 1, q, ws, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16) {
    launch_float<__nv_bfloat16, BITS>(p, x, q, scales, out, ws, M, N, K, G, vec, ks, rsplit,
                                      gps, st);
  } else {
    launch_float<float, BITS>(p, x, q, scales, out, ws, M, N, K, G, vec, ks, rsplit, gps, st);
  }
  return (int)cudaGetLastError();
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device it runs on.
template <int BITS, int MT, int WM, typename X = __nv_bfloat16>
cudaError_t mma_attributes() {
  static atoma::PerDevice state;
  return atoma::once_per_device(state, [] {
    return cudaFuncSetAttribute(qmm_mma_kernel<BITS, MT, WM, X>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                MmaTile<BITS, MT, WM>::kSmem);
  });
}

template <int BITS, int MT, int WM>
int mma_blocks_per_sm() {
  using T = MmaTile<BITS, MT, WM>;
  if (mma_attributes<BITS, MT, WM>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, qmm_mma_kernel<BITS, MT, WM>,
                                                    T::kThreads, T::kSmem) != cudaSuccess)
    return -1;
  return n;
}

template <int BITS, int MT, int WM, typename X>
int launch_mma(const void* x, const void* q, const void* scales, void* out, void* ws, int M,
               int N, int K, int G, int gps, int splits, cudaStream_t stream) {
  using T = MmaTile<BITS, MT, WM>;
  const cudaError_t opt_in = mma_attributes<BITS, MT, WM, X>();
  if (opt_in != cudaSuccess) return (int)opt_in;
  float* w = splits > 1 ? (float*)ws : nullptr;
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + T::kBM - 1) / T::kBM, splits);
  qmm_mma_kernel<BITS, MT, WM, X><<<grid, T::kThreads, T::kSmem, stream>>>(
      (const X*)x, (const int8_t*)q, (const __nv_bfloat16*)scales, (X*)out, w, M, N, K, G, gps);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    split_reduce_kernel<X><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        w, nullptr, (X*)out, M, N, splits);
  }
  return (int)cudaGetLastError();
}

template <int BITS, typename X>
int qmm_mma_entry(const void* x, const void* q, const void* scales, void* out, void* ws,
                  int M, int N, int K, int G, int block_rows, int gps, void* stream) {
  if (M < 1 || N < 16 || N % 16 != 0 || G <= 0 || K < G || K % G != 0 ||
      G % (BITS == 8 ? 16 : 32) != 0 || gps < 1)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, q, scales, (const void*)out})
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  const int splits = (K / G + gps - 1) / gps;
  if (splits > 1 && (ws == nullptr || (uintptr_t)ws % 16 != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (block_rows) {
    case 16: return launch_mma<BITS, 1, 1, X>(x, q, scales, out, ws, M, N, K, G, gps, splits, st);
    case 32: return launch_mma<BITS, 2, 1, X>(x, q, scales, out, ws, M, N, K, G, gps, splits, st);
    case 64: return launch_mma<BITS, 4, 1, X>(x, q, scales, out, ws, M, N, K, G, gps, splits, st);
    case 128: return launch_mma<BITS, 4, 2, X>(x, q, scales, out, ws, M, N, K, G, gps, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int BITS, int MT, int WM, typename OutT>
cudaError_t w8a8_mma_attributes() {
  static atoma::PerDevice state;
  return atoma::once_per_device(state, [] {
    return cudaFuncSetAttribute(qmm_w8a8_mma_kernel<BITS, MT, WM, OutT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                W8a8Tile<BITS, MT, WM>::kSmem);
  });
}

template <int BITS, int MT, int WM>
int w8a8_mma_blocks_per_sm() {
  using T = W8a8Tile<BITS, MT, WM>;
  if (w8a8_mma_attributes<BITS, MT, WM, __nv_bfloat16>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, qmm_w8a8_mma_kernel<BITS, MT, WM, __nv_bfloat16>, T::kThreads, T::kSmem) !=
      cudaSuccess)
    return -1;
  return n;
}

template <int BITS, int MT, int WM, typename OutT>
int launch_w8a8_mma(const void* xq, const void* q, const void* scales, const void* act, void* out,
                    void* ws, int M, int N, int K, int G, int gps, int splits,
                    cudaStream_t stream) {
  using T = W8a8Tile<BITS, MT, WM>;
  const cudaError_t opt_in = w8a8_mma_attributes<BITS, MT, WM, OutT>();
  if (opt_in != cudaSuccess) return (int)opt_in;
  float* w = splits > 1 ? (float*)ws : nullptr;
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + T::kBM - 1) / T::kBM, splits);
  qmm_w8a8_mma_kernel<BITS, MT, WM, OutT><<<grid, T::kThreads, T::kSmem, stream>>>(
      (const int8_t*)xq, (const int8_t*)q, (const __nv_bfloat16*)scales, (const float*)act,
      (OutT*)out, w, M, N, K, G, gps);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    split_reduce_kernel<OutT><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        w, (const float*)act, (OutT*)out, M, N, splits);
  }
  return (int)cudaGetLastError();
}

template <int BITS, typename OutT>
int w8a8_mma_rows(const void* xq, const void* q, const void* scales, const void* act, void* out,
                  void* ws, int M, int N, int K, int G, int block_rows, int gps, int splits,
                  cudaStream_t st) {
  switch (block_rows) {
    case 16:
      return launch_w8a8_mma<BITS, 1, 1, OutT>(xq, q, scales, act, out, ws, M, N, K, G, gps,
                                               splits, st);
    case 32:
      return launch_w8a8_mma<BITS, 2, 1, OutT>(xq, q, scales, act, out, ws, M, N, K, G, gps,
                                               splits, st);
    case 64:
      return launch_w8a8_mma<BITS, 4, 1, OutT>(xq, q, scales, act, out, ws, M, N, K, G, gps,
                                               splits, st);
    case 128:
      return launch_w8a8_mma<BITS, 4, 2, OutT>(xq, q, scales, act, out, ws, M, N, K, G, gps,
                                               splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Largest group the int32 dots take: 127 * 127 * 2^17 < 2^31.
constexpr int kW8a8MaxGroup = 1 << 17;

}  // namespace

// x: [M, K] bf16 (x_is_bf16 = 1) or f32, contiguous; q: int8 [K, N]
// (kernel F) or int4-packed [K/2, N] (kernel G); scales: bf16 [K/G, N];
// out: [M, N] in x's type. ks: group slices per block (1, 2, 4 or 8);
// rsplit: row slices per warp (1 or 4, the RS of the kernels); gps: groups
// per K split; ws: f32
// [ceil((K/G)/gps), M, N] when that is > 1. vec: 8 (N % 8 == 0, q 8-byte
// aligned) or 1 columns per thread.
extern "C" int atoma_qmm_i8(const void* x, const void* q, const void* scales,
                            void* out, void* ws, int M, int N, int K, int G,
                            int x_is_bf16, int vec, int ks, int rsplit, int gps,
                            void* stream) {
  return qmm_float_entry<8>(x, q, scales, out, ws, M, N, K, G, x_is_bf16, vec, ks, rsplit,
                            gps, stream);
}

extern "C" int atoma_qmm_i4(const void* x, const void* q, const void* scales,
                            void* out, void* ws, int M, int N, int K, int G,
                            int x_is_bf16, int vec, int ks, int rsplit, int gps,
                            void* stream) {
  return qmm_float_entry<4>(x, q, scales, out, ws, M, N, K, G, x_is_bf16, vec, ks, rsplit,
                            gps, stream);
}

// Kernel H. xq: int8 [M, K] contiguous, 4-byte aligned; act: f32 [M] per-token
// scales; bits: 8 (G % 4 == 0) or 4 (G % 8 == 0); out: [M, N] bf16
// (out_is_bf16 = 1) or f32. The rest as above.
extern "C" int atoma_qmm_w8a8(const void* xq, const void* q, const void* scales,
                              const void* act, void* out, void* ws, int M, int N,
                              int K, int G, int bits, int out_is_bf16, int vec,
                              int ks, int rsplit, int gps, void* stream) {
  Plan p;
  if (K % 4 != 0 || (uintptr_t)xq % 4 != 0) return (int)cudaErrorInvalidValue;
  if (!make_plan(M, N, K, G, bits, vec, ks, rsplit, gps, 1, 4, q, ws, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits == 8) {
    if (out_is_bf16)
      launch_w8a8<__nv_bfloat16, 8>(p, xq, q, scales, act, out, ws, M, N, K, G, vec, ks,
                                    rsplit, gps, st);
    else
      launch_w8a8<float, 8>(p, xq, q, scales, act, out, ws, M, N, K, G, vec, ks, rsplit,
                            gps, st);
  } else {
    if (out_is_bf16)
      launch_w8a8<__nv_bfloat16, 4>(p, xq, q, scales, act, out, ws, M, N, K, G, vec, ks,
                                    rsplit, gps, st);
    else
      launch_w8a8<float, 4>(p, xq, q, scales, act, out, ws, M, N, K, G, vec, ks, rsplit,
                            gps, st);
  }
  return (int)cudaGetLastError();
}

// Kernels F and G on the tensor cores. x: bf16 [M, K]; q: int8 [K, N]
// (atoma_qmm_i8_mma, G % 16 == 0) or int4-packed [K/2, N] (atoma_qmm_i4_mma,
// G % 32 == 0); scales: bf16 [K/G, N]; out: bf16 [M, N]; all contiguous and
// 16-byte aligned, N % 16 == 0. block_rows: activation rows a block (16, 32,
// 64 or 128); gps: groups per K split; ws: f32 [ceil((K/G)/gps), M, N],
// 16-byte aligned, when that is > 1.
extern "C" int atoma_qmm_i8_mma(const void* x, const void* q, const void* scales, void* out,
                                void* ws, int M, int N, int K, int G, int block_rows, int gps,
                                void* stream) {
  return qmm_mma_entry<8, __nv_bfloat16>(x, q, scales, out, ws, M, N, K, G, block_rows, gps,
                                         stream);
}

extern "C" int atoma_qmm_i4_mma(const void* x, const void* q, const void* scales, void* out,
                                void* ws, int M, int N, int K, int G, int block_rows, int gps,
                                void* stream) {
  return qmm_mma_entry<4, __nv_bfloat16>(x, q, scales, out, ws, M, N, K, G, block_rows, gps,
                                         stream);
}

// The same for fp16 activations: x and out fp16 [M, N].
extern "C" int atoma_qmm_i8_mma_f16(const void* x, const void* q, const void* scales, void* out,
                                    void* ws, int M, int N, int K, int G, int block_rows, int gps,
                                    void* stream) {
  return qmm_mma_entry<8, __half>(x, q, scales, out, ws, M, N, K, G, block_rows, gps, stream);
}

extern "C" int atoma_qmm_i4_mma_f16(const void* x, const void* q, const void* scales, void* out,
                                    void* ws, int M, int N, int K, int G, int block_rows, int gps,
                                    void* stream) {
  return qmm_mma_entry<4, __half>(x, q, scales, out, ws, M, N, K, G, block_rows, gps, stream);
}

// Kernel H on the int8 tensor cores. xq: int8 [M, K]; q: int8 [K, N] (bits
// 8, G % 32 == 0) or int4-packed [K/2, N] (bits 4, G % 64 == 0), G at most
// 2^17; scales: bf16 [K/G, N]; act: f32 [M]; out: [M, N] of out_dtype (0
// f32, 1 bf16, 2 fp16); xq, q, scales and out contiguous and 16-byte
// aligned, N % 16 == 0. block_rows, gps and ws as for atoma_qmm_i8_mma.
extern "C" int atoma_qmm_w8a8_mma(const void* xq, const void* q, const void* scales,
                                  const void* act, void* out, void* ws, int M, int N, int K,
                                  int G, int bits, int out_dtype, int block_rows, int gps,
                                  void* stream) {
  if (M < 1 || N < 16 || N % 16 != 0 || G <= 0 || G > kW8a8MaxGroup || K < G || K % G != 0 ||
      (bits != 8 && bits != 4) || G % (bits == 8 ? 32 : 64) != 0 || gps < 1 || act == nullptr)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {xq, q, scales, (const void*)out})
    if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  const int splits = (K / G + gps - 1) / gps;
  if (splits > 1 && (ws == nullptr || (uintptr_t)ws % 16 != 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ATOMA_W8A8_ROWS(B, OUT)                                                      \
  return w8a8_mma_rows<B, OUT>(xq, q, scales, act, out, ws, M, N, K, G, block_rows, gps, \
                               splits, st)
  if (bits == 8) {
    if (out_dtype == 0) ATOMA_W8A8_ROWS(8, float);
    if (out_dtype == 1) ATOMA_W8A8_ROWS(8, __nv_bfloat16);
    if (out_dtype == 2) ATOMA_W8A8_ROWS(8, __half);
  } else {
    if (out_dtype == 0) ATOMA_W8A8_ROWS(4, float);
    if (out_dtype == 1) ATOMA_W8A8_ROWS(4, __nv_bfloat16);
    if (out_dtype == 2) ATOMA_W8A8_ROWS(4, __half);
  }
#undef ATOMA_W8A8_ROWS
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM of one kernel H tensor-core instantiation (bits 8
// or 4, block_rows 16, 32, 64 or 128; bf16 output), or -1.
extern "C" int atoma_qmm_w8a8_mma_blocks_per_sm(int bits, int block_rows) {
  const int b = bits == 8 ? 0 : 1;
  switch (block_rows * 2 + b) {
    case 32: return w8a8_mma_blocks_per_sm<8, 1, 1>();
    case 33: return w8a8_mma_blocks_per_sm<4, 1, 1>();
    case 64: return w8a8_mma_blocks_per_sm<8, 2, 1>();
    case 65: return w8a8_mma_blocks_per_sm<4, 2, 1>();
    case 128: return w8a8_mma_blocks_per_sm<8, 4, 1>();
    case 129: return w8a8_mma_blocks_per_sm<4, 4, 1>();
    case 256: return w8a8_mma_blocks_per_sm<8, 4, 2>();
    case 257: return w8a8_mma_blocks_per_sm<4, 4, 2>();
    default: return -1;
  }
}

// Resident blocks an SM of one tensor-core instantiation (bits 8 or 4,
// block_rows as above), or -1: what the occupancy calculator says, for the
// measurement tools.
extern "C" int atoma_qmm_mma_blocks_per_sm(int bits, int block_rows) {
  const int b = bits == 8 ? 0 : 1;
  switch (block_rows * 2 + b) {
    case 32: return mma_blocks_per_sm<8, 1, 1>();
    case 33: return mma_blocks_per_sm<4, 1, 1>();
    case 64: return mma_blocks_per_sm<8, 2, 1>();
    case 65: return mma_blocks_per_sm<4, 2, 1>();
    case 128: return mma_blocks_per_sm<8, 4, 1>();
    case 129: return mma_blocks_per_sm<4, 4, 1>();
    case 256: return mma_blocks_per_sm<8, 4, 2>();
    case 257: return mma_blocks_per_sm<4, 4, 2>();
    default: return -1;
  }
}
