// Grouped dequantize-matmuls for weight-quantized linears:
//   y[M,N] = sum_g (x[:, group g] @ q[group g, :]) * s[g, :]
//
// Replaces the TPU kernels of atoma_infer_tpu/ops/quant_kernels.py, all
// reached through quantized_matmul_pallas:
//   * kernel F (qmm_float_kernel<T, 8>): _kernel_i8 with _scaled_dot, INT8
//     weights [K, N], bf16 or f32 activations;
//   * kernel G (qmm_float_kernel<T, 4>): _kernel_i4, INT4 weights packed two
//     per byte [K/2, N], group-local halves (rows g*G + r in the low nibble,
//     rows g*G + G/2 + r in the high nibble), each stored as q + 8;
//   * kernel H (qmm_w8a8_kernel<T, BITS>): the ATOMA_W8A8 branch, int8
//     activations (quantized per token by the caller) against int8 or int4
//     weights, each group's dot an exact int32 (__dp4a), times the group's
//     scale in f32, times the token's scale on the output.
// Scales s are bf16 [K/G, N]. Every group's dot is accumulated on its own
// (f32 for F and G, int32 for H) and multiplied by that group's scale before
// it is added into the f32 output sum: the rounding structure of _scaled_dot
// and of the XLA branch of ops/quant.py. Activations stay as given: bf16
// values are exact in f32, and f32 activations are not rounded to bf16 (the
// TPU kernel casts them), so the f32 instantiation is the f32 function.
//
// Bound at decode (M <= 256 rows): bytes. Each weight is one byte (half a
// byte for int4) and does 2*M flops, below the card's balance point until M
// is in the hundreds, so the floor is the weight bytes over 3.35 TB/s. What
// the design does about it:
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
// The products run on the CUDA cores, and prefill rows re-read the weight
// slab from L2 once per 4-row tile, so decode still takes 3-10x its bytes
// bound and a prefill chunk far more (PERF.md); tensor cores (mma/wgmma,
// int8 for H) and a TMA weight stream are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
