// The W8A8 rate probe's matmul on the tensor cores: out[M,N] = x[M,K] @ w[K,N]
// in f32, with no scales.
//
// Replaces kernel I, the TPU kernel of tools/w8a8_probe.py (`matmul` :33, body
// `kern` :20), in both of its forms:
//   * mixed (probe_mma<false>): x bf16, w int8, products summed in f32;
//   * int8  (probe_mma<true>):  x int8, w int8, an exact int32 sum converted
//     once to f32 with round-to-nearest (__int2float_rn), as the TPU kernel's
//     `.astype(f32)` of its int32 accumulator does at its last k step.
// The probe asks what rate the matrix units reach, so both run on the tensor
// cores through warp-level mma.sync: m16n8k32 s8.s8.s32 for int8, m16n8k16
// bf16 (f32 accumulate) for mixed, whose int8 weights are widened to bf16
// (exactly) while they are staged in shared memory. The TPU kernel's grid
// (n_n, n_k), its 1024 x 2048 blocks and its VMEM accumulator are TPU blocking
// and are not carried over: here each block owns a 64 x 128 output tile and
// loops over K itself, the sum held in registers.
//
// Bound at the probe's shape (M = 184, K = 4096, N = 14336): the weight, 58.7
// MB, is most of the 70.8 MB the call must move (21.1 us at 3.35 TB/s); the
// bf16 products need 21.8 us at 989 TFLOP/s and the int8 ones 10.9 us at
// 1,979 TOP/s, so mixed is bounded by operations and int8 by bytes. What the
// design does about it:
//  * w is read as the TPU kernel reads it, [K, N] with N contiguous, in no
//    separate pass. The int8 mma wants each B register to hold four
//    consecutive k of one column, and ldmatrix.trans moves only 16-bit
//    elements, so each thread loads a 4 k x 4 n block of bytes as four 32-bit
//    words and transposes it in registers with __byte_perm (prmt) before it
//    stores the words into shared memory as [n][k] (bf16 pairs for mixed);
//  * every fragment is then one 32-bit shared-memory load per register; the
//    row strides are padded so that those loads hit distinct banks;
//  * the next k tile's global loads are issued into registers before the
//    current tile's mma loop, so their latency hides behind it (one shared
//    buffer, two barriers a tile);
//  * the M tiles of one column slab are the fastest grid index: they run
//    together and read the slab from device memory once, then from L2.
// Rows past M are zero in shared memory and never stored. No cp.async, TMA
// or wgmma yet: those, and tuning, are later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N
constexpr int kBM = 64;         // output rows a block
constexpr int kBN = 128;        // output columns a block
constexpr int kBK = 64;         // k a shared-memory tile
constexpr int kWarpM = 32;      // a warp's output rows: 2 m16 fragments
constexpr int kWarpN = 32;      // a warp's output columns: 4 n8 fragments

// Shared-memory row strides in 32-bit words. A tile row holds kBK k values:
// 16 words of int8, 32 of bf16 pairs. A fragment load reads rows g = 0..7
// at words tig = 0..3 (plus a constant): a stride of 4 mod 32 words (20 and
// 36) puts those 32 words in 32 banks. The int8 weight tile is stored one
// word a thread from the transposes, rows 4nq + j, word kq over
// nq = 0..7, kq = 0..3 in a warp: a stride of 17 puts those in 32 banks too
// (its fragment loads then meet at most 2 to a bank).
template <bool INT8> struct Layout;
template <> struct Layout<true> {
  static constexpr int kWords = kBK / 4;   // words of one row of a tile
  static constexpr int kStrideA = 20;
  static constexpr int kStrideB = 17;
};
template <> struct Layout<false> {
  static constexpr int kWords = kBK / 2;
  static constexpr int kStrideA = 36;
  static constexpr int kStrideB = 36;
};

// Transpose a 4 x 4 block of bytes: r[i] holds row i (bytes = columns 0..3);
// t[j] receives column j (bytes = rows 0..3), lowest row in the lowest byte.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&t)[4]) {
  const uint32_t x0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t x1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t y0 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t y1 = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// One signed byte of a word as the bits of a bf16 (exact: |v| <= 128 has at
// most 8 significant bits, so the float's low half is zero).
__device__ __forceinline__ uint32_t byte_as_bf16(uint32_t word, int i) {
  const int v = (int)(int8_t)(word >> (8 * i));
  return __float_as_uint((float)v) >> 16;
}

__device__ __forceinline__ void mma_int8(int (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k tile's global data, held in registers between its load and its store
// into shared memory. The weight tile is kBK x kBN bytes = 512 blocks of
// 4 k x 4 n, two a thread; block b covers column quad nq and k quad kq with
// nq = b % 8 + 8 * ((b / 32) % 4) and kq = (b / 8) % 4 + 4 * (b / 128), so a
// warp's loads read 32 contiguous bytes of each of 16 rows. The activation
// tile is kBM rows of kBK values, in 16-byte chunks: one a thread for int8,
// two for bf16.
template <bool INT8>
struct Staged {
  static constexpr int kChunksA = kBM * kBK * (INT8 ? 1 : 2) / 16 / kThreads;
  uint32_t w[2][4];
  uint4 a[kChunksA];
};

__device__ __forceinline__ void weight_block(int b, int& nq, int& kq) {
  nq = b % 8 + 8 * ((b / 32) % 4);
  kq = (b / 8) % 4 + 4 * (b / 128);
}

template <bool INT8>
__device__ __forceinline__ void load_tile(Staged<INT8>& s, const void* __restrict__ x,
                                          const int8_t* __restrict__ w, int M, int N, int K,
                                          int m0, int n0, int k0) {
  const int t = threadIdx.x;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    int nq, kq;
    weight_block(t + p * kThreads, nq, kq);
    const int8_t* src = w + (size_t)(k0 + 4 * kq) * N + n0 + 4 * nq;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      s.w[p][r] = __ldg(reinterpret_cast<const uint32_t*>(src + (size_t)r * N));
  }
  constexpr int kChunksRow = kBK * (INT8 ? 1 : 2) / 16;
#pragma unroll
  for (int i = 0; i < Staged<INT8>::kChunksA; ++i) {
    const int c = t + i * kThreads;
    const int row = c / kChunksRow, chunk = c % kChunksRow;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + row < M) {
      const char* base = reinterpret_cast<const char*>(x);
      const size_t row_bytes = (size_t)K * (INT8 ? 1 : 2);
      v = __ldg(reinterpret_cast<const uint4*>(base + (size_t)(m0 + row) * row_bytes +
                                               (size_t)k0 * (INT8 ? 1 : 2) + 16 * chunk));
    }
    s.a[i] = v;
  }
}

template <bool INT8>
__device__ __forceinline__ void store_tile(const Staged<INT8>& s, uint32_t* As, uint32_t* Bs) {
  using L = Layout<INT8>;
  const int t = threadIdx.x;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    int nq, kq;
    weight_block(t + p * kThreads, nq, kq);
    uint32_t col[4];
    transpose4x4(s.w[p], col);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t* row = Bs + (4 * nq + j) * L::kStrideB;
      if constexpr (INT8) {
        row[kq] = col[j];
      } else {
        const uint2 pair = make_uint2(byte_as_bf16(col[j], 0) | (byte_as_bf16(col[j], 1) << 16),
                                      byte_as_bf16(col[j], 2) | (byte_as_bf16(col[j], 3) << 16));
        *reinterpret_cast<uint2*>(row + 2 * kq) = pair;
      }
    }
  }
  constexpr int kChunksRow = kBK * (INT8 ? 1 : 2) / 16;
#pragma unroll
  for (int i = 0; i < Staged<INT8>::kChunksA; ++i) {
    const int c = t + i * kThreads;
    const int row = c / kChunksRow, chunk = c % kChunksRow;
    *reinterpret_cast<uint4*>(As + row * L::kStrideA + 4 * chunk) = s.a[i];
  }
}

// x: [M, K] int8 (INT8) or bf16, w: [K, N] int8, out: [M, N] f32, all
// contiguous; K % 64 == 0, N % 128 == 0, any M >= 1 (the wrapper checks).
// Grid: (ceil(M / 64), N / 128), 256 threads.
template <bool INT8>
__global__ void __launch_bounds__(kThreads)
    probe_mma(const void* __restrict__ x, const int8_t* __restrict__ w,
              float* __restrict__ out, int M, int N, int K) {
  using L = Layout<INT8>;
  __shared__ __align__(16) uint32_t As[kBM * L::kStrideA];
  __shared__ __align__(16) uint32_t Bs[kBN * L::kStrideB];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp / 4) * kWarpM, wn = (warp % 4) * kWarpN;

  using Acc = typename std::conditional<INT8, int, float>::type;
  Acc acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  Staged<INT8> staged;
  load_tile<INT8>(staged, x, w, M, N, K, m0, n0, 0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous tile's fragments are read
    store_tile<INT8>(staged, As, Bs);
    __syncthreads();
    if (k0 + kBK < K) load_tile<INT8>(staged, x, w, M, N, K, m0, n0, k0 + kBK);
    // 8 words of k a step: one k32 step of int8, one k16 step of bf16.
#pragma unroll
    for (int kw = 0; kw < L::kWords; kw += 8) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint32_t* r0 = As + (wm + 16 * mi + g) * L::kStrideA + kw + tig;
        const uint32_t* r8 = r0 + 8 * L::kStrideA;
        a[mi][0] = r0[0];
        a[mi][1] = r8[0];
        a[mi][2] = r0[4];
        a[mi][3] = r8[4];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t* col = Bs + (wn + 8 * ni + g) * L::kStrideB + kw + tig;
        b[ni][0] = col[0];
        b[ni][1] = col[4];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (INT8)
            mma_int8(acc[mi][ni], a[mi], b[ni]);
          else
            mma_bf16(acc[mi][ni], a[mi], b[ni]);
        }
    }
  }

  // c0, c1: row g, columns 2 tig and 2 tig + 1; c2, c3: row g + 8.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + 16 * mi + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + wn + 8 * ni + 2 * tig;
        float2 v;
        if constexpr (INT8) {
          v = make_float2(__int2float_rn(acc[mi][ni][2 * half]),
                          __int2float_rn(acc[mi][ni][2 * half + 1]));
        } else {
          v = make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        }
        *reinterpret_cast<float2*>(out + (size_t)row * N + c) = v;
      }
    }
}

template <bool INT8>
int launch(const void* x, const void* w, void* out, int M, int N, int K, void* stream) {
  if (M < 1 || K < kBK || K % kBK != 0 || N < kBN || N % kBN != 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)w % 4 != 0 || (uintptr_t)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBM - 1) / kBM, N / kBN);
  probe_mma<INT8><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, static_cast<const int8_t*>(w), static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 [M, K], w: int8 [K, N], out: f32 [M, N]; contiguous, K % 64 == 0,
// N % 128 == 0. Returns the launch's cudaError_t.
extern "C" int atoma_probe_mixed(const void* x, const void* w, void* out, int M, int N,
                                 int K, void* stream) {
  return launch<false>(x, w, out, M, N, K, stream);
}

// x: int8 [M, K], the rest as above.
extern "C" int atoma_probe_int8(const void* x, const void* w, void* out, int M, int N,
                                int K, void* stream) {
  return launch<true>(x, w, out, M, N, K, stream);
}
