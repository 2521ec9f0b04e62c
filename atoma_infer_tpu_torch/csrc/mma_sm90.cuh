// Device helpers shared by the port's tensor-core kernels (kernel I in
// w8a8_probe.cu, kernels F and G's tensor-core route in quant_matmul.cu):
// cp.async copies into shared memory, ldmatrix and 32-bit shared loads for
// the fragments, the byte transpose and the int8 -> bf16 widening that turn
// a raw [K, N] weight tile into B fragments, and warp-level mma.sync.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Transpose a 4 x 4 block of bytes: r[i] holds row i (bytes = columns 0..3);
// t[j] receives column j (bytes = rows 0..3), lowest row in the lowest byte.
__device__ __forceinline__ void transpose4x4(const uint32_t* r, uint32_t (&t)[4]) {
  const uint32_t x0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t x1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t y0 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t y1 = __byte_perm(r[2], r[3], 0x7362);
  t[0] = __byte_perm(x0, y0, 0x5410);
  t[1] = __byte_perm(x0, y0, 0x7632);
  t[2] = __byte_perm(x1, y1, 0x5410);
  t[3] = __byte_perm(x1, y1, 0x7632);
}

// The prmt selector that puts byte j of `lo` in bytes 0-1 and byte j of
// `hi` in bytes 2-3 of __byte_perm(lo, hi, sel).
__device__ __forceinline__ uint32_t pair_selector(int j) {
  return j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
}

// Byte j of `lo` and byte j of `hi` as a bf16 pair (lo in the low half),
// exactly: 128 + (v & 127) minus 128 + (v & 128), both built by bit
// operations (0x4300 is bf16 128; the sign bit 0x80 is the exponent's low
// bit, making 256), subtracted by one bf16x2 fma (exact: v has at most 8
// significant bits).
__device__ __forceinline__ uint32_t widen_pair(uint32_t lo, uint32_t hi, int j) {
  const uint32_t p = __byte_perm(lo, hi, pair_selector(j));  // byte 0 = lo.bj, byte 2 = hi.bj
  const uint32_t pos = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t neg = (p & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(neg), "r"(0xBF80BF80u), "r"(pos));
  return d;
}

__device__ __forceinline__ void mma_int8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product into c with zero addends: c = a b, whatever c held.
__device__ __forceinline__ void mma_bf16_fresh(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

}  // namespace
