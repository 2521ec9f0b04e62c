// KV-cache element types: widening a cache element to f32, and storing a
// new K/V value into the cache, for every cache the port takes:
//   * float / __nv_bfloat16 / __half: the model's own dtype, stored as is;
//   * int8_t: symmetric absmax INT8 with one bf16 scale per (slot, K/V);
//   * __nv_fp8_e4m3: e4m3 (OCP "fn", no infinities), scale-free.
//
// The arithmetic is that of atoma_infer_tpu/ops/kv_cache.py, step for step,
// so the bytes equal the JAX package's and the port's plain versions:
//   scale = bf16(max(absmax / 127, 1e-8))     kv_quant_scales  (:134-143)
//   q     = clip(rint(x * (1 / scale)), ±127) quantize_kv_rows (:146-162)
//   e4m3  = rn(clip(x, ±448))                 kv_rows          (:67-76)
// Division is IEEE (the build has no --use_fast_math), rintf rounds half to
// even like jnp.round and torch.round, and x * (1 / s) is kept as a
// reciprocal multiply: x / s differs from it in the last bit, which flips a
// rounding at .5. Writes clip to ±448 first, so the e4m3 NaN bytes 0x7F and
// 0xFF are never stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace atoma {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

// Caches that carry per-(slot, K/V) scales.
template <typename C>
constexpr bool kScaled = std::is_same<C, int8_t>::value;

// One new value, stored in the cache's element type. ``inv`` is the
// reciprocal of the row's scale (INT8 only).
template <typename C>
__device__ __forceinline__ C encode(float x, float inv);
template <>
__device__ __forceinline__ float encode<float>(float x, float) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 encode<__nv_bfloat16>(float x, float) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half encode<__half>(float x, float) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ int8_t encode<int8_t>(float x, float inv) {
  return (int8_t)fminf(fmaxf(rintf(x * inv), -127.f), 127.f);
}
template <>
__device__ __forceinline__ __nv_fp8_e4m3 encode<__nv_fp8_e4m3>(float x, float) {
  __nv_fp8_e4m3 r;
  r.__x = __nv_cvt_float_to_fp8(fminf(fmaxf(x, -448.f), 448.f), __NV_SATFINITE,
                                __NV_E4M3);
  return r;
}

// The INT8 scale of one token's K (or V) row from its absmax over all kv
// heads, rounded to bf16: the stored value is the one every path uses.
__device__ __forceinline__ __nv_bfloat16 kv_scale(float absmax) {
  return __float2bfloat16_rn(fmaxf(absmax / 127.f, 1e-8f));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Absmax of a token's K row and of its V row ([Hk*D] each) over the whole
// block; every thread gets both. ``red`` holds 2 floats per warp. Max is
// exact and independent of order, so every block that computes it for the
// same token gets the same value.
template <typename T>
__device__ __forceinline__ void row_absmax(const T* k, const T* v, int n,
                                           float* red, float& mk, float& mv) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = (blockDim.x + 31) / 32;
  float a = 0.f, b = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    a = fmaxf(a, fabsf(to_float(k[i])));
    b = fmaxf(b, fabsf(to_float(v[i])));
  }
  a = warp_max(a);
  b = warp_max(b);
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  mk = 0.f;
  mv = 0.f;
  for (int w = 0; w < nwarps; ++w) {
    mk = fmaxf(mk, red[2 * w]);
    mv = fmaxf(mv, red[2 * w + 1]);
  }
}

}  // namespace atoma
