// reshape_and_cache: scatter one step's K/V rows into the paged KV cache.
//
// Replaces the TPU kernel atoma_infer_tpu/ops/kv_write.py:_kernel (called
// through write_kv_cache_pallas). The cache is page-major and head-interleaved,
// [num_pages, block_size, 2*Hk*D] with row [K_h0 | V_h0 | K_h1 | V_h1 | ...],
// so a contiguous cache is a flat [num_pages*block_size, 2*Hk*D] array indexed
// by slot. Slots < 0 (padding) and >= num_slots are dropped.
//
// Bound: bytes. Each valid token reads its K and V rows and writes one cache
// row (2*Hk*D elements each way); at 3.35 TB/s that is the whole cost. The
// kernel does no arithmetic: one block per token, its threads copy 16-byte
// vectors (narrower only when a head's row is not 16-byte aligned: 4 bytes,
// 2 for an odd head dim in 16 bits, else 1), neighbouring threads on
// neighbouring addresses. The TPU kernel's page read-modify-write (it could
// only DMA whole pages) is not needed: a GPU stores rows directly.
// A pure copy, so the result is bit-identical to the plain version, for a
// bf16, fp16 or f32 cache alike.
//
// The same scatter into a 1-byte cache (kv_write_fp8 / kv_write_int8 below)
// converts on the way: e4m3 clipped to +-448 (TPU kernel C on e4m3 bytes,
// kv_write.py:131-136,181), or INT8 with each token's K and V scales computed
// from the absmax of its whole K and V rows, then stored beside the row
// (write_kv_cache_quant, ops/kv_cache.py:165-186, XLA in the JAX package).
// Under tensor parallelism a rank's rows hold only its kv heads, so the
// caller passes the token's scales, taken over every rank's heads, in
// scales_new ([T, 2] f32, already rounded through bf16; JAX's scales= at
// ops/attention.py:377-400), and the kernel stores those instead.
// Still bound by bytes: the inputs in, half as many bytes out per element.
// The conversions (kv_quant.cuh) give the plain versions' bytes exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_quant.cuh"

template <typename V>
__global__ void kv_write_kernel(const V* __restrict__ k_new,
                                const V* __restrict__ v_new,
                                const int* __restrict__ slot_mapping,
                                V* __restrict__ cache,
                                int num_kv_heads, int head_vecs,
                                long long num_slots) {
  const int t = blockIdx.x;
  const long long slot = slot_mapping[t];
  if (slot < 0 || slot >= num_slots) return;
  const int row_vecs = 2 * num_kv_heads * head_vecs;
  const V* k = k_new + (long long)t * num_kv_heads * head_vecs;
  const V* v = v_new + (long long)t * num_kv_heads * head_vecs;
  V* dst = cache + slot * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    const int h = i / (2 * head_vecs);
    const int r = i - h * 2 * head_vecs;
    dst[i] = r < head_vecs ? k[h * head_vecs + r] : v[h * head_vecs + r - head_vecs];
  }
}

template <typename V>
static void launch(const void* k, const void* v, const int* slots, void* cache,
                   int num_tokens, int num_kv_heads, int head_bytes,
                   long long num_slots, cudaStream_t stream) {
  const int head_vecs = head_bytes / (int)sizeof(V);
  int threads = 2 * num_kv_heads * head_vecs;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  kv_write_kernel<V><<<num_tokens, threads, 0, stream>>>(
      (const V*)k, (const V*)v, slots, (V*)cache, num_kv_heads, head_vecs,
      num_slots);
}

// k_new, v_new: [T, Hk, D] contiguous, the cache's element type.
// cache: [num_slots, 2*Hk*D] contiguous. head_bytes = D * element size.
extern "C" int atoma_kv_write(const void* k_new, const void* v_new,
                              const void* slot_mapping, void* cache,
                              int num_tokens, int num_kv_heads, int head_bytes,
                              long long num_slots, void* stream) {
  if (num_tokens <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* slots = (const int*)slot_mapping;
  const uintptr_t addr = (uintptr_t)k_new | (uintptr_t)v_new | (uintptr_t)cache;
  if (head_bytes % 16 == 0 && addr % 16 == 0) {
    launch<uint4>(k_new, v_new, slots, cache, num_tokens, num_kv_heads,
                  head_bytes, num_slots, s);
  } else if (head_bytes % 4 == 0 && addr % 4 == 0) {
    launch<uint32_t>(k_new, v_new, slots, cache, num_tokens, num_kv_heads,
                     head_bytes, num_slots, s);
  } else if (head_bytes % 2 == 0 && addr % 2 == 0) {  // an odd head dim in 16 bits
    launch<uint16_t>(k_new, v_new, slots, cache, num_tokens, num_kv_heads,
                     head_bytes, num_slots, s);
  } else {
    launch<uint8_t>(k_new, v_new, slots, cache, num_tokens, num_kv_heads,
                    head_bytes, num_slots, s);
  }
  return (int)cudaGetLastError();
}

// ----------------------------------------------------- 1-byte caches
namespace {

// One block per token. Element i of the cache row is head i / (2D), K half
// if i % (2D) < D; ``scales`` ([num_slots, 2] bf16) is written for INT8 only,
// from ``scales_new`` ([T, 2] f32) when it is set, else from the row's absmax.
template <typename T, typename C>
__global__ void kv_write_convert_kernel(const T* __restrict__ k_new,
                                        const T* __restrict__ v_new,
                                        const int* __restrict__ slot_mapping,
                                        C* __restrict__ cache,
                                        __nv_bfloat16* __restrict__ scales,
                                        const float* __restrict__ scales_new,
                                        int num_kv_heads, int head_dim,
                                        long long num_slots) {
  __shared__ float red[64];
  const int t = blockIdx.x;
  const long long slot = slot_mapping[t];
  if (slot < 0 || slot >= num_slots) return;  // uniform over the block
  const int n = num_kv_heads * head_dim;
  const T* k = k_new + (long long)t * n;
  const T* v = v_new + (long long)t * n;
  float inv_k = 1.f, inv_v = 1.f;
  if constexpr (atoma::kScaled<C>) {
    __nv_bfloat16 sk, sv;
    if (scales_new != nullptr) {  // uniform over the grid
      sk = __float2bfloat16_rn(scales_new[2 * t]);
      sv = __float2bfloat16_rn(scales_new[2 * t + 1]);
    } else {
      float mk, mv;
      atoma::row_absmax(k, v, n, red, mk, mv);
      sk = atoma::kv_scale(mk);
      sv = atoma::kv_scale(mv);
    }
    inv_k = 1.f / __bfloat162float(sk);
    inv_v = 1.f / __bfloat162float(sv);
    if (threadIdx.x == 0) {
      scales[2 * slot] = sk;
      scales[2 * slot + 1] = sv;
    }
  }
  C* dst = cache + slot * 2 * n;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const int h = i / (2 * head_dim), r = i - h * 2 * head_dim;
    dst[i] = r < head_dim
                 ? atoma::encode<C>(atoma::to_float(k[h * head_dim + r]), inv_k)
                 : atoma::encode<C>(atoma::to_float(v[h * head_dim + r - head_dim]), inv_v);
  }
}

template <typename C>
int launch_convert(int dtype, const void* k, const void* v, const void* slots,
                   void* cache, void* scales, const void* scales_new,
                   int num_tokens, int num_kv_heads,
                   int head_dim, long long num_slots, void* stream) {
  if (num_tokens <= 0) return 0;
  int threads = 2 * num_kv_heads * head_dim;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : (threads + 31) / 32 * 32);
  cudaStream_t s = (cudaStream_t)stream;
#define ATOMA_CONVERT(T)                                                      \
  kv_write_convert_kernel<T, C><<<num_tokens, threads, 0, s>>>(               \
      (const T*)k, (const T*)v, (const int*)slots, (C*)cache,                 \
      (__nv_bfloat16*)scales, (const float*)scales_new, num_kv_heads,         \
      head_dim, num_slots)
  if (dtype == 0) {
    ATOMA_CONVERT(float);
  } else if (dtype == 1) {
    ATOMA_CONVERT(__nv_bfloat16);
  } else if (dtype == 2) {
    ATOMA_CONVERT(__half);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef ATOMA_CONVERT
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of k_new/v_new: 0 = float32, 1 = bfloat16, 2 = float16. cache: [num_slots,
// 2*Hk*D] float8_e4m3fn.
extern "C" int atoma_kv_write_fp8(int dtype, const void* k_new, const void* v_new,
                                  const void* slot_mapping, void* cache,
                                  int num_tokens, int num_kv_heads, int head_dim,
                                  long long num_slots, void* stream) {
  return launch_convert<__nv_fp8_e4m3>(dtype, k_new, v_new, slot_mapping, cache,
                                       nullptr, nullptr, num_tokens, num_kv_heads,
                                       head_dim, num_slots, stream);
}

// As above into an int8 cache, plus scales [num_slots, 2] bf16 (K, V);
// scales_new: null, or the tokens' scales [T, 2] f32 to store instead of the
// rows' own.
extern "C" int atoma_kv_write_int8(int dtype, const void* k_new, const void* v_new,
                                   const void* slot_mapping, void* cache,
                                   void* scales, const void* scales_new,
                                   int num_tokens, int num_kv_heads,
                                   int head_dim, long long num_slots, void* stream) {
  return launch_convert<int8_t>(dtype, k_new, v_new, slot_mapping, cache, scales,
                                scales_new, num_tokens, num_kv_heads, head_dim,
                                num_slots, stream);
}
