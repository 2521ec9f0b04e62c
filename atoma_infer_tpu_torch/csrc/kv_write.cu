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
// vectors (narrower only when a head's row is not 16-byte aligned), neighbouring
// threads on neighbouring addresses. The TPU kernel's page read-modify-write
// (it could only DMA whole pages) is not needed: a GPU stores rows directly.
// A pure copy, so the result is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

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
  } else {
    launch<uint8_t>(k_new, v_new, slots, cache, num_tokens, num_kv_heads,
                    head_bytes, num_slots, s);
  }
  return (int)cudaGetLastError();
}
