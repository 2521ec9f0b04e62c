// Kernel E at head dims 96 and 256 for fp16 queries over an e4m3 cache:
// the tensor-core ragged kernel of paged_attention_mma.cuh (which holds its
// notes) with Q = __half. Its own source, so that it builds in parallel
// with the others.

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RPA_MMA_ENTRIES(_fp8_wide_f16, __half, __nv_fp8_e4m3, atoma::kWideDims)
