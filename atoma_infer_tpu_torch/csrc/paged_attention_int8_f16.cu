// Kernel D for fp16 queries over an INT8 cache with one bf16 scale per
// (slot, K/V): the tensor-core ragged kernel of paged_attention_mma.cuh
// (which holds its notes) with Q = __half, the bytes widened to fp16. Its
// own source, so that it builds in parallel with the others.

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RPA_MMA_ENTRIES(_int8_f16, __half, int8_t, atoma::kNarrowDims)
