// Kernel D for bf16 queries over an INT8 cache with per-slot scales on the
// tensor cores, at the narrow widths: the ragged kernel of
// paged_attention_mma.cuh, which holds its notes. A source of its own, apart
// from the CUDA-core kernels of paged_attention_int8.cu, so that the two
// build in parallel.

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RPA_MMA_ENTRIES(_int8, __nv_bfloat16, int8_t, atoma::kNarrowDims)
