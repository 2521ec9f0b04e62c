// Kernel D's fused decode variant for bf16 queries over an INT8 cache with
// per-slot scales: the split kernel of fused_decode_split.cuh, which holds
// its notes. Its own source, so that it builds in parallel with the others.

#include "fused_decode_split.cuh"

ATOMA_FUSED_SPLIT_ENTRIES(_int8, __nv_bfloat16, int8_t, atoma::kNarrowDims)
