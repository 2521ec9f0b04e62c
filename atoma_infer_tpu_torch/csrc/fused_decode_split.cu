// Kernel B's fused decode variant for bf16 queries over a bf16 cache:
// the split kernel of fused_decode_split.cuh, which holds its notes. Its own
// source, so that it builds in parallel with the others.

#include "fused_decode_split.cuh"

ATOMA_FUSED_SPLIT_ENTRIES(, __nv_bfloat16, __nv_bfloat16, atoma::kAllDims)
