// Kernel B's fused decode variant for fp16 queries over an fp16 cache:
// the split kernel of fused_decode_split.cuh with Q = __half, which holds
// its notes. Its own source, so that it builds in parallel with the others.

#include "fused_decode_split.cuh"

ATOMA_FUSED_SPLIT_ENTRIES(_f16, __half, __half, atoma::kAllDims)
