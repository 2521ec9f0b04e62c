// Kernel D's fused decode variant for fp16 queries over an INT8 cache
// with per-slot bf16 scales:
// the split kernel of fused_decode_split.cuh with Q = __half, which holds
// its notes. Its own source, so that it builds in parallel with the others.

#include "fused_decode_split.cuh"

ATOMA_FUSED_SPLIT_ENTRIES(_int8_f16, __half, int8_t, atoma::kNarrowDims)
