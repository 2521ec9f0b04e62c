// Kernel E's fused decode variant at head dims 96 and 256 for fp16 queries
// over an e4m3 cache: the split kernel of fused_decode_split.cuh with Q =
// __half, which holds its notes. Its own source, so that it builds in
// parallel with the others.

#include "fused_decode_split.cuh"

ATOMA_FUSED_SPLIT_ENTRIES(_fp8_wide_f16, __half, __nv_fp8_e4m3, atoma::kWideDims)
