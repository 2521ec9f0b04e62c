// Kernel E's fused decode variant at Phi-3-mini's (96) and Gemma-2's (256)
// head dims, for bf16 queries over an e4m3 cache: the split kernel of
// fused_decode_split.cuh, which holds its notes. Its own source, so that it
// builds in parallel with the narrow dims' (fused_decode_split_fp8.cu).

#include "fused_decode_split.cuh"

ATOMA_FUSED_SPLIT_ENTRIES(_fp8_wide, __nv_bfloat16, __nv_fp8_e4m3, atoma::kWideDims)
