// Kernel E at Phi-3-mini's (96) and Gemma-2's (256) head dims over an e4m3
// cache: the tensor-core ragged kernel of paged_attention_mma.cuh for bf16
// queries, and the CUDA-core ragged kernel of paged_attention.cuh for f32
// queries (each header holds its notes; the f32 fused kernel is built from
// paged_attention_fp8_wide_fused.cu). Its own source, so that it builds in
// parallel with the narrow dims' (paged_attention_fp8.cu).

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RAGGED_ATTENTION_ENTRY(_fp8_wide, atoma::Fp8Cache, atoma::kWideDims)
ATOMA_RPA_MMA_ENTRIES(_fp8_wide, __nv_bfloat16, __nv_fp8_e4m3, atoma::kWideDims)
