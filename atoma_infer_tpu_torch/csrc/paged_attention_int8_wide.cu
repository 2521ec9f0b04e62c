// Kernel D at Phi-3-mini's (96) and Gemma-2's (256) head dims over an INT8
// cache with per-slot scales: the tensor-core ragged kernel of
// paged_attention_mma.cuh for bf16 queries, and the CUDA-core ragged
// kernel of paged_attention.cuh for f32 queries (each header holds its
// notes; the f32 fused kernel is built from paged_attention_int8_wide_fused.cu).
// Its own source, so that it builds in parallel with the narrow dims'
// (paged_attention_int8.cu).

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RAGGED_ATTENTION_ENTRY(_int8_wide, atoma::Int8Cache, atoma::kWideDims)
ATOMA_RPA_MMA_ENTRIES(_int8_wide, __nv_bfloat16, int8_t, atoma::kWideDims)
