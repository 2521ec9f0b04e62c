// Kernel A for f32 queries over an f32 cache at Phi-3-mini's (96) and
// Gemma-2's (256) head dims: the CUDA-core ragged kernel of
// paged_attention.cuh, which holds its notes (B's is built from
// paged_attention_wide_fused.cu; bf16 queries take the tensor-core
// instantiations at every head dim). Its own source, so that it builds in
// parallel with the narrow dims' (paged_attention.cu).

#include "paged_attention.cuh"

ATOMA_RAGGED_ATTENTION_ENTRY(_wide, atoma::SameCache, atoma::kWideDims)
