// Kernels A and B for f32 queries over an f32 cache at Phi-3-mini's (96)
// and Gemma-2's (256) head dims: the CUDA-core kernels of
// paged_attention.cuh, which hold their notes (bf16 queries take the
// tensor-core instantiations of paged_attention.cu at every head dim). Its
// own source, so that it builds in parallel with the narrow dims'
// (paged_attention.cu).

#include "paged_attention.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(_wide, atoma::SameCache, atoma::kWideDims)
