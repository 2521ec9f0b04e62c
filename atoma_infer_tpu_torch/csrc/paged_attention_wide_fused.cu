// Kernel B for f32 queries over an f32 cache at Phi-3-mini's (96) and
// Gemma-2's (256) head dims, on the CUDA cores: fused_decode_kernel of
// paged_attention.cuh, which holds its notes (bf16 and fp16 queries take the
// split kernel of fused_decode_split.cuh). A source of its own, apart from
// the ragged kernel's (paged_attention_wide.cu), so that the two halves of
// the slowest build run in parallel.

#include "paged_attention.cuh"

ATOMA_FUSED_DECODE_ENTRY(_wide, atoma::SameCache, atoma::kWideDims)
