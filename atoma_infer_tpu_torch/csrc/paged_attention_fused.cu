// Kernel B (pure-decode attention with the KV write fused in) over a cache
// in the model's own dtype (bf16 or f32) on the CUDA cores: fused_decode_kernel of
// paged_attention.cuh, which holds its notes (bf16 and fp16 queries take the
// split kernel of fused_decode_split.cuh). A source of its own, apart from
// the ragged kernel's (paged_attention.cu), so that the two halves of
// the slowest build run in parallel.

#include "paged_attention.cuh"

ATOMA_FUSED_DECODE_ENTRY(, atoma::SameCache, atoma::kNarrowDims)
