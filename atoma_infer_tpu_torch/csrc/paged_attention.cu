// Kernels A (ragged paged attention) and B (pure-decode attention with the
// KV write fused in) over a cache in the model's own dtype (bf16 or f32).
// The kernels and their notes are in paged_attention.cuh.

#include "paged_attention.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(, atoma::SameCache)
