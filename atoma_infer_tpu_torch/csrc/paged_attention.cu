// Kernels A (ragged paged attention) and B (pure-decode attention with the
// KV write fused in) over a cache in the model's own dtype (bf16 or f32).
// The kernels and their notes are in paged_attention.cuh; for bf16
// queries the ragged kernel is the tensor-core one of paged_attention_mma.cuh
// (built from paged_attention_mma.cu) and the fused one the split kernel of
// fused_decode_split.cuh (built from fused_decode_split*.cu).

#include "paged_attention.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(, atoma::SameCache, atoma::kNarrowDims)
