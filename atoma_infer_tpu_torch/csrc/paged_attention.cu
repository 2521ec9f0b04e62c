// Kernel A (ragged paged attention) over a cache in the model's own dtype
// (bf16 or f32) on the CUDA cores; B (pure-decode attention with the KV
// write fused in) is built from paged_attention_fused.cu, so that the two
// build in parallel. The kernels and their notes are in paged_attention.cuh;
// for bf16 queries the ragged kernel is the tensor-core one of
// paged_attention_mma.cuh (built from paged_attention_mma.cu) and the fused
// one the split kernel of fused_decode_split.cuh (built from
// fused_decode_split*.cu).

#include "paged_attention.cuh"

ATOMA_RAGGED_ATTENTION_ENTRY(, atoma::SameCache, atoma::kNarrowDims)
