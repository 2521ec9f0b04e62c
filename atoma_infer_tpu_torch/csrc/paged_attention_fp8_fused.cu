// Kernel E's fused variant over an e4m3 cache, on the CUDA cores: fused_decode_kernel of
// paged_attention.cuh, which holds its notes (bf16 and fp16 queries take the
// split kernel of fused_decode_split.cuh). A source of its own, apart from
// the ragged kernel's (paged_attention_fp8.cu), so that the two halves of
// the slowest build run in parallel.

#include "paged_attention.cuh"

ATOMA_FUSED_DECODE_ENTRY(_fp8, atoma::Fp8Cache, atoma::kNarrowDims)
