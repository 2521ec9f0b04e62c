// Kernel D's fused variant (ragged_paged_attention_fused_quant,
// atoma_infer_tpu/ops/paged_attention.py:1132) over an INT8 cache with
// per-slot scales, on the CUDA cores: fused_decode_kernel of
// paged_attention.cuh, which holds its notes (bf16 and fp16 queries take the
// split kernel of fused_decode_split.cuh). A source of its own, apart from
// the ragged kernel's (paged_attention_int8.cu), so that the two halves of
// the slowest build run in parallel.

#include "paged_attention.cuh"

ATOMA_FUSED_DECODE_ENTRY(_int8, atoma::Int8Cache, atoma::kNarrowDims)
