// Kernel D: A and B over an INT8 KV cache with one bf16 scale per (slot,
// K/V) (ragged_paged_attention_pallas(kv_scales=...) and
// ragged_paged_attention_fused_quant, atoma_infer_tpu/ops/paged_attention.py
// :1058,1132). The kernels and their notes are in paged_attention.cuh; for
// bf16 queries the ragged kernel is the tensor-core one of
// paged_attention_mma.cuh (built from paged_attention_int8_mma.cu) and the
// fused one the split kernel of fused_decode_split.cuh (built from
// fused_decode_split*.cu).

#include "paged_attention.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(_int8, atoma::Int8Cache, atoma::kNarrowDims)
