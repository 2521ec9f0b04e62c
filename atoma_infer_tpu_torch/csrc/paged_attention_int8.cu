// Kernel D: A over an INT8 KV cache with one bf16 scale per (slot, K/V)
// (ragged_paged_attention_pallas(kv_scales=...),
// atoma_infer_tpu/ops/paged_attention.py :1058); B's variant
// (ragged_paged_attention_fused_quant :1132) is built from
// paged_attention_int8_fused.cu, in parallel. The kernels and their notes
// are in paged_attention.cuh; for bf16 queries the ragged kernel is the
// tensor-core one of paged_attention_mma.cuh (built from
// paged_attention_int8_mma.cu) and the fused one the split kernel of
// fused_decode_split.cuh (built from fused_decode_split*.cu).

#include "paged_attention.cuh"

ATOMA_RAGGED_ATTENTION_ENTRY(_int8, atoma::Int8Cache, atoma::kNarrowDims)
