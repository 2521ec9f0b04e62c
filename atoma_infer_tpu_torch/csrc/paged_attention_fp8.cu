// Kernel E: A and B over an e4m3 KV cache, scale-free (_kernel with
// fp8=True, atoma_infer_tpu/ops/paged_attention.py:66-85,792-797). Hopper
// widens e4m3 natively (cuda_fp8.h) where the TPU decoded bytes on the VPU.
// The kernels and their notes are in paged_attention.cuh; for bf16
// queries the ragged kernel is the tensor-core one of paged_attention_mma.cuh
// and the fused one the split kernel of fused_decode_split.cuh
// (built from fused_decode_split*.cu).

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(_fp8, atoma::Fp8Cache, atoma::kNarrowDims)
ATOMA_RPA_MMA_ENTRIES(_fp8, __nv_bfloat16, __nv_fp8_e4m3, atoma::kNarrowDims)
