// Kernel E: A over an e4m3 KV cache, scale-free (_kernel with fp8=True,
// atoma_infer_tpu/ops/paged_attention.py:66-85,792-797); B's variant is
// built from paged_attention_fp8_fused.cu, in parallel. Hopper widens e4m3
// natively (cuda_fp8.h) where the TPU decoded bytes on the VPU.
// The kernels and their notes are in paged_attention.cuh; for bf16
// queries the ragged kernel is the tensor-core one of paged_attention_mma.cuh
// (built from paged_attention_fp8_mma.cu) and the fused one the split kernel
// of fused_decode_split.cuh (built from fused_decode_split*.cu).

#include "paged_attention.cuh"

ATOMA_RAGGED_ATTENTION_ENTRY(_fp8, atoma::Fp8Cache, atoma::kNarrowDims)
