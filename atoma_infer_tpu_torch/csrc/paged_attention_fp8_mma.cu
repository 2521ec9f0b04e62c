// Kernel E for bf16 queries over an e4m3 cache on the tensor cores, at the
// narrow widths: the ragged kernel of paged_attention_mma.cuh, which holds
// its notes. A source of its own, apart from the CUDA-core kernels of
// paged_attention_fp8.cu, so that the two build in parallel.

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RPA_MMA_ENTRIES(_fp8, __nv_bfloat16, __nv_fp8_e4m3, atoma::kNarrowDims)
