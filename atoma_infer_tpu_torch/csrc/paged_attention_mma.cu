// Kernel A for bf16 queries over a bf16 cache on the tensor cores (the
// ragged kernel of paged_attention_mma.cuh, which holds its notes), and the
// merge of split rows writing bf16. A source of its own, apart from the
// CUDA-core kernels of paged_attention.cu, so that the two build in
// parallel.

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RPA_MMA_ENTRIES(, __nv_bfloat16, __nv_bfloat16, atoma::kAllDims)
ATOMA_SPLIT_COMBINE_ENTRY(, __nv_bfloat16)
