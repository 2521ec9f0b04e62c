// Kernels A and the merge of split rows for fp16 queries over an fp16
// cache: the tensor-core ragged kernel of paged_attention_mma.cuh (which
// holds its notes) with Q = C = __half, and rpa_combine_kernel writing
// fp16. Its own source, so that it builds in parallel with the others.

#include "paged_attention.cuh"
#include "paged_attention_mma.cuh"

ATOMA_RPA_MMA_ENTRIES(_f16, __half, __half, atoma::kAllDims)
ATOMA_SPLIT_COMBINE_ENTRY(_f16, __half)
