// Kernels A and B at head dims 257 to 512 (the width 512) over a cache in
// the queries' dtype: bf16 queries on the tensor cores (the ragged and the
// fused kernel of paged_attention_w512.cuh), f32 queries on the CUDA cores
// (rpa_kernel and fused_decode_kernel of paged_attention.cuh at their
// padded width 512); each header holds its notes. Its own source, so that
// it builds in parallel with the narrower widths'.

#include "paged_attention.cuh"
#include "paged_attention_w512.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(_w512, atoma::SameCache, atoma::kW512Dims)
ATOMA_W512_ENTRIES(_w512, __nv_bfloat16, __nv_bfloat16)
