// Kernel E and its fused variant at head dims 257 to 512 over an e4m3
// cache: bf16 queries on the tensor cores (paged_attention_w512.cuh), f32
// queries on the CUDA cores (paged_attention.cuh at its padded width 512);
// each header holds its notes. Its own source, so that it builds in
// parallel with the others.

#include "paged_attention.cuh"
#include "paged_attention_w512.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(_fp8_w512, atoma::Fp8Cache, atoma::kW512Dims)
ATOMA_W512_ENTRIES(_fp8_w512, __nv_bfloat16, __nv_fp8_e4m3)
