// Kernel D and its fused variant at head dims 257 to 512 over an INT8 cache
// with per-slot scales: bf16 queries on the tensor cores
// (paged_attention_w512.cuh), f32 queries on the CUDA cores
// (paged_attention.cuh at its padded width 512); each header holds its
// notes. Its own source, so that it builds in parallel with the others.

#include "paged_attention.cuh"
#include "paged_attention_w512.cuh"

ATOMA_PAGED_ATTENTION_ENTRIES(_int8_w512, atoma::Int8Cache, atoma::kW512Dims)
ATOMA_W512_ENTRIES(_int8_w512, __nv_bfloat16, int8_t)
