// Kernel D and its fused variant at head dims 257 to 512 for fp16 queries
// over an INT8 cache with per-slot bf16 scales: the width-512 kernels of
// paged_attention_w512.cuh (which holds their notes) with Q = __half. Its
// own source, so that it builds in parallel with the others.

#include "paged_attention.cuh"
#include "paged_attention_w512.cuh"

ATOMA_W512_ENTRIES(_int8_w512_f16, __half, int8_t)
