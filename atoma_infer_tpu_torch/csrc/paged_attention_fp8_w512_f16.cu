// Kernel E and its fused variant at head dims 257 to 512 for fp16 queries
// over an e4m3 cache: the width-512 kernels of paged_attention_w512.cuh
// (which holds their notes) with Q = __half. Its own source, so that it
// builds in parallel with the others.

#include "paged_attention.cuh"
#include "paged_attention_w512.cuh"

ATOMA_W512_ENTRIES(_fp8_w512_f16, __half, __nv_fp8_e4m3)
