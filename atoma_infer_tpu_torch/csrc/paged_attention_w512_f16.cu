// Kernels A and B at head dims 257 to 512 for fp16 queries over an fp16
// cache: the width-512 kernels of paged_attention_w512.cuh (which holds
// their notes) with Q = C = __half. Its own source, so that it builds in
// parallel with the others.

#include "paged_attention.cuh"
#include "paged_attention_w512.cuh"

ATOMA_W512_ENTRIES(_w512_f16, __half, __half)
