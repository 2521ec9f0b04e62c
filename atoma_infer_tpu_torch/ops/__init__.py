"""Compute ops: hand-written CUDA kernels for Hopper + plain PyTorch versions.

The PyTorch counterpart of ``atoma_infer_tpu/ops`` (whose Pallas kernels are
the TPU versions):

- ``attention``       — metadata contract + dispatch by device
- ``reference``       — plain paged attention (CPU path and kernel oracle)
- ``paged_attention`` — CUDA ragged paged attention + fused decode write
- ``kv_write``        — CUDA ``reshape_and_cache`` KV-cache write
- ``quant``           — INT8/INT4 weight quantization + quantized-matmul dispatch
- ``quant_kernels``   — CUDA grouped dequantize-matmuls (INT8, INT4, W8A8)
- ``kv_cache``        — cache layout helpers, block copy and swap
- ``rope``            — rotary embeddings incl. Llama-3 frequency scaling
- ``cuda_lib``        — nvcc build + ctypes loading of ``csrc/*.cu``
"""
