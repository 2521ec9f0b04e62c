"""KV-cache write: the ``reshape_and_cache`` CUDA kernel and its plain version.

Replaces the TPU kernel ``atoma_infer_tpu/ops/kv_write.py:_kernel`` (called
through ``write_kv_cache_pallas``), a page read-modify-write that existed
because Mosaic could only DMA whole pages. The CUDA kernel
(``csrc/kv_write.cu``) stores each valid token's head-interleaved row straight
into ``cache[slot // bs, slot % bs]``. It is bound by bytes moved (K and V in,
one cache row out per token, at 3.35 TB/s); one block per token copies
16-byte vectors with neighbouring threads on neighbouring addresses.

Dispatch: a CUDA cache launches the kernel (or raises); a CPU cache takes
:func:`write_kv_cache_plain`. Both write in place, and give bit-identical
caches: the kernel is a pure copy.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_lib import INT, LONG, PTR
from .kv_cache import kv_rows

KV_WRITE = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="reshape_and_cache",
        source="kv_write.cu",
        symbol="atoma_kv_write",
        argtypes=[PTR, PTR, PTR, PTR, INT, INT, INT, LONG, PTR],
        replaces="atoma_infer_tpu/ops/kv_write.py:120 (write_kv_cache_pallas -> _kernel :60)",
    )
)


def write_kv_cache_plain(
    kv_cache: torch.Tensor,      # [num_pages, bs, 2·Hk·D], updated in place
    k_new: torch.Tensor,         # [T, Hk, D]
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,  # [T] int32, < 0 = padding
) -> None:
    """Plain PyTorch version: drop out-of-range slots (JAX ``mode="drop"``),
    then one indexed store of the fused rows."""
    num_pages, bs, row = kv_cache.shape
    rows = kv_rows(k_new, v_new, kv_cache.dtype)
    slots = slot_mapping.long()
    keep = (slots >= 0) & (slots < num_pages * bs)
    kv_cache.view(num_pages * bs, row)[slots[keep]] = rows[keep]


def write_kv_cache_cuda(
    kv_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,
) -> None:
    """Launch ``reshape_and_cache`` on the current stream (in place)."""
    num_pages, bs, row = kv_cache.shape
    T, hk, d = k_new.shape
    tensors = (kv_cache, k_new, v_new, slot_mapping)
    if not all(t.is_cuda and t.device == kv_cache.device for t in tensors):
        raise ValueError("reshape_and_cache: every tensor must be on the cache's CUDA device")
    if kv_cache.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"reshape_and_cache: unsupported cache dtype {kv_cache.dtype}")
    if k_new.dtype != kv_cache.dtype or v_new.dtype != kv_cache.dtype:
        raise ValueError("reshape_and_cache: k_new/v_new must have the cache's dtype")
    if v_new.shape != k_new.shape or row != 2 * hk * d:
        raise ValueError(
            f"reshape_and_cache: k {tuple(k_new.shape)} / v {tuple(v_new.shape)} "
            f"do not fit cache rows of {row}"
        )
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("reshape_and_cache: slot_mapping must be int32 [T]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("reshape_and_cache: tensors must be contiguous")
    KV_WRITE(
        k_new.data_ptr(),
        v_new.data_ptr(),
        slot_mapping.data_ptr(),
        kv_cache.data_ptr(),
        T,
        hk,
        d * kv_cache.element_size(),
        num_pages * bs,
        cuda_lib.current_stream_handle(kv_cache.device),
    )
