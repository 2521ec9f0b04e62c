"""KV-cache write: the ``reshape_and_cache`` CUDA kernels and their plain versions.

Replaces the TPU kernel ``atoma_infer_tpu/ops/kv_write.py:_kernel`` (called
through ``write_kv_cache_pallas``), a page read-modify-write that existed
because Mosaic could only DMA whole pages. The CUDA kernels
(``csrc/kv_write.cu``) store each valid token's head-interleaved row straight
into ``cache[slot // bs, slot % bs]``, one block per token:

* ``reshape_and_cache``: a bf16/f32 cache, a pure copy of 16-byte vectors;
* ``reshape_and_cache_fp8``: an e4m3 cache (the TPU kernel on e4m3 bytes,
  ``kv_write.py:131-136,181``): clipped to ±448, rounded to nearest even;
* ``reshape_and_cache_int8``: an INT8 cache with its scales, which the JAX
  package writes with XLA ops (``write_kv_cache_quant``,
  ``ops/kv_cache.py:165-186``): each token's K and V scales from the absmax
  of its whole K and V rows, or from ``scales_new`` [T, 2] when the caller
  gives them (tensor parallelism: a rank's rows hold only its kv heads, and
  the scales are taken over every rank's, as JAX's ``scales=`` at
  ``ops/attention.py:377-400``), the quantized row and the scale pair
  stored in its slot. One launch instead of some eight eager ops per layer.

fp16 rows (float16 models) take the same kernels: the copy is a copy of
bytes, the converting kernels widen fp16 exactly (``kv_write.cu``'s dtype
2). Each has its own launch counter (``*_f16``) over the same C entry, so
that a run shows its fp16 launches apart.

All are bound by bytes moved (K and V in, one cache row out per token, at
3.35 TB/s). Dispatch: a CUDA cache launches the kernel of its dtype (or
raises); a CPU cache takes the plain version. Both write in place, and give
bit-identical caches and scales.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .cuda_lib import INT, LONG, PTR
from .kv_cache import kv_quant_scales, kv_rows, quantize_kv_rows

# dtype codes of k_new/v_new for the converting kernels.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

KV_WRITE = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="reshape_and_cache",
        source="kv_write.cu",
        symbol="atoma_kv_write",
        argtypes=[PTR, PTR, PTR, PTR, INT, INT, INT, LONG, PTR],
        replaces="atoma_infer_tpu/ops/kv_write.py:120 (write_kv_cache_pallas -> _kernel :60)",
    )
)
KV_WRITE_FP8 = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="reshape_and_cache_fp8",
        source="kv_write.cu",
        symbol="atoma_kv_write_fp8",
        argtypes=[INT, PTR, PTR, PTR, PTR, INT, INT, INT, LONG, PTR],
        replaces=(
            "atoma_infer_tpu/ops/kv_write.py:120 (write_kv_cache_pallas -> _kernel :60 "
            "on e4m3 bytes, :131-136,181)"
        ),
    )
)
KV_WRITE_INT8 = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="reshape_and_cache_int8",
        source="kv_write.cu",
        symbol="atoma_kv_write_int8",
        argtypes=[INT, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, LONG, PTR],
        replaces=(
            "atoma_infer_tpu/ops/kv_cache.py:165 (write_kv_cache_quant, XLA ops; "
            "no Pallas kernel)"
        ),
    )
)

# The same C entries counted apart for fp16 rows.
KV_WRITE_F16, KV_WRITE_FP8_F16, KV_WRITE_INT8_F16 = (
    cuda_lib.register(cuda_lib.CudaKernel(
        name=f"{k.name}_f16", source=k.source, symbol=k.symbol, argtypes=k.argtypes,
        replaces=k.replaces))
    for k in (KV_WRITE, KV_WRITE_FP8, KV_WRITE_INT8)
)


def _by_rows(kernel, rows: torch.Tensor):
    """``kernel``, or its fp16 counter for fp16 rows."""
    if rows.dtype != torch.float16:
        return kernel
    return {KV_WRITE: KV_WRITE_F16, KV_WRITE_FP8: KV_WRITE_FP8_F16,
            KV_WRITE_INT8: KV_WRITE_INT8_F16}[kernel]


def _keep(slot_mapping: torch.Tensor, num_slots: int):
    """(the slots in range, the mask of their rows): out-of-range slots are
    dropped (JAX ``mode="drop"``)."""
    slots = slot_mapping.long()
    keep = (slots >= 0) & (slots < num_slots)
    return slots[keep], keep


def write_kv_cache_plain(
    kv_cache: torch.Tensor,      # [num_pages, bs, 2·Hk·D], updated in place
    k_new: torch.Tensor,         # [T, Hk, D]
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,  # [T] int32, < 0 = padding
) -> None:
    """Plain PyTorch version: drop out-of-range slots, then one indexed
    store of the fused rows (converted to the cache's dtype)."""
    num_pages, bs, row = kv_cache.shape
    rows = kv_rows(k_new, v_new, kv_cache.dtype)
    slots, keep = _keep(slot_mapping, num_pages * bs)
    kv_cache.view(num_pages * bs, row)[slots] = rows[keep]


def write_kv_cache_quant_plain(
    kv_cache: torch.Tensor,      # [num_pages, bs, 2·Hk·D] int8, in place
    kv_scales: torch.Tensor,     # [num_pages, bs, 2] bf16, in place
    k_new: torch.Tensor,         # [T, Hk, D] float
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,
    scales_new: Optional[torch.Tensor] = None,  # [T, 2] f32, bf16-rounded
) -> None:
    """Plain version of the INT8 write (``write_kv_cache_quant``): the
    scales are ``scales_new`` when given, else the rows' own."""
    num_pages, bs, row = kv_cache.shape
    scale_t = kv_quant_scales(k_new, v_new) if scales_new is None else scales_new
    slots, keep = _keep(slot_mapping, num_pages * bs)
    kv_cache.view(num_pages * bs, row)[slots] = quantize_kv_rows(k_new, v_new, scale_t)[keep]
    kv_scales.view(num_pages * bs, 2)[slots] = scale_t[keep].to(kv_scales.dtype)


def check_scales_new(scales_new: Optional[torch.Tensor], T: int, what: str) -> None:
    """``scales_new``, where given, must be f32 [T, 2] (the kernels read it
    as such)."""
    if scales_new is not None and (scales_new.dtype != torch.float32
                                   or scales_new.shape != (T, 2)):
        raise ValueError(f"{what}: scales_new must be float32 [T, 2]")


def _check(kv_cache, k_new, v_new, slot_mapping, extra=()) -> None:
    """What every write kernel takes; raises otherwise."""
    num_pages, bs, row = kv_cache.shape
    T, hk, d = k_new.shape
    tensors = (kv_cache, k_new, v_new, slot_mapping) + tuple(extra)
    if not all(t.is_cuda and t.device == kv_cache.device for t in tensors):
        raise ValueError("reshape_and_cache: every tensor must be on the cache's CUDA device")
    if v_new.shape != k_new.shape or row != 2 * hk * d:
        raise ValueError(
            f"reshape_and_cache: k {tuple(k_new.shape)} / v {tuple(v_new.shape)} "
            f"do not fit cache rows of {row}"
        )
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("reshape_and_cache: slot_mapping must be int32 [T]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("reshape_and_cache: tensors must be contiguous")


def write_kv_cache_cuda(
    kv_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,
) -> None:
    """Launch ``reshape_and_cache`` (bf16/fp16/f32 cache) or
    ``reshape_and_cache_fp8`` (e4m3 cache) on the current stream, in place.
    An INT8 cache takes :func:`write_kv_cache_quant_cuda`."""
    _check(kv_cache, k_new, v_new, slot_mapping)
    num_pages, bs, _ = kv_cache.shape
    T, hk, d = k_new.shape
    dev = cuda_lib.launch_device(kv_cache, k_new, v_new, slot_mapping)
    stream = cuda_lib.current_stream_handle(dev)
    if kv_cache.dtype == torch.float8_e4m3fn:
        if k_new.dtype not in _DTYPES or v_new.dtype != k_new.dtype:
            raise ValueError("reshape_and_cache_fp8: k_new/v_new must be bfloat16, float16 or "
                             "float32")
        _by_rows(KV_WRITE_FP8, k_new)(
            _DTYPES[k_new.dtype], k_new.data_ptr(), v_new.data_ptr(),
            slot_mapping.data_ptr(), kv_cache.data_ptr(), T, hk, d, num_pages * bs, stream,
            device=dev,
        )
        return
    if kv_cache.dtype not in _DTYPES:
        raise ValueError(f"reshape_and_cache: unsupported cache dtype {kv_cache.dtype}")
    if k_new.dtype != kv_cache.dtype or v_new.dtype != kv_cache.dtype:
        raise ValueError("reshape_and_cache: k_new/v_new must have the cache's dtype")
    _by_rows(KV_WRITE, k_new)(
        k_new.data_ptr(), v_new.data_ptr(), slot_mapping.data_ptr(), kv_cache.data_ptr(),
        T, hk, d * kv_cache.element_size(), num_pages * bs, stream, device=dev,
    )


def write_kv_cache_quant_cuda(
    kv_cache: torch.Tensor,
    kv_scales: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,
    scales_new: Optional[torch.Tensor] = None,  # [T, 2] f32, bf16-rounded
) -> None:
    """Launch ``reshape_and_cache_int8`` on the current stream, in place;
    with ``scales_new`` the kernel stores those scales instead of taking
    the rows' absmax."""
    extra = (kv_scales,) if scales_new is None else (kv_scales, scales_new)
    _check(kv_cache, k_new, v_new, slot_mapping, extra=extra)
    num_pages, bs, _ = kv_cache.shape
    T, hk, d = k_new.shape
    check_scales_new(scales_new, T, "reshape_and_cache_int8")
    if kv_cache.dtype != torch.int8:
        raise ValueError(f"reshape_and_cache_int8: cache must be int8, not {kv_cache.dtype}")
    if kv_scales.dtype != torch.bfloat16 or kv_scales.shape != (num_pages, bs, 2):
        raise ValueError("reshape_and_cache_int8: kv_scales must be bfloat16 [pages, block_size, 2]")
    if k_new.dtype not in _DTYPES or v_new.dtype != k_new.dtype:
        raise ValueError("reshape_and_cache_int8: k_new/v_new must be bfloat16, float16 or "
                         "float32")
    dev = cuda_lib.launch_device(kv_cache, kv_scales, scales_new, k_new, v_new, slot_mapping)
    _by_rows(KV_WRITE_INT8, k_new)(
        _DTYPES[k_new.dtype], k_new.data_ptr(), v_new.data_ptr(), slot_mapping.data_ptr(),
        kv_cache.data_ptr(), kv_scales.data_ptr(),
        None if scales_new is None else scales_new.data_ptr(), T, hk, d, num_pages * bs,
        cuda_lib.current_stream_handle(dev), device=dev,
    )
