"""Paged KV-cache storage ops: scatter-write, block copy, host swap.

PyTorch counterpart of ``atoma_infer_tpu/ops/kv_cache.py``: caches in the
model's dtype, INT8 caches with per-(slot, K/V) scales, and e4m3 caches.

Cache layout (page-major, K/V fused), kept from the JAX package so cache
state compares tensor for tensor: ``[num_pages, block_size, 2·Hk·D]`` per
layer, each token's row head-interleaved ``[K_h0 | V_h0 | K_h1 | V_h1 | …]``.
A flat slot index ``page·block_size + offset`` addresses one row, so a
contiguous cache viewed as ``[num_pages·block_size, 2·Hk·D]`` is indexed by
slot directly.

INT8 scales: one ``[num_pages, block_size, 2]`` bf16 tensor per layer, the
K scale at index 0 and the V scale at 1 (the JAX package pads each slot's
pair to a 128-lane page for Mosaic's DMAs; only the two values are kept
here, and they equal ``jax_scales[..., :2]``).

JAX updates are functional (``.at[].set``); here every write lands IN PLACE
in the preallocated cache tensor, and the functions return nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .quant import true_divide

# Padding value in slot mappings and copy pairs (ref: worker.rs:13
# ``PAD_SLOT_ID=-1``); such rows are dropped by every write.
PAD_SLOT_ID = -1

# INT8-KV scales: bf16, the precision quantization itself uses, so every
# dequantizing path sees the identical scale.
SCALE_DTYPE = torch.bfloat16
# The largest finite e4m3 value; FP8 rows are clipped to it.
FP8_MAX = 448.0


def alloc_kv_scales(num_pages: int, block_size: int, device=None) -> torch.Tensor:
    """Zeroed scales of one INT8 cache layer: [num_pages, block_size, 2]."""
    return torch.zeros((num_pages, block_size, 2), dtype=SCALE_DTYPE, device=device)


def scales_flat(kv_scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scales → (k_scale [slots], v_scale [slots]) in f32, for the plain
    attention path."""
    flat = kv_scales.reshape(-1, 2).float()
    return flat[:, 0], flat[:, 1]


def kv_rows(k_new: torch.Tensor, v_new: torch.Tensor, dtype) -> torch.Tensor:
    """[T, Hk, D] K and V → fused rows [T, 2·Hk·D], head-interleaved
    (``[K_h0 | V_h0 | K_h1 | V_h1 | …]``). FP8 (e4m3fn) rows are clipped to
    ±448 in f32 first: a conversion past it gives NaN bytes."""
    T, hk, d = k_new.shape
    stacked = torch.stack([k_new, v_new], dim=2)
    if dtype == torch.float8_e4m3fn:
        stacked = stacked.float().clamp(-FP8_MAX, FP8_MAX)
    return stacked.reshape(T, 2 * hk * d).to(dtype)


def kv_absmax(k_new: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
    """Per-(token, K/V) absmax over the given kv heads → [T, 2] f32. Under
    tensor parallelism a rank holds only its own heads: the model takes the
    max of every rank's (``TpGroup.all_reduce_max``), which is exact in any
    order, and hands :func:`kv_scales_from_absmax` of it to the write as
    ``scales_new`` (JAX ``ops/attention.py:377-380``)."""
    return torch.stack([k_new, v_new], dim=2).float().abs().amax(dim=(1, 3))


def kv_scales_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """[T, 2] absmax → INT8 scales [T, 2] f32, rounded through bf16 (the
    stored precision) so that quantization and every dequantization use the
    identical scale."""
    s = torch.clamp_min(true_divide(absmax, 127.0), 1e-8)
    return s.to(SCALE_DTYPE).float()


def kv_quant_scales(k_new: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
    """Per-(token, K/V) symmetric absmax INT8 scales over ALL kv heads →
    [T, 2] f32 (:func:`kv_absmax`, then :func:`kv_scales_from_absmax`)."""
    return kv_scales_from_absmax(kv_absmax(k_new, v_new))


def quantize_kv_rows(
    k_new: torch.Tensor,    # [T, Hk, D] float
    v_new: torch.Tensor,
    scale_t: torch.Tensor,  # [T, 2] f32 per-(token, K/V) scales
) -> torch.Tensor:
    """Fused int8 rows [T, 2·Hk·D]: ``clip(round(x · (1/s)), ±127)``, round
    half to even. The reciprocal multiply is the contract of every write
    path (``x / s`` differs from it in the last bit, which flips a rounding
    at .5); the reciprocal is a division of two tensors, correctly rounded
    on every device."""
    rows_f = kv_rows(k_new, v_new, torch.float32)
    D = k_new.shape[2]
    lane = torch.arange(rows_f.shape[1], device=rows_f.device)
    is_k = (lane // D) % 2 == 0                       # [K_h | V_h]
    inv = torch.ones_like(scale_t) / scale_t          # [T, 2]
    inv_row = torch.where(is_k[None, :], inv[:, 0:1], inv[:, 1:2])
    return torch.clamp(torch.round(rows_f * inv_row), -127, 127).to(torch.int8)


def kv_cache_view(
    kv_cache: torch.Tensor, num_kv_heads: int, head_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page-major cache → (k [slots, Hk, D], v [slots, Hk, D]) strided views
    for the plain attention path (no copy)."""
    num_pages, bs, _ = kv_cache.shape
    flat = kv_cache.view(num_pages * bs, num_kv_heads, 2, head_dim)
    return flat[:, :, 0], flat[:, :, 1]


def write_kv_cache(
    kv_cache: torch.Tensor,     # [num_pages, block_size, 2·Hk·D], updated in place
    k_new: torch.Tensor,        # [T, Hk, D]
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,  # [T] int32, PAD_SLOT_ID for padding
) -> None:
    """Scatter this step's K/V rows into their slots, in place (an e4m3
    cache clips to ±448). A CUDA cache takes the ``reshape_and_cache``
    kernel of its dtype (ops/kv_write.py); a CPU cache takes its plain
    version."""
    from .kv_write import write_kv_cache_cuda, write_kv_cache_plain

    if kv_cache.is_cuda:
        write_kv_cache_cuda(kv_cache, k_new, v_new, slot_mapping)
    else:
        write_kv_cache_plain(kv_cache, k_new, v_new, slot_mapping)


def write_kv_cache_quant(
    kv_cache: torch.Tensor,      # [num_pages, block_size, 2·Hk·D] int8, in place
    kv_scales: torch.Tensor,     # [num_pages, block_size, 2] bf16, in place
    k_new: torch.Tensor,         # [T, Hk, D] float
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,  # [T] int32, PAD_SLOT_ID for padding
    scales_new: Optional[torch.Tensor] = None,  # [T, 2] f32, bf16-rounded
) -> None:
    """INT8 KV write: each token's rows quantized with its K and V scales,
    rows and scales stored in their slots, in place. The scales are
    ``scales_new`` when given (under tensor parallelism: taken over every
    rank's heads), else those of ``k_new``/``v_new`` themselves. A CUDA
    cache takes the ``reshape_and_cache_int8`` kernel; a CPU cache its plain
    version."""
    from .kv_write import write_kv_cache_quant_cuda, write_kv_cache_quant_plain

    write = write_kv_cache_quant_cuda if kv_cache.is_cuda else write_kv_cache_quant_plain
    write(kv_cache, kv_scales, k_new, v_new, slot_mapping, scales_new=scales_new)


def copy_blocks_layer(cache: torch.Tensor, copy_pairs: Sequence) -> None:
    """Single-layer copy-on-write page duplication ``cache[dst] = cache[src]``
    for (src, dst) pairs, in place; pairs with dst < 0 are padding."""
    pairs = [(s, d) for s, d in copy_pairs if d >= 0]
    if not pairs:
        return
    src = torch.tensor([s for s, _ in pairs], dtype=torch.long, device=cache.device)
    dst = torch.tensor([d for _, d in pairs], dtype=torch.long, device=cache.device)
    cache[dst] = cache[src]


def gather_blocks_layer(cache: torch.Tensor, block_ids) -> torch.Tensor:
    """Whole pages ``cache[block_ids]`` (a copy: host-swap-out read side)."""
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=cache.device)
    return cache[ids]


def scatter_blocks_layer(cache: torch.Tensor, block_ids, data: torch.Tensor) -> None:
    """Write whole pages into the cache in place (host-swap-in write side)."""
    ids = torch.as_tensor(block_ids, dtype=torch.long, device=cache.device)
    cache[ids] = data.to(device=cache.device, dtype=cache.dtype)
