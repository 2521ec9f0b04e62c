"""Paged KV-cache storage ops: scatter-write, block copy, host swap.

PyTorch counterpart of ``atoma_infer_tpu/ops/kv_cache.py`` (bf16/f32 caches;
the INT8 scale pages and FP8 clipping arrive with the KV-dtype ROADMAP item).

Cache layout (page-major, K/V fused), kept from the JAX package so cache
state compares tensor for tensor: ``[num_pages, block_size, 2·Hk·D]`` per
layer, each token's row head-interleaved ``[K_h0 | V_h0 | K_h1 | V_h1 | …]``.
A flat slot index ``page·block_size + offset`` addresses one row, so a
contiguous cache viewed as ``[num_pages·block_size, 2·Hk·D]`` is indexed by
slot directly.

JAX updates are functional (``.at[].set``); here every write lands IN PLACE
in the preallocated cache tensor, and the functions return nothing.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Padding value in slot mappings and copy pairs (ref: worker.rs:13
# ``PAD_SLOT_ID=-1``); such rows are dropped by every write.
PAD_SLOT_ID = -1


def kv_rows(k_new: torch.Tensor, v_new: torch.Tensor, dtype) -> torch.Tensor:
    """[T, Hk, D] K and V → fused rows [T, 2·Hk·D], head-interleaved
    (``[K_h0 | V_h0 | K_h1 | V_h1 | …]``)."""
    T, hk, d = k_new.shape
    return torch.stack([k_new, v_new], dim=2).reshape(T, 2 * hk * d).to(dtype)


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
    """Scatter this step's K/V rows into their slots, in place. A CUDA cache
    takes the ``reshape_and_cache`` kernel (ops/kv_write.py); a CPU cache
    takes its plain version."""
    from .kv_write import write_kv_cache_cuda, write_kv_cache_plain

    if kv_cache.is_cuda:
        write_kv_cache_cuda(kv_cache, k_new, v_new, slot_mapping)
    else:
        write_kv_cache_plain(kv_cache, k_new, v_new, slot_mapping)


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
