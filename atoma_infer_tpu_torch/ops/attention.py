"""Attention metadata contract + dispatch between the CUDA kernels and the
plain PyTorch path.

Counterpart of ``atoma_infer_tpu/ops/attention.py``. One metadata bundle
describes the ragged batch (block tables, sequence lengths, cumulative query
offsets, slot mapping), and one ragged paged-attention op covers prefill,
chunked prefill and decode: every query token attends causally to its
sequence's paged cache prefix.

Dispatch is by device, with no gates: a CPU tensor takes the plain version
(``reference.py``); a CUDA tensor takes the kernels — the fused decode
write+attend kernel when ``meta.decode_only``, else the ``reshape_and_cache``
write followed by the ragged kernel. A kernel that cannot take its inputs
raises; nothing falls back. The TPU package's Mosaic alignment gates have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .kv_cache import kv_cache_view, write_kv_cache
from .reference import ragged_paged_attention_plain


@dataclasses.dataclass(frozen=True)
class AttentionMetadata:
    """Ragged-batch descriptor (ref: flash_attention.rs:11-146).

    Tensors live on the model's device (S = padded seq slots, T = padded
    token count, P = padded pages):
      slot_mapping    [T] int32 — destination KV slot per new token, -1 pad
      block_tables    [S, P] int32 — physical pages per sequence
      seq_lens        [S] int32 — kv length incl. this step's tokens; 0 pad
      query_start_loc [S+1] int32 — cumulative query lengths
      num_seqs        [1] int32 — actual sequence count (≤ S), read on device
    Host values:
      block_size      KV page size in tokens
      decode_only     every active sequence has exactly one query token
      max_q_len       longest query chunk this step (sizes the kernel grid;
                      known in input prep, so no device read is needed)
    """

    slot_mapping: torch.Tensor
    block_tables: torch.Tensor
    seq_lens: torch.Tensor
    query_start_loc: torch.Tensor
    num_seqs: torch.Tensor
    block_size: int = 16
    decode_only: bool = False
    max_q_len: int = 1


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Standard ALiBi slope schedule (Press et al.) → [num_heads] f32."""

    def pow2(n: int) -> list:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(num_heads).is_integer():
        vals = pow2(num_heads)
    else:
        m = 2 ** int(math.floor(math.log2(num_heads)))
        vals = pow2(m) + pow2(2 * m)[0::2][: num_heads - m]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def ragged_paged_attention(
    q: torch.Tensor,         # [T, num_q_heads, head_dim]
    kv_cache: torch.Tensor,  # [num_pages, block_size, 2·Hk·D] (page-major)
    meta: AttentionMetadata,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # [Hq] f32
) -> torch.Tensor:
    """Unified prefill+decode attention over the paged cache → [T, Hq, D].
    The cache must already hold this step's K/V."""
    if q.is_cuda:
        from .paged_attention import ragged_paged_attention_cuda

        return ragged_paged_attention_cuda(
            q,
            kv_cache,
            meta,
            scale=scale,
            sliding_window=sliding_window,
            soft_cap=soft_cap,
            alibi_slopes=alibi_slopes,
        )
    D = q.shape[2]
    k_view, v_view = kv_cache_view(kv_cache, kv_cache.shape[2] // (2 * D), D)
    return ragged_paged_attention_plain(
        q,
        k_view,
        v_view,
        meta.block_tables,
        meta.seq_lens,
        meta.query_start_loc,
        scale=scale,
        block_size=meta.block_size,
        sliding_window=sliding_window,
        soft_cap=soft_cap,
        alibi_slopes=alibi_slopes,
    )


def paged_attention_layer(
    q: torch.Tensor,         # [T, Hq, D] (rope already applied)
    kv_cache: torch.Tensor,  # [num_pages, block_size, 2·Hk·D], updated in place
    k_new: torch.Tensor,     # [T, Hk, D] (rope already applied)
    v_new: torch.Tensor,
    meta: AttentionMetadata,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # [Hq] f32
) -> torch.Tensor:
    """One layer's attention block: write this step's K/V into the paged
    cache (in place), then attend over it (ref write-then-attend order:
    flash_attention.rs:360-361). Returns attn [T, Hq, D].

    On CUDA a pure-decode step runs ONE fused kernel that writes and
    attends; every other step runs the write kernel, then the ragged kernel.
    """
    if q.is_cuda and meta.decode_only:
        from .paged_attention import ragged_paged_attention_fused_cuda

        return ragged_paged_attention_fused_cuda(
            q,
            kv_cache,
            k_new,
            v_new,
            meta,
            scale=scale,
            sliding_window=sliding_window,
            soft_cap=soft_cap,
            alibi_slopes=alibi_slopes,
        )
    write_kv_cache(kv_cache, k_new, v_new, meta.slot_mapping)
    return ragged_paged_attention(
        q,
        kv_cache,
        meta,
        scale=scale,
        sliding_window=sliding_window,
        soft_cap=soft_cap,
        alibi_slopes=alibi_slopes,
    )
