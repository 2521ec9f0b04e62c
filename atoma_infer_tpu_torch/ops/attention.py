"""Attention metadata contract + dispatch between the CUDA kernels and the
plain PyTorch path.

Counterpart of ``atoma_infer_tpu/ops/attention.py``. One metadata bundle
describes the ragged batch (block tables, sequence lengths, cumulative query
offsets, slot mapping), and one ragged paged-attention op covers prefill,
chunked prefill and decode: every query token attends causally to its
sequence's paged cache prefix.

Dispatch is by device, with no gates: a CPU tensor takes the plain version
(``reference.py``); a CUDA tensor takes the kernels of its cache's dtype
(bf16/f32, INT8 with ``kv_scales``, or e4m3) — the fused decode write+attend
kernel when ``meta.decode_only`` and the rank's group is at most
``MAX_FUSED_GROUP`` q heads per kv head (``ops/paged_attention.py``
``decode_route``), else the matching ``reshape_and_cache`` write followed by
the ragged kernel, as JAX serves a decode step its fused kernel does not
take. A kernel that cannot take its inputs raises; nothing falls back. The
TPU package's Mosaic alignment gates have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .kv_cache import write_kv_cache, write_kv_cache_quant


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
    kv_scales: Optional[torch.Tensor] = None,     # [num_pages, bs, 2] bf16 (int8 cache)
) -> torch.Tensor:
    """Unified prefill+decode attention over the paged cache → [T, Hq, D].
    The cache must already hold this step's K/V."""
    from .paged_attention import ragged_paged_attention_cuda, ragged_paged_attention_paged_plain

    attend = ragged_paged_attention_cuda if q.is_cuda else ragged_paged_attention_paged_plain
    return attend(
        q,
        kv_cache,
        meta,
        scale=scale,
        sliding_window=sliding_window,
        soft_cap=soft_cap,
        alibi_slopes=alibi_slopes,
        kv_scales=kv_scales,
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
    kv_scales: Optional[torch.Tensor] = None,     # [num_pages, bs, 2] bf16, in place
    scales_new: Optional[torch.Tensor] = None,    # [T, 2] f32 (int8 cache under TP)
) -> torch.Tensor:
    """One layer's attention block: write this step's K/V into the paged
    cache (in place; an INT8 cache quantizes them and stores their scales in
    ``kv_scales``), then attend over it (ref write-then-attend order:
    flash_attention.rs:360-361). Returns attn [T, Hq, D].

    ``scales_new``: the new tokens' INT8 scales, where they are not those of
    ``k_new``/``v_new`` alone — under tensor parallelism a rank holds only
    its kv heads, and the scales are taken over every rank's (JAX
    ``ops/attention.py:377-400``). None: the rows' own.

    On CUDA a pure-decode step runs ONE fused kernel that writes and
    attends, up to ``MAX_FUSED_GROUP`` q heads per kv head of this rank's
    ``q`` and ``k_new`` (``decode_route``); every other step, and a decode
    step of a wider group, runs the write kernel, then the ragged kernel.
    """
    from .paged_attention import decode_route

    if q.is_cuda and meta.decode_only and decode_route(q.shape[1], k_new.shape[1]) == "fused":
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
            kv_scales=kv_scales,
            scales_new=scales_new,
        )
    if kv_scales is not None:
        write_kv_cache_quant(kv_cache, kv_scales, k_new, v_new, meta.slot_mapping,
                             scales_new=scales_new)
    else:
        write_kv_cache(kv_cache, k_new, v_new, meta.slot_mapping)
    return ragged_paged_attention(
        q,
        kv_cache,
        meta,
        scale=scale,
        sliding_window=sliding_window,
        soft_cap=soft_cap,
        alibi_slopes=alibi_slopes,
        kv_scales=kv_scales,
    )
