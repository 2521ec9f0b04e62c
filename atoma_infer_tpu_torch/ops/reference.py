"""Plain PyTorch ragged paged attention — the plain version of the attention
kernels and the port's numerics oracle.

Counterpart of ``atoma_infer_tpu/ops/reference.py:ragged_paged_attention_xla``
with the same masked formulation: the token axis packs sequences back to back
(prefill chunks first, then decode tokens), delimited by ``query_start_loc``,
and every query token attends causally to its sequence's cache prefix, read
through ``block_tables``. New K/V must already be in the cache. It gathers
each token's whole context (O(T · pages · block_size) memory), so it is the
CPU path and the yardstick for the CUDA kernels, not the production path.

``ragged_paged_attention_plain_partial`` is the counterpart of
``ragged_paged_attention_xla_partial``: the flash accumulators over the
pages one context-parallel rank owns (``parallel/context_parallel.py``).
JAX computes it in XLA, not in a Pallas kernel, so this plain version is
its counterpart on the card too.
"""

from __future__ import annotations

from typing import Optional

import torch


def ragged_paged_attention_plain(
    q: torch.Tensor,             # [T, num_q_heads, head_dim]
    k_cache: torch.Tensor,       # [num_slots, num_kv_heads, head_dim]
    v_cache: torch.Tensor,       # [num_slots, num_kv_heads, head_dim]
    block_tables: torch.Tensor,  # [S, max_pages] int (garbage ok beyond len)
    seq_lens: torch.Tensor,      # [S] int — kv length incl. this step's tokens
    query_start_loc: torch.Tensor,  # [S+1] int cumulative query lengths
    *,
    scale: float,
    block_size: int,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # [Hq] f32 per-q-head slopes
    k_scale: Optional[torch.Tensor] = None,  # [num_slots] per-slot dequant scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked paged attention over the whole ragged batch → [T, Hq, D].
    An INT8 cache comes with ``k_scale``/``v_scale`` and is dequantized to
    f32 before the dots; an e4m3 cache is widened to f32."""
    num_tokens, num_q_heads, head_dim = q.shape
    num_seqs = seq_lens.shape[0]
    max_pages = block_tables.shape[1]
    num_slots, num_kv_heads, _ = k_cache.shape
    group = num_q_heads // num_kv_heads
    ctx = max_pages * block_size
    dev = q.device

    qsl = query_start_loc.long()
    lens = seq_lens.long()
    token_ids = torch.arange(num_tokens, device=dev)
    # Which sequence owns each token: q_start[s] <= i < q_start[s+1].
    token_seq = torch.searchsorted(qsl, token_ids, right=True) - 1
    token_seq = token_seq.clamp(0, num_seqs - 1)
    q_lens = qsl[1:] - qsl[:-1]
    q_offset = token_ids - qsl[token_seq]
    # Absolute position of each query token within its sequence.
    abs_pos = lens[token_seq] - q_lens[token_seq] + q_offset

    offsets = torch.arange(block_size, device=dev)
    seq_rows = (
        block_tables.long()[:, :, None] * block_size + offsets[None, None, :]
    ).reshape(num_seqs, ctx)
    # Rows past a sequence's length may hold garbage page ids; clamp them in
    # range (as a JAX gather does) — they are masked below.
    tok_rows = seq_rows[token_seq].clamp(0, num_slots - 1)   # [T, ctx]
    k = k_cache[tok_rows].float()                            # [T, ctx, Hk, D]
    v = v_cache[tok_rows].float()
    if k_scale is not None:
        k = k * k_scale[tok_rows][..., None, None]
    if v_scale is not None:
        v = v * v_scale[tok_rows][..., None, None]

    qf = q.float().reshape(num_tokens, num_kv_heads, group, head_dim)
    scores = torch.einsum("tkgd,tjkd->tkgj", qf, k) * scale  # [T, Hk, G, ctx]

    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)

    kv_pos = torch.arange(ctx, device=dev)
    if alibi_slopes is not None:
        # ALiBi: score += slope_h · (kv_pos − q_pos); ≤ 0 under the causal mask.
        dist = (kv_pos[None, :] - abs_pos[:, None]).float()
        sl = alibi_slopes.float().reshape(num_kv_heads, group)
        scores = scores + sl[None, :, :, None] * dist[:, None, None, :]
    causal = kv_pos[None, :] <= abs_pos[:, None]             # [T, ctx]
    valid = kv_pos[None, :] < lens[token_seq][:, None]
    mask = causal & valid
    if sliding_window is not None:
        mask &= kv_pos[None, :] > abs_pos[:, None] - sliding_window
    scores = torch.where(mask[:, None, None, :], scores, -1e30)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgj,tjkd->tkgd", probs, v)
    return out.reshape(num_tokens, num_q_heads, head_dim).to(q.dtype)


def ragged_paged_attention_plain_partial(
    q: torch.Tensor,             # [T, num_q_heads, head_dim]
    k_cache: torch.Tensor,       # [num_slots, num_kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages] int (LOCAL page ids)
    seq_lens: torch.Tensor,      # [S] int
    query_start_loc: torch.Tensor,  # [S+1] int
    *,
    scale: float,
    block_size: int,
    page_valid: Optional[torch.Tensor] = None,  # [S, max_pages] bool: pages owned here
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> tuple:
    """PARTIAL paged attention over the pages ``page_valid`` marks →
    ``(num [T, Hq, D] f32, m [T, Hq] f32, l [T, Hq] f32)``: ``num = Σ
    exp(score − m)·v``, ``m`` the local score max, ``l`` the local exp-sum,
    combinable across ranks by the log-sum-exp rule (JAX
    ``ragged_paged_attention_xla_partial``). A token none of whose pages
    are owned here gets ``m = −1e30`` and exact zeros in ``num`` and ``l``,
    so the combine weighs it out."""
    num_tokens, num_q_heads, head_dim = q.shape
    num_seqs = seq_lens.shape[0]
    max_pages = block_tables.shape[1]
    num_slots, num_kv_heads, _ = k_cache.shape
    group = num_q_heads // num_kv_heads
    ctx = max_pages * block_size
    dev = q.device

    qsl = query_start_loc.long()
    lens = seq_lens.long()
    token_ids = torch.arange(num_tokens, device=dev)
    token_seq = (torch.searchsorted(qsl, token_ids, right=True) - 1).clamp(0, num_seqs - 1)
    q_lens = qsl[1:] - qsl[:-1]
    abs_pos = lens[token_seq] - q_lens[token_seq] + token_ids - qsl[token_seq]

    offsets = torch.arange(block_size, device=dev)
    seq_rows = (block_tables.long()[:, :, None] * block_size
                + offsets[None, None, :]).reshape(num_seqs, ctx)
    tok_rows = seq_rows[token_seq].clamp(0, num_slots - 1)   # [T, ctx]
    k = k_cache[tok_rows].float()
    v = v_cache[tok_rows].float()
    if k_scale is not None:
        k = k * k_scale[tok_rows][..., None, None]
    if v_scale is not None:
        v = v * v_scale[tok_rows][..., None, None]

    qf = q.float().reshape(num_tokens, num_kv_heads, group, head_dim)
    scores = torch.einsum("tkgd,tjkd->tkgj", qf, k) * scale
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    kv_pos = torch.arange(ctx, device=dev)
    if alibi_slopes is not None:
        dist = (kv_pos[None, :] - abs_pos[:, None]).float()
        sl = alibi_slopes.float().reshape(num_kv_heads, group)
        scores = scores + sl[None, :, :, None] * dist[:, None, None, :]
    mask = (kv_pos[None, :] <= abs_pos[:, None]) & (kv_pos[None, :] < lens[token_seq][:, None])
    if sliding_window is not None:
        mask &= kv_pos[None, :] > abs_pos[:, None] - sliding_window
    if page_valid is not None:
        mask &= page_valid[token_seq].repeat_interleave(block_size, dim=1)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)

    m = scores.amax(dim=-1)                                  # [T, Hk, G]
    # Fully masked rows: m = −1e30 makes every prob exp(0) = 1; zero them so
    # that num and l are exact zeros and the combine ignores them.
    probs = torch.exp(scores - m[..., None]) * (m > -1e29)[..., None]
    l = probs.sum(dim=-1)
    num = torch.einsum("tkgj,tjkd->tkgd", probs, v)
    return (num.reshape(num_tokens, num_q_heads, head_dim),
            m.reshape(num_tokens, num_q_heads), l.reshape(num_tokens, num_q_heads))
