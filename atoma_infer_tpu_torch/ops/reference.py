"""Plain PyTorch ragged paged attention — the plain version of the attention
kernels and the port's numerics oracle.

Counterpart of ``atoma_infer_tpu/ops/reference.py:ragged_paged_attention_xla``
with the same masked formulation: the token axis packs sequences back to back
(prefill chunks first, then decode tokens), delimited by ``query_start_loc``,
and every query token attends causally to its sequence's cache prefix, read
through ``block_tables``. New K/V must already be in the cache. It gathers
each token's whole context (O(T · pages · block_size) memory), so it is the
CPU path and the yardstick for the CUDA kernels, not the production path.
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
) -> torch.Tensor:
    """Masked paged attention over the whole ragged batch → [T, Hq, D]."""
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
