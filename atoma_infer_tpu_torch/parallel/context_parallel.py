"""Context-parallel (split-KV) decode attention with the log-sum-exp combine.

Counterpart of ``atoma_infer_tpu/parallel/context_parallel.py``. The paged
KV cache is split over the ranks by page: rank ``s`` of ``n`` holds the
contiguous page range ``[s·P/n, (s+1)·P/n)`` of a ``P``-page cache as its
own ``[P/n, bs, 2·Hk·D]`` tensor. Each rank writes the new K/V rows whose
page it owns, attends over its own pages only (the flash accumulators
``(num, m, l)`` of ``ops/reference.py``
``ragged_paged_attention_plain_partial``), and the ranks combine them by
the log-sum-exp rule over their ``TpGroup`` (a max, then a sum). q, the new
rows and the metadata are the same on every rank; block tables carry
GLOBAL page ids, which each rank maps to its own and masks to the pages it
owns; every rank ends with the whole combined output. Decode latency for
one long sequence then shrinks with the ranks, and no kv head is copied
when the ranks outnumber the kv heads.

As in JAX no service path calls it yet. Feeding the combine from kernel A's
split partials (``ws_o``/``ws_ml``) would need a page-owner mask in A
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import AttentionMetadata
from ..ops.kv_cache import kv_cache_view, write_kv_cache
from ..ops.reference import ragged_paged_attention_plain_partial


def combine_partials(num: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     group) -> torch.Tensor:
    """The ranks' flash accumulators combined: ``Σ_s exp(m_s − m*)·num_s /
    Σ_s exp(m_s − m*)·l_s`` with ``m* = max_s m_s`` → [T, Hq, D] f32. A rank
    that owns none of a row's pages weighs 0 (``m_s = −1e30``). ``group``
    None: one rank."""
    m_g = m.clone() if group is None else group.all_reduce_max(m.clone())
    c = torch.exp(m - m_g)
    num_g = num * c[..., None]
    l_g = l * c
    if group is not None:
        num_g = group.all_reduce_sum(num_g.contiguous())
        l_g = group.all_reduce_sum(l_g.contiguous())
    return num_g / l_g.clamp_min(1e-30)[..., None]


def cp_decode_attention_layer(
    q: torch.Tensor,         # [T, Hq, D] (rope applied) — the same on every rank
    kv_cache: torch.Tensor,  # [P/n, bs, 2·Hk·D] — this rank's pages, updated in place
    k_new: torch.Tensor,     # [T, Hk, D]
    v_new: torch.Tensor,
    meta: AttentionMetadata,  # GLOBAL slots and page ids
    group,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One layer's write and attention with the pages split over the
    ranks of ``group`` (JAX ``cp_decode_attention_layer``) → [T, Hq, D] in
    q's dtype, the same on every rank. This rank writes only the slots of
    its pages (the others padded to −1: the port's ``write_kv_cache``,
    kernel C on the card), attends over its pages and combines."""
    rank = 0 if group is None else group.rank
    pages_local = kv_cache.shape[0]
    bs = meta.block_size
    D = q.shape[2]
    Hk = kv_cache.shape[2] // (2 * D)
    lo = rank * pages_local

    slot = meta.slot_mapping
    page = torch.div(slot, bs, rounding_mode="floor")
    owned = (slot >= 0) & (page >= lo) & (page < lo + pages_local)
    local_slot = torch.where(owned, slot - lo * bs, torch.full_like(slot, -1))
    write_kv_cache(kv_cache, k_new, v_new, local_slot)

    bt = meta.block_tables
    mine = (bt >= lo) & (bt < lo + pages_local)
    local_bt = torch.where(mine, bt - lo, torch.zeros_like(bt))
    k_view, v_view = kv_cache_view(kv_cache, Hk, D)
    num, m, l = ragged_paged_attention_plain_partial(
        q, k_view, v_view, local_bt, meta.seq_lens, meta.query_start_loc, scale=scale,
        block_size=bs, page_valid=mine, sliding_window=sliding_window, soft_cap=soft_cap,
        alibi_slopes=alibi_slopes)
    return combine_partials(num, m, l, group).to(q.dtype)
