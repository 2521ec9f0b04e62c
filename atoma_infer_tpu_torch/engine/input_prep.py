"""Scheduler output → padded device arrays (the worker's input prep).

The PyTorch port's copy of ``atoma_infer_tpu/engine/input_prep.py``, the
analog of the reference's ``prepare_input_tensors``
(ref: backends/vllm/src/worker.rs:224-460): flattens the batch in
prefill-then-decode order, computes per-token slot mappings
(``block_number·block_size + offset``, pad −1, worker.rs:373-401), padded
block tables, and cumulative ``query_start_loc`` (worker.rs:405-450), plus the
last-token row indices for sampling (``compute_selected_token_indices``,
worker.rs:688-698).

Every array is padded to the JAX package's **bucket shapes** (powers of two
for the token axis, the sequence axis and the block-table width), so a step
here compares one to one with a JAX worker step. The port adds
``max_q_len``: the longest query chunk, which sizes the attention kernel's
grid without a device read. Speculative-decoding verify rows are not ported
yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..ops.kv_cache import PAD_SLOT_ID
from ..sequence import SequenceGroupMetadata


def bucket(
    n: int,
    minimum: int = 8,
    maximum: Optional[int] = None,
    dense: bool = False,
) -> int:
    """Round up to the next power of two (≥ minimum), capped at maximum.

    ``dense`` adds 3·2^k rungs (…, 96, 192, 384, …) between the powers of
    two. Used for the PURE-DECODE sequence bucket only, where power-of-two
    padding would spend up to a third of a large batch's work on dead rows;
    mixed prefill+decode steps keep the sparse ladder. The ladder is the
    JAX package's, so the port's steps have the same shapes."""
    b = minimum
    while b < n:
        b *= 2
    if dense and b > minimum:
        alt = 3 * b // 4
        if alt >= n and alt % 8 == 0:
            b = alt
    if maximum is not None:
        b = min(b, max(maximum, minimum))
    return b


@dataclasses.dataclass
class ModelInput:
    """Host-side batch arrays, ready for one copy to the device (ref:
    worker.rs ``ModelInput``). All shapes are bucketed."""

    token_ids: np.ndarray        # [T] int32
    positions: np.ndarray        # [T] int32
    slot_mapping: np.ndarray     # [T] int32 (PAD_SLOT_ID padding)
    block_tables: np.ndarray     # [S, P] int32
    seq_lens: np.ndarray         # [S] int32 (0 beyond num_seqs)
    query_start_loc: np.ndarray  # [S+1] int32
    num_seqs: np.ndarray         # [] int32
    # Sampling side:
    selected_token_indices: np.ndarray  # [S] int32 — last-token row per seq
    sample_mask: np.ndarray      # [S] bool — do_sample per scheduled seq
    num_prefills: int
    max_q_len: int               # longest query chunk (host value)

    @property
    def decode_only(self) -> bool:
        """Pure decode step: one query token per sequence (fused kernel)."""
        return self.num_prefills == 0


def _prepare_decode_fast(
    metadata_list: List[SequenceGroupMetadata],
    *,
    block_size: int,
    max_pages_per_seq: int,
    sliding_window: Optional[int] = None,
) -> Optional[ModelInput]:
    """Vectorized pure-decode batch build (one token per sequence, no
    drafts), sparing every decode step the general path's per-token Python
    loops. Numpy-vectorizes the slot arithmetic and paddings; returns None
    (the general path) for anything else."""
    if sliding_window is not None:
        # Sliding-window slot mapping indexes tables modulo their per-seq
        # length; the general path handles it.
        return None
    datas = []
    tables_list = []
    for meta in metadata_list:
        if meta.is_prompt:
            return None
        for seq_id, seq_data in meta.seq_data.items():
            datas.append(seq_data)
            tables_list.append(meta.block_tables[seq_id])

    num_seqs = len(datas)
    if num_seqs == 0:
        return None
    S = bucket(num_seqs, minimum=8, dense=True)
    T = S  # one token per sequence

    tok = np.zeros(T, dtype=np.int32)
    pos = np.zeros(T, dtype=np.int32)
    sl = np.zeros(S, dtype=np.int32)
    for i, d in enumerate(datas):
        tok[i] = d.get_last_token_id()
        # Decode contract: everything but the newest token is computed
        # (kv_len = computed + 1; prompt-recompute rows arrive as prompt
        # metas and are excluded above).
        sl[i] = d.get_num_computed_tokens() + 1
    pos[:num_seqs] = sl[:num_seqs] - 1

    max_pages = max((len(t) for t in tables_list), default=1)
    P = bucket(max(max_pages, 1), minimum=8, maximum=max_pages_per_seq)
    tables = np.zeros((S, P), dtype=np.int32)
    for i, t in enumerate(tables_list):
        tables[i, : min(len(t), P)] = t[:P]

    idx = np.arange(num_seqs)
    page = tables[idx, pos[:num_seqs] // block_size]
    slots = np.full(T, PAD_SLOT_ID, dtype=np.int32)
    slots[:num_seqs] = page * block_size + pos[:num_seqs] % block_size

    qsl = np.zeros(S + 1, dtype=np.int32)
    qsl[1 : num_seqs + 1] = np.arange(1, num_seqs + 1)
    qsl[num_seqs + 1 :] = num_seqs
    sel = np.zeros(S, dtype=np.int32)
    sel[:num_seqs] = np.arange(num_seqs)
    smask = np.zeros(S, dtype=bool)
    smask[:num_seqs] = True
    return ModelInput(
        token_ids=tok,
        positions=pos,
        slot_mapping=slots,
        block_tables=tables,
        seq_lens=sl,
        query_start_loc=qsl,
        num_seqs=np.asarray(num_seqs, dtype=np.int32),
        selected_token_indices=sel,
        sample_mask=smask,
        num_prefills=0,
        max_q_len=1,
    )


def prepare_model_input(
    metadata_list: List[SequenceGroupMetadata],
    *,
    block_size: int,
    max_pages_per_seq: int,
    sliding_window: Optional[int] = None,
) -> ModelInput:
    """Flatten one step's scheduled groups into bucketed batch arrays.

    Layout contract: prefill chunks first, then decode tokens, sequences
    back-to-back (ref: flash_attention.rs:156-174 + scheduler ordering).
    """
    fast = _prepare_decode_fast(
        metadata_list,
        block_size=block_size,
        max_pages_per_seq=max_pages_per_seq,
        sliding_window=sliding_window,
    )
    if fast is not None:
        return fast

    token_ids: List[int] = []
    positions: List[int] = []
    slot_mapping: List[int] = []
    per_seq_tables: List[List[int]] = []
    seq_lens: List[int] = []
    q_lens: List[int] = []
    sample_mask: List[bool] = []
    num_prefills = 0

    for meta in metadata_list:
        if meta.is_prompt:
            num_prefills += 1
        for seq_id, seq_data in meta.seq_data.items():
            table = meta.block_tables[seq_id]
            computed = seq_data.get_num_computed_tokens()
            if meta.is_prompt:
                chunk = meta.token_chunk_size
            else:
                chunk = 1
            all_tokens = seq_data.get_token_ids()
            new_tokens = all_tokens[computed : computed + chunk]
            kv_len = computed + len(new_tokens)

            token_ids.extend(new_tokens)
            positions.extend(range(computed, kv_len))
            # Sliding-window slot reuse happens at the block-manager level
            # (blocks modulo window); the mapping here is linear in the
            # table (ref: worker.rs:373-401).
            for pos in range(computed, kv_len):
                page = table[(pos // block_size) % max(len(table), 1)]
                slot_mapping.append(page * block_size + pos % block_size)

            per_seq_tables.append(list(table))
            seq_lens.append(kv_len)
            q_lens.append(len(new_tokens))
            sample_mask.append(meta.do_sample)

    num_tokens = len(token_ids)
    num_seqs = len(seq_lens)
    T = bucket(max(num_tokens, 1), minimum=8, maximum=None)
    S = bucket(max(num_seqs, 1), minimum=8, maximum=None)
    # Table-width minimum of 8: a smaller floor makes the decode program
    # recompile mid-serve the moment any context crosses 4 pages (128 tokens
    # at block 32) — a whole-program compile landing in the serving path for
    # a few lanes of padding saved.
    max_pages = max((len(t) for t in per_seq_tables), default=1)
    P = bucket(max(max_pages, 1), minimum=8, maximum=max_pages_per_seq)

    tok = np.zeros(T, dtype=np.int32)
    tok[:num_tokens] = token_ids
    pos = np.zeros(T, dtype=np.int32)
    pos[:num_tokens] = positions
    slots = np.full(T, PAD_SLOT_ID, dtype=np.int32)
    slots[:num_tokens] = slot_mapping

    tables = np.zeros((S, P), dtype=np.int32)
    for i, t in enumerate(per_seq_tables):
        tables[i, : min(len(t), P)] = t[:P]

    sl = np.zeros(S, dtype=np.int32)
    sl[:num_seqs] = seq_lens
    qsl = np.zeros(S + 1, dtype=np.int32)
    qsl[1 : num_seqs + 1] = np.cumsum(q_lens)
    qsl[num_seqs + 1 :] = qsl[num_seqs]

    # Last-token row per sequence (ref: worker.rs:688-698); padding seqs point
    # at row 0 (their sampled tokens are discarded).
    sel = np.zeros(S, dtype=np.int32)
    sel[:num_seqs] = qsl[1 : num_seqs + 1] - 1
    smask = np.zeros(S, dtype=bool)
    smask[:num_seqs] = sample_mask

    return ModelInput(
        token_ids=tok,
        positions=pos,
        slot_mapping=slots,
        block_tables=tables,
        seq_lens=sl,
        query_start_loc=qsl,
        num_seqs=np.asarray(num_seqs, dtype=np.int32),
        selected_token_indices=sel,
        sample_mask=smask,
        num_prefills=num_prefills,
        max_q_len=max(q_lens, default=0),
    )
