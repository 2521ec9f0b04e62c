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
``max_q_len``: a bound on the longest query chunk, which sizes the
attention kernel's grid without a device read. A CUDA graph freezes it, so
it is a bucket: 1 on a pure-decode step; on a step with a prefill chunk the
longest chunk rounded up on the sparse ``bucket`` ladder and capped at T.
Speculative decoding's verify rows (``engine/spec_decode.py``) ride the
same layout: a drafted sequence's decode row becomes a 1+k token chunk, and
``spec_rows`` names the [S, K+1] rows the sampler reads; on such a step
``max_q_len`` is 1+K whatever the drafts' lengths (or the chunk's bucket,
when a prefill chunk rides beside them), so the ragged kernel's plan
depends on the step's key only.

``SHAPE_COUNTS`` counts the distinct ``(kind, T, S, P)`` step shapes a
process dispatches, as the JAX package counts its compiled programs: on the
card every step replays a CUDA graph of its key (``engine/cuda_graphs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..ops.kv_cache import PAD_SLOT_ID
from ..sequence import SequenceGroupMetadata

# How many distinct (kind, T, S, P) bucket shapes a serving session
# dispatches, and how often.
SHAPE_COUNTS: dict = {}


def _record_shape(T: int, S: int, P: int, kind: str) -> None:
    key = (kind, T, S, P)
    SHAPE_COUNTS[key] = SHAPE_COUNTS.get(key, 0) + 1


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
    seq_ids: List[int]           # actual seq ids, scheduler order
    num_prefills: int
    max_q_len: int               # longest query chunk (host value)
    # Speculative decoding (engine/spec_decode.py), present only when at
    # least one scheduled sequence carries drafts this step:
    spec_rows: Optional[np.ndarray] = None   # [S, K+1] int32 verify rows
    spec_draft: Optional[np.ndarray] = None  # [S, K] int32 drafts (-1 pad)
    spec_k: Optional[np.ndarray] = None      # [S] int32 draft count (0 = none)

    @property
    def decode_only(self) -> bool:
        """Pure decode step: one query token per sequence (on the card the
        fused kernel, or the write and the ragged kernel past
        ``MAX_FUSED_GROUP`` q heads per kv head: ``ops/paged_attention.py``
        ``decode_route``). A verify step carries 1+k token chunks, so it
        takes the ragged kernel."""
        return self.num_prefills == 0 and self.spec_rows is None


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
    seq_ids: List[int] = []
    datas = []
    tables_list = []
    for meta in metadata_list:
        if meta.is_prompt or meta.spec_token_ids:
            return None
        for seq_id, seq_data in meta.seq_data.items():
            seq_ids.append(seq_id)
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
    _record_shape(T, S, P, "decode")

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
        seq_ids=seq_ids,
        num_prefills=0,
        max_q_len=1,
    )


def prepare_model_input(
    metadata_list: List[SequenceGroupMetadata],
    *,
    block_size: int,
    max_pages_per_seq: int,
    sliding_window: Optional[int] = None,
    num_spec_tokens: int = 0,
) -> ModelInput:
    """Flatten one step's scheduled groups into bucketed batch arrays.

    Layout contract: prefill chunks first, then decode tokens, sequences
    back-to-back (ref: flash_attention.rs:156-174 + scheduler ordering).
    A drafted sequence's decode row is its last token followed by its
    drafts, one ragged chunk (``num_spec_tokens`` is K, the most drafts a
    sequence carries).
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
    seq_ids: List[int] = []
    num_prefills = 0
    spec_lists: List[List[int]] = []

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
            drafts = (
                list(meta.spec_token_ids)
                if (not meta.is_prompt and meta.spec_token_ids)
                else []
            )
            if drafts:
                # Verify chunk: [last_token] + drafts, one ragged chunk
                # (the chunked-prefill kernel path).
                new_tokens = list(new_tokens) + drafts
            spec_lists.append(drafts)
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
            seq_ids.append(seq_id)

    num_tokens = len(token_ids)
    num_seqs = len(seq_lens)
    T = bucket(max(num_tokens, 1), minimum=8, maximum=None)
    S = bucket(max(num_seqs, 1), minimum=8, maximum=None)
    drafted = any(spec_lists)
    K = max(1, num_spec_tokens)
    if drafted:
        # A verify step carries up to S·(1+K) tokens, an exact bucket (S is
        # a power of two, so it stays a multiple of 8) where the next power
        # of two would pad by up to ~60%.
        t_spec = S * (1 + K)
        if num_tokens <= t_spec < T:
            T = t_spec
    # Table-width minimum of 8: a smaller floor makes the decode program
    # recompile mid-serve the moment any context crosses 4 pages (128 tokens
    # at block 32) — a whole-program compile landing in the serving path for
    # a few lanes of padding saved.
    max_pages = max((len(t) for t in per_seq_tables), default=1)
    P = bucket(max(max_pages, 1), minimum=8, maximum=max_pages_per_seq)
    _record_shape(T, S, P, "mixed")

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

    # The verify rows (only when a sequence drafted): a drafted sequence's
    # 1+k chunk rows, the last repeated to K+1 so the gather's shape is the
    # step's key; an undrafted one (plain decode, or a prefill chunk) its
    # last row, which is the token the engine appends.
    spec_rows = spec_draft = spec_k = None
    max_q_len = max(q_lens, default=0)
    if drafted:
        spec_rows = np.zeros((S, K + 1), dtype=np.int32)
        spec_draft = np.full((S, K), -1, dtype=np.int32)
        spec_k = np.zeros(S, dtype=np.int32)
        j = np.arange(K + 1)
        for i in range(num_seqs):
            start = qsl[i]
            q_len = qsl[i + 1] - start
            k_i = min(len(spec_lists[i]), K)
            if k_i:
                spec_rows[i] = start + np.minimum(j, q_len - 1)
                spec_draft[i, :k_i] = spec_lists[i][:k_i]
                spec_k[i] = k_i
            else:
                spec_rows[i] = start + q_len - 1
        # The ragged kernel's plan reads max_q_len: fixed at 1+K on a verify
        # step, so it does not vary with the longest draft.
        max_q_len = max(max_q_len, 1 + K)
    if num_prefills:
        # A graph freezes max_q_len (the ragged kernels' grid and plan): a
        # prefill chunk's length is bucketed, so that steps of one key
        # share it. A larger value only adds query tiles that store nothing.
        max_q_len = bucket(max_q_len, maximum=T)

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
        seq_ids=seq_ids,
        num_prefills=num_prefills,
        max_q_len=max_q_len,
        spec_rows=spec_rows,
        spec_draft=spec_draft,
        spec_k=spec_k,
    )
