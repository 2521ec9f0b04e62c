"""Incremental detokenization.

The reference re-decodes the ENTIRE token-id list every step
(llm_engine.rs:396-400 — noted as a known inefficiency in SURVEY.md §2.2).
Here decoding is incremental with the standard prefix-offset technique: keep
``prefix_offset``/``read_offset`` into the token list, decode only the tail
window, and emit new text once it no longer ends in an incomplete UTF-8 /
byte-fallback fragment (the '�' guard).
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def decode_incrementally(
    tokenizer,
    all_token_ids: List[int],
    prefix_offset: int,
    read_offset: int,
    skip_special_tokens: bool = True,
) -> Tuple[str, int, int]:
    """Returns (new_text, new_prefix_offset, new_read_offset)."""
    prefix_text = tokenizer.decode(
        all_token_ids[prefix_offset:read_offset],
        skip_special_tokens=skip_special_tokens,
    )
    full_text = tokenizer.decode(
        all_token_ids[prefix_offset:],
        skip_special_tokens=skip_special_tokens,
    )
    if len(full_text) > len(prefix_text) and not full_text.endswith("�"):
        new_text = full_text[len(prefix_text):]
        return new_text, read_offset, len(all_token_ids)
    return "", prefix_offset, read_offset


class Detokenizer:
    """Engine-side incremental decoder for live sequences."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def decode_sequence_inplace(self, seq, end=None) -> str:
        """Decode a sequence's newest tokens; appends to ``seq.output_text``
        and returns just the newly produced text chunk. ``end`` bounds the
        tokens considered — async scheduling (depth >1) patches a token
        while newer, still-unpatched placeholders sit past it."""
        output_ids = seq.sequence_data.output_token_ids
        if end is not None:
            output_ids = output_ids[:end]
        new_text, seq.prefix_offset, seq.read_offset = decode_incrementally(
            self.tokenizer,
            output_ids,
            seq.prefix_offset,
            seq.read_offset,
        )
        if new_text:
            seq.output_text += new_text
        return new_text

    def finalize_sequence(self, seq, end=None) -> str:
        """Flush text the '�' guard withheld once a sequence finishes: a
        trailing incomplete UTF-8 / byte-fallback fragment will never
        complete, so emit it (with replacement chars) exactly as a full
        re-decode of the token list would. Returns the flushed text."""
        output_ids = seq.sequence_data.output_token_ids
        if end is not None:
            output_ids = output_ids[:end]
        if seq.read_offset >= len(output_ids):
            return ""
        prefix_text = self.tokenizer.decode(
            output_ids[seq.prefix_offset : seq.read_offset],
            skip_special_tokens=True,
        )
        full_text = self.tokenizer.decode(
            output_ids[seq.prefix_offset :], skip_special_tokens=True
        )
        tail = (
            full_text[len(prefix_text):]
            if len(full_text) > len(prefix_text)
            else ""
        )
        seq.prefix_offset = seq.read_offset = len(output_ids)
        if tail:
            seq.output_text += tail
        return tail
