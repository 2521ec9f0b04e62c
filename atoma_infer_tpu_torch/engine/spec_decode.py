"""Speculative decoding: n-gram prompt-lookup drafts + batched verification.

The reference only carries speculative-decoding *metric types*
(ref: sequence.rs:2131-2154 ``SpecDecodeWorkerMetrics``; roadmap item) — this
module implements the feature. The draft source is prompt-lookup (n-gram)
speculation: propose the continuation of the most recent earlier occurrence
of the sequence's trailing n-gram. It needs no draft model, costs only a
host-side numpy scan per decode step, and wins exactly where decode is most
latency-bound (summarization / code editing / RAG — outputs that echo the
prompt).

TPU-native verification design: drafted tokens ride the SAME unified ragged
attention kernel as chunked prefill (each spec sequence simply schedules a
(1 + k)-token chunk), the LM head + sampler run over a static
``[S, K+1]``-row gather, and acceptance is decided on host from one small
``[S, K+1]`` token transfer — no extra kernels, no dynamic shapes, and a
step with zero proposals compiles to the exact non-speculative program.

Scope guard: speculation applies only to *greedy* single-sequence groups
(no penalties, no top-n); verification then reproduces the non-speculative
greedy output token-for-token. Sampled requests in the same batch decode
normally alongside.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# Re-check eligibility cheaply per schedule; see ``eligible_group``.


class NgramProposer:
    """Prompt-lookup draft proposer (n-gram match over the sequence's own
    tokens).

    For each decode step, scan the sequence's token ids for the most recent
    earlier occurrence of its trailing ``n``-gram (``n`` from ``ngram_max``
    down to ``ngram_min``); propose up to ``num_speculative_tokens`` tokens
    that followed that occurrence.
    """

    def __init__(
        self,
        num_speculative_tokens: int,
        ngram_max: int = 3,
        ngram_min: int = 1,
    ):
        if num_speculative_tokens < 1:
            raise ValueError("num_speculative_tokens must be >= 1")
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.k = num_speculative_tokens
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(
        self, token_ids: Sequence[int], max_len: Optional[int] = None
    ) -> List[int]:
        """Draft tokens for one sequence ([] = no proposal this step)."""
        k = self.k if max_len is None else min(self.k, max_len)
        if k <= 0:
            return []
        arr = np.asarray(token_ids, dtype=np.int64)
        L = arr.shape[0]
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if L < n + 1:
                continue
            pattern = arr[L - n :]
            # Candidate start positions: matches of the trailing n-gram whose
            # continuation starts before the tail itself.
            windows = np.lib.stride_tricks.sliding_window_view(
                arr[: L - 1], n
            )
            hits = np.nonzero((windows == pattern).all(axis=1))[0]
            # Exclude the trailing occurrence and matches with no
            # continuation room.
            hits = hits[hits + n < L]
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n  # most recent occurrence wins
            draft = arr[start : start + k]
            if draft.size == 0:
                continue
            return [int(t) for t in draft]
        return []


def eligible_group(group) -> bool:
    """Whether a running group may be drafted for: greedy, single-sequence,
    penalty-free (verification rows share one penalty-free greedy argmax,
    so acceptance exactly reproduces non-speculative decoding)."""
    if group.get_max_num_running_seqs() != 1:
        return False
    if getattr(group, "top_n_tokens", 0):
        return False
    p = group.next_token_chooser_params
    if p.do_sample and p.temperature > 1e-5:
        return False
    return (
        getattr(p, "repetition_penalty", 1.0) == 1.0
        and getattr(p, "frequency_penalty", 0.0) == 0.0
    )
