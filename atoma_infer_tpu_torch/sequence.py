"""Sequence state machine and scheduler↔executor contracts.

Mirrors the reference's sequence model (ref: backends/vllm/src/sequence.rs):
``SequenceData`` (:166-179), ``Sequence`` (:467-493), the 7-state
``SequenceStatus`` lifecycle (:68-76), ``SequenceGroup`` (:1045-1062),
``SequenceGroupMetadata`` — the scheduler→worker contract (:1962-1985),
``SequenceOutput``/``SequenceGroupOutput`` — the worker→engine contract
(:2053-2154), and ``ExecuteModelRequest`` — the engine→worker contract
(:2158-2211).

Unlike the reference there are no ``Arc<RwLock<…>>`` wrappers: the engine event
loop is single-threaded asyncio, so plain Python objects shared by reference
suffice (the reference itself relies on its single-threaded engine loop for
cross-queue consistency — SURVEY.md §5 "race detection").
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional, Tuple

from .sampling_params import (
    NextTokenChooserParameters,
    StoppingCriteriaParameters,
)


class SequenceStatus(enum.Enum):
    """Sequence lifecycle (ref: sequence.rs:68-76)."""

    WAITING = enum.auto()
    RUNNING = enum.auto()
    SWAPPED = enum.auto()
    FINISHED_STOPPED = enum.auto()
    FINISHED_LENGTH_CAPPED = enum.auto()
    FINISHED_ABORTED = enum.auto()
    FINISHED_IGNORED = enum.auto()

    @property
    def is_finished(self) -> bool:
        return self in _FINISHED_STATUSES

    @property
    def finished_reason(self) -> Optional[str]:
        """Reason strings per the reference (ref: sequence.rs:118-126)."""
        return {
            SequenceStatus.FINISHED_STOPPED: "stopped",
            SequenceStatus.FINISHED_LENGTH_CAPPED: "length_capped",
            SequenceStatus.FINISHED_ABORTED: "aborted",
            SequenceStatus.FINISHED_IGNORED: "ignored",
        }.get(self)


_FINISHED_STATUSES = frozenset(
    {
        SequenceStatus.FINISHED_STOPPED,
        SequenceStatus.FINISHED_LENGTH_CAPPED,
        SequenceStatus.FINISHED_ABORTED,
        SequenceStatus.FINISHED_IGNORED,
    }
)


class SequenceStage(enum.Enum):
    """Prefill vs decode stage of a sequence (ref: sequence.rs:166-179)."""

    PREFILL = enum.auto()
    DECODE = enum.auto()


@dataclasses.dataclass
class RequestMetrics:
    """Per-request lifecycle timing (ref: sequence.rs:142-159)."""

    arrival_time: float
    last_token_time: float
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    time_in_queue: Optional[float] = None
    finished_time: Optional[float] = None


class SequenceData:
    """Token-level data for one sequence (ref: sequence.rs:166-400).

    Tracks prompt/output token ids, the number of *computed* tokens (tokens
    whose KV entries already exist in the cache), and the prefill/decode stage.
    Chunked prefill advances ``num_computed_tokens`` by less than the full
    prompt, staying in PREFILL until the whole prompt is computed
    (ref: sequence.rs:382-420).
    """

    __slots__ = (
        "prompt_token_ids",
        "output_token_ids",
        "cumulative_logprob",
        "_num_computed_tokens",
        "stage",
    )

    def __init__(
        self,
        prompt_token_ids: List[int],
        output_token_ids: Optional[List[int]] = None,
    ):
        self.prompt_token_ids: List[int] = list(prompt_token_ids)
        self.output_token_ids: List[int] = list(output_token_ids or [])
        self.cumulative_logprob: float = 0.0
        self._num_computed_tokens: int = 0
        self.stage: SequenceStage = SequenceStage.PREFILL

    # -- lengths ------------------------------------------------------------
    def get_len(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    def get_prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    def get_output_len(self) -> int:
        return len(self.output_token_ids)

    def get_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    def get_last_token_id(self) -> int:
        if self.output_token_ids:
            return self.output_token_ids[-1]
        return self.prompt_token_ids[-1]

    # -- computed-token bookkeeping (ref: sequence.rs:350-420) ----------------
    def get_num_computed_tokens(self) -> int:
        return self._num_computed_tokens

    def get_num_uncomputed_tokens(self) -> int:
        # During decode the "uncomputed" token is the newly sampled one; during
        # (chunked) prefill it is the remaining prompt suffix.
        return self.get_len() - self._num_computed_tokens

    def update_num_computed_tokens(self, num_new_computed: int) -> None:
        self._num_computed_tokens += num_new_computed
        assert self._num_computed_tokens <= self.get_len(), (
            self._num_computed_tokens,
            self.get_len(),
        )
        if self.get_num_uncomputed_tokens() == 0:
            self.stage = SequenceStage.DECODE

    def reset_state_for_recompute(self) -> None:
        """After recompute-preemption the whole sequence is a fresh prefill
        (ref: sequence.rs — recompute path via scheduler.rs:1778-1826)."""
        self._num_computed_tokens = 0
        self.stage = SequenceStage.PREFILL

    # -- mutation -------------------------------------------------------------
    def append_token_id(self, token_id: int, logprob: float) -> None:
        self.output_token_ids.append(token_id)
        self.cumulative_logprob += logprob

    def __repr__(self) -> str:
        return (
            f"SequenceData(prompt_len={self.get_prompt_len()}, "
            f"output_len={self.get_output_len()}, "
            f"computed={self._num_computed_tokens}, stage={self.stage.name})"
        )


@dataclasses.dataclass
class LogProb:
    """A single token's logprob record (ref: sequence.rs output_logprobs)."""

    token_id: int
    logprob: float
    decoded_token: Optional[str] = None
    top_tokens: Optional[List[tuple]] = None


class Sequence:
    """One generation stream: data + status + detokenization state.

    Ref: backends/vllm/src/sequence.rs:467-760. Logical block accounting is
    derived from token counts rather than materialized ``LogicalTokenBlock``
    objects — ``num_logical_blocks`` is what the block manager actually needs.
    """

    def __init__(
        self,
        seq_id: int,
        prompt: str,
        prompt_token_ids: List[int],
        block_size: int,
        eos_token_id: Optional[int] = None,
    ):
        self.seq_id = seq_id
        self.prompt = prompt
        self.block_size = block_size
        self.eos_token_id = eos_token_id
        self.sequence_data = SequenceData(prompt_token_ids)
        self.output_text: str = ""
        self.status: SequenceStatus = SequenceStatus.WAITING
        self.stop_reason: Optional[int | str] = None
        self.output_logprobs: List[LogProb] = []
        # Incremental detokenization state (engine-owned; ref does a full
        # re-decode per step, llm_engine.rs:396-400 — we do better, see
        # engine/detokenizer.py).
        self.tokens: Optional[List[str]] = None
        self.prefix_offset: int = 0
        self.read_offset: int = 0

    # -- delegation to data ---------------------------------------------------
    def get_len(self) -> int:
        return self.sequence_data.get_len()

    def get_prompt_len(self) -> int:
        return self.sequence_data.get_prompt_len()

    def get_output_len(self) -> int:
        return self.sequence_data.get_output_len()

    def get_token_ids(self) -> List[int]:
        return self.sequence_data.get_token_ids()

    def get_last_token_id(self) -> int:
        return self.sequence_data.get_last_token_id()

    def get_cumulative_logprob(self) -> float:
        return self.sequence_data.cumulative_logprob

    # -- block accounting -----------------------------------------------------
    @property
    def num_logical_blocks(self) -> int:
        """Number of logical KV blocks this sequence occupies."""
        return max(1, -(-self.get_len() // self.block_size))

    def num_empty_slots_in_last_block(self) -> int:
        rem = self.get_len() % self.block_size
        return 0 if rem == 0 else self.block_size - rem

    def hash_of_block(self, logical_idx: int) -> int:
        """Content hash of a FULL prompt block: all prompt tokens up to and
        including the block (prefix-identity, ref: sequence.rs:571-580 —
        declared there, wired here for prefix caching)."""
        n = (logical_idx + 1) * self.block_size
        assert n <= self.get_prompt_len(), "only full prompt blocks are hashed"
        return hash(tuple(self.sequence_data.prompt_token_ids[:n]))

    @property
    def num_full_prompt_blocks(self) -> int:
        """Prompt blocks that are completely filled by prompt tokens."""
        return self.get_prompt_len() // self.block_size

    # -- lifecycle --------------------------------------------------------------
    def is_finished(self) -> bool:
        return self.status.is_finished

    def is_prefill(self) -> bool:
        return self.sequence_data.stage == SequenceStage.PREFILL

    def get_num_new_tokens(self) -> int:
        """Tokens this sequence wants computed next step: 1 in decode, the
        remaining uncomputed prompt in prefill (ref: sequence.rs:700-720)."""
        if self.sequence_data.stage == SequenceStage.DECODE:
            return 1
        return self.sequence_data.get_num_uncomputed_tokens()

    def append_token_id(self, token_id: int, logprob: float) -> None:
        self.sequence_data.append_token_id(token_id, logprob)
        self.output_logprobs.append(LogProb(token_id=token_id, logprob=logprob))

    def reset_state_for_recompute(self) -> None:
        self.sequence_data.reset_state_for_recompute()

    def fork(self, new_seq_id: int) -> "Sequence":
        """Deep-copy for beam/parallel sampling (ref: sequence.rs fork +
        block_manager.rs:408-446 shares the physical blocks)."""
        import copy

        new_seq = Sequence.__new__(Sequence)
        new_seq.__dict__ = {}
        new_seq.seq_id = new_seq_id
        new_seq.prompt = self.prompt
        new_seq.block_size = self.block_size
        new_seq.eos_token_id = self.eos_token_id
        new_seq.sequence_data = SequenceData(
            self.sequence_data.prompt_token_ids,
            self.sequence_data.output_token_ids,
        )
        new_seq.sequence_data.cumulative_logprob = (
            self.sequence_data.cumulative_logprob
        )
        new_seq.sequence_data._num_computed_tokens = (
            self.sequence_data.get_num_computed_tokens()
        )
        new_seq.sequence_data.stage = self.sequence_data.stage
        new_seq.output_text = self.output_text
        new_seq.status = self.status
        new_seq.stop_reason = self.stop_reason
        new_seq.output_logprobs = copy.deepcopy(self.output_logprobs)
        new_seq.tokens = list(self.tokens) if self.tokens is not None else None
        new_seq.prefix_offset = self.prefix_offset
        new_seq.read_offset = self.read_offset
        return new_seq

    def __repr__(self) -> str:
        return (
            f"Sequence(id={self.seq_id}, status={self.status.name}, "
            f"data={self.sequence_data!r})"
        )


class SequenceGroup:
    """All sequences spawned from one request (ref: sequence.rs:1045-1400)."""

    def __init__(
        self,
        request_id: str,
        sequences: List[Sequence],
        arrival_time: Optional[float] = None,
        next_token_chooser_params: Optional[NextTokenChooserParameters] = None,
        stopping_criteria: Optional[StoppingCriteriaParameters] = None,
        logprobs: bool = False,
        best_of: int = 1,
        top_n_tokens: int = 0,
    ):
        if not sequences:
            raise ValueError("SequenceGroup requires at least one sequence")
        self.request_id = request_id
        self.sequences: Dict[int, Sequence] = {s.seq_id: s for s in sequences}
        now = arrival_time if arrival_time is not None else time.monotonic()
        self.metrics = RequestMetrics(arrival_time=now, last_token_time=now)
        self.next_token_chooser_params = (
            next_token_chooser_params or NextTokenChooserParameters()
        )
        self.stopping_criteria = stopping_criteria or StoppingCriteriaParameters()
        self.logprobs = logprobs
        self.best_of = best_of
        self.top_n_tokens = top_n_tokens
        # Streaming channel attached by the engine for SSE requests.
        self.stream: bool = False

    # -- views ------------------------------------------------------------------
    def get_seqs(
        self, status: Optional[SequenceStatus] = None
    ) -> List[Sequence]:
        if status is None:
            return list(self.sequences.values())
        return [s for s in self.sequences.values() if s.status == status]

    def get_first_seq(self) -> Sequence:
        return next(iter(self.sequences.values()))

    def get_unfinished_seqs(self) -> List[Sequence]:
        return [s for s in self.sequences.values() if not s.is_finished()]

    def get_finished_seqs(self) -> List[Sequence]:
        return [s for s in self.sequences.values() if s.is_finished()]

    def num_seqs(self, status: Optional[SequenceStatus] = None) -> int:
        return len(self.get_seqs(status))

    def num_unfinished_seqs(self) -> int:
        return len(self.get_unfinished_seqs())

    def is_finished(self) -> bool:
        return all(s.is_finished() for s in self.sequences.values())

    def is_prefill(self) -> bool:
        return self.get_first_seq().is_prefill()

    def get_max_num_running_seqs(self) -> int:
        """Upper bound of concurrently running sequences for this group
        (ref: sequence.rs:1380 — accounts for best_of/beam width)."""
        if self.best_of > self.num_seqs():
            # Beam/parallel sampling may fork up to best_of sequences.
            return self.best_of
        return self.num_unfinished_seqs()

    # -- scheduling hooks ---------------------------------------------------------
    def maybe_set_first_scheduled_time(self, now: float) -> None:
        if self.metrics.first_scheduled_time is None:
            self.metrics.first_scheduled_time = now
            self.metrics.time_in_queue = now - self.metrics.arrival_time

    def maybe_set_first_token_time(self, now: float) -> None:
        if self.metrics.first_token_time is None:
            self.metrics.first_token_time = now

    def set_finished_time(self, now: float) -> None:
        self.metrics.finished_time = now

    def update_num_computed_tokens(self, num_new_computed: int) -> None:
        # ``num_new_computed`` is the group's token_chunk_size — for best_of
        # groups that is the SUM over candidates; clamp per sequence.
        for seq in self.sequences.values():
            if not seq.is_finished():
                seq.sequence_data.update_num_computed_tokens(
                    min(
                        num_new_computed,
                        seq.sequence_data.get_num_uncomputed_tokens(),
                    )
                )

    def add_sequence(self, seq: Sequence) -> None:
        self.sequences[seq.seq_id] = seq

    def remove_sequence(self, seq_id: int) -> None:
        del self.sequences[seq_id]

    def __repr__(self) -> str:
        return (
            f"SequenceGroup(request_id={self.request_id!r}, "
            f"num_seqs={self.num_seqs()})"
        )


@dataclasses.dataclass
class SequenceGroupMetadata:
    """Scheduler→worker contract (ref: sequence.rs:1962-1985).

    ``block_tables`` maps seq_id → list of physical block numbers.
    ``token_chunk_size`` is how many tokens of each sequence to compute this
    step (the chunk for chunked prefill, 1 for decode). ``do_sample`` is False
    for partial prefill chunks (ref: scheduler.rs:1510-1520).
    """

    request_id: str
    is_prompt: bool
    seq_data: Dict[int, SequenceData]
    block_tables: Dict[int, List[int]]
    next_token_chooser_params: NextTokenChooserParameters
    stopping_criteria: StoppingCriteriaParameters
    do_sample: bool = True
    token_chunk_size: int = 1
    computed_block_nums: Optional[List[int]] = None
    logprobs: bool = False
    top_n_tokens: int = 0
    # Speculative decoding (engine/spec_decode.py): drafted token ids for
    # this decode step (single-sequence groups only). The worker feeds
    # [last_token] + drafts as one (1+k)-token chunk and verifies.
    spec_token_ids: Optional[List[int]] = None


@dataclasses.dataclass
class SequenceOutput:
    """One sampled token for one sequence (ref: sequence.rs:2053-2080)."""

    parent_seq_id: int
    output_token: int
    logprob: float
    is_new_token: bool = True
    # Top-n alternative (token_id, logprob) pairs for this step
    # (TGI-style top_n_tokens; absent unless requested).
    top_tokens: Optional[List[tuple]] = None
    # Speculative decoding: accepted (token_id, logprob) pairs BEYOND
    # output_token — the verified drafts plus the bonus token, in order.
    extra_tokens: Optional[List[tuple]] = None

    @property
    def all_tokens(self) -> List[tuple]:
        """All (token_id, logprob) pairs this step, first token included."""
        out = [(self.output_token, self.logprob)]
        if self.extra_tokens:
            out.extend(self.extra_tokens)
        return out


@dataclasses.dataclass
class SequenceGroupOutput:
    """Worker→engine contract for one group at one step
    (ref: sequence.rs:2085-2154)."""

    outputs: Dict[int, SequenceOutput]
    sampled_token_ids: Optional[object] = None
    time_to_generate: Optional[float] = None
    # Speculative decoding: how far num_computed_tokens advances this step
    # (= tokens appended); None means meta.token_chunk_size, the
    # non-speculative contract.
    num_computed_advance: Optional[int] = None


@dataclasses.dataclass
class ExecuteModelRequest:
    """Engine→worker contract (ref: sequence.rs:2158-2211)."""

    sequence_groups_metadata: List[SequenceGroupMetadata]
    blocks_to_swap_in: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list
    )
    blocks_to_swap_out: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list
    )
    blocks_to_copy: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    running_queue_size: int = 0
