"""Continuous-batching scheduler.

Ref: backends/vllm/src/scheduler.rs. vLLM-style: three queues
waiting/running/swapped (:320-324), a ``SchedulingBudget`` capping batched
tokens and sequences per step (:40-149), two algorithms —
``schedule_default`` (prefill-prioritized, never mixes prefill+decode,
:1057-1217) and ``schedule_chunked_prefill`` (decode-first, mixes chunked
prefills, :1257-1379) — preemption by recompute (single-seq) or swap
(multi-seq) when slots run out (:1778-1826, preempted to the FRONT of waiting
:1128-1132), swap-in gating via ``AllocationStatus`` (:791-844), prompt-length
limits → FinishedIgnored (:957-970), and a delay-factor heuristic letting the
waiting queue fill (:2077-2097).

Produces ``SequenceGroupMetadata`` (:1498-1536) and ``SchedulerOutputs`` with
mutually-exclusive swap-in/swap-out maps (:266-274).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

from ..config import CacheConfig, SchedulerConfig
from ..utils.tracing import instrument
from ..sequence import (
    SequenceGroup,
    SequenceGroupMetadata,
    SequenceStatus,
)
from .block_manager import AllocationStatus, BlockSpaceManager
from .policy import FcfsPolicy, Policy

logger = logging.getLogger(__name__)


class PreemptionMode(enum.Enum):
    """How a victim is evicted (ref: scheduler.rs:26-29)."""

    SWAP = enum.auto()        # move KV blocks to host RAM
    RECOMPUTE = enum.auto()   # discard KV, re-prefill later (cheaper single-seq)


class SchedulingBudget:
    """Per-step token + sequence budget (ref: scheduler.rs:40-149).

    Request-id sets guard against double counting when a group is examined by
    multiple sub-passes in one step.
    """

    def __init__(self, token_budget: int, max_num_seqs: int):
        self.token_budget = token_budget
        self.max_num_seqs = max_num_seqs
        self._num_batched_tokens = 0
        self._num_curr_seqs = 0
        self._token_request_ids: Set[str] = set()
        self._seq_request_ids: Set[str] = set()

    def can_schedule(self, *, num_new_tokens: int, num_new_seqs: int) -> bool:
        assert num_new_tokens > 0 and num_new_seqs > 0
        return (
            self._num_batched_tokens + num_new_tokens <= self.token_budget
            and self._num_curr_seqs + num_new_seqs <= self.max_num_seqs
        )

    def remaining_token_budget(self) -> int:
        return self.token_budget - self._num_batched_tokens

    def add_num_batched_tokens(self, request_id: str, num: int) -> None:
        if request_id in self._token_request_ids:
            return
        self._token_request_ids.add(request_id)
        self._num_batched_tokens += num

    def subtract_num_batched_tokens(self, request_id: str, num: int) -> None:
        if request_id in self._token_request_ids:
            self._token_request_ids.remove(request_id)
            self._num_batched_tokens -= num

    def add_num_seqs(self, request_id: str, num: int) -> None:
        if request_id in self._seq_request_ids:
            return
        self._seq_request_ids.add(request_id)
        self._num_curr_seqs += num

    def subtract_num_seqs(self, request_id: str, num: int) -> None:
        if request_id in self._seq_request_ids:
            self._seq_request_ids.remove(request_id)
            self._num_curr_seqs -= num

    @property
    def num_batched_tokens(self) -> int:
        return self._num_batched_tokens

    @property
    def num_curr_seqs(self) -> int:
        return self._num_curr_seqs


@dataclasses.dataclass
class ScheduledSequenceGroup:
    """A group picked this step + how many tokens of it to run
    (ref: scheduler.rs:2221-2231)."""

    seq_group: SequenceGroup
    token_chunk_size: int


@dataclasses.dataclass
class SchedulerOutputs:
    """One step's scheduling decision (ref: scheduler.rs:220-280)."""

    scheduled_seq_groups: List[ScheduledSequenceGroup]
    num_prefill_groups: int
    num_batched_tokens: int
    blocks_to_swap_in: List[Tuple[int, int]]
    blocks_to_swap_out: List[Tuple[int, int]]
    blocks_to_copy: List[Tuple[int, int]]
    ignored_seq_groups: List[SequenceGroup]
    preempted: int
    running_queue_size: int = 0

    def __post_init__(self) -> None:
        # Never swap in and out in the same step (ref: scheduler.rs:266-274).
        assert not (self.blocks_to_swap_in and self.blocks_to_swap_out), (
            "swap-in and swap-out in the same step is invalid"
        )

    def is_empty(self) -> bool:
        return (
            not self.scheduled_seq_groups
            and not self.blocks_to_swap_in
            and not self.blocks_to_swap_out
            and not self.blocks_to_copy
        )


@dataclasses.dataclass
class _RunningOutputs:
    decode_seq_groups: List[ScheduledSequenceGroup] = dataclasses.field(
        default_factory=list
    )
    prefill_seq_groups: List[ScheduledSequenceGroup] = dataclasses.field(
        default_factory=list
    )
    preempted: List[SequenceGroup] = dataclasses.field(default_factory=list)
    swapped_out: List[SequenceGroup] = dataclasses.field(default_factory=list)
    blocks_to_swap_out: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list
    )
    blocks_to_copy: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _SwappedInOutputs:
    decode_seq_groups: List[ScheduledSequenceGroup] = dataclasses.field(
        default_factory=list
    )
    prefill_seq_groups: List[ScheduledSequenceGroup] = dataclasses.field(
        default_factory=list
    )
    blocks_to_swap_in: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list
    )
    blocks_to_copy: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    infeasible_seq_groups: List[SequenceGroup] = dataclasses.field(
        default_factory=list
    )


@dataclasses.dataclass
class _PrefillOutputs:
    seq_groups: List[ScheduledSequenceGroup] = dataclasses.field(
        default_factory=list
    )
    ignored_seq_groups: List[SequenceGroup] = dataclasses.field(
        default_factory=list
    )


class Scheduler:
    """The continuous-batching scheduler (ref: scheduler.rs:300-2230)."""

    def __init__(
        self,
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
        block_manager: Optional[BlockSpaceManager] = None,
        policy: Optional[Policy] = None,
    ):
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        self.block_manager = block_manager or BlockSpaceManager(
            block_size=cache_config.block_size,
            num_device_blocks=cache_config.num_device_blocks or 0,
            num_host_blocks=cache_config.num_host_blocks or 0,
            sliding_window=cache_config.sliding_window,
            enable_prefix_caching=getattr(
                cache_config, "enable_prefix_caching", False
            ),
        )
        self.policy = policy or FcfsPolicy()
        # Speculative decoding: n-gram prompt-lookup proposer (drafts are
        # scheduled as extra decode tokens + lookahead KV slots; the worker
        # verifies them in the same forward — engine/spec_decode.py).
        self.spec_proposer = None
        if getattr(scheduler_config, "num_speculative_tokens", 0) > 0:
            from ..engine.spec_decode import NgramProposer

            self.spec_proposer = NgramProposer(
                scheduler_config.num_speculative_tokens,
                ngram_max=scheduler_config.spec_ngram_max,
                ngram_min=scheduler_config.spec_ngram_min,
            )
        self.waiting: Deque[SequenceGroup] = deque()
        self.running: Deque[SequenceGroup] = deque()
        self.swapped: Deque[SequenceGroup] = deque()
        # Delay-factor state (ref: scheduler.rs:2077-2097).
        self.prev_time = 0.0
        self.prev_prompt = False
        self.last_prompt_latency = 0.0
        # Steady-decode fast path: cached (key, metadata, seqs, scheduled)
        # reused while the running set is unchanged (see
        # _schedule_decode_fast).
        self._fast_state = None

    # ---------------------------------------------------------------- queue ops
    def add_sequence_group(self, seq_group: SequenceGroup) -> None:
        """Admit a new request (ref: scheduler.rs:1739)."""
        self.waiting.append(seq_group)

    def abort_sequence_group(self, request_id: str) -> Optional[SequenceGroup]:
        """Abort: free blocks, mark FINISHED_ABORTED (ref: scheduler.rs:390-443)."""
        for queue in (self.waiting, self.running, self.swapped):
            for group in list(queue):
                if group.request_id != request_id:
                    continue
                queue.remove(group)
                for seq in group.get_seqs():
                    if not seq.is_finished():
                        seq.status = SequenceStatus.FINISHED_ABORTED
                    self.block_manager.free(seq)
                group.set_finished_time(time.monotonic())
                return group
        return None

    def has_unfinished_seqs(self) -> bool:
        return bool(self.waiting or self.running or self.swapped)

    def get_num_unfinished_seq_groups(self) -> int:
        return len(self.waiting) + len(self.running) + len(self.swapped)

    def free_seq(self, seq) -> None:
        self.block_manager.free(seq)

    def fork_seq(self, parent, child) -> None:
        self.block_manager.fork(parent, child)

    def remove_finished_sequences(self) -> None:
        """Prune finished groups from the running queue
        (ref: scheduler.rs:2203)."""
        self.running = deque(g for g in self.running if not g.is_finished())

    # ----------------------------------------------------------------- schedule
    @instrument("scheduler.schedule")
    def schedule(
        self,
    ) -> Tuple[List[SequenceGroupMetadata], SchedulerOutputs]:
        """Run one scheduling pass and build the worker metadata
        (ref: scheduler.rs:1455-1537)."""
        fast = self._schedule_decode_fast()
        if fast is not None:
            return fast
        self._fast_state = None
        outputs = self._schedule()
        now = time.monotonic()

        metadata_list: List[SequenceGroupMetadata] = []
        for scheduled in outputs.scheduled_seq_groups:
            group = scheduled.seq_group
            token_chunk_size = scheduled.token_chunk_size
            group.maybe_set_first_scheduled_time(now)

            seq_data = {}
            block_tables: Dict[int, List[int]] = {}
            computed_block_nums: Optional[List[int]] = None
            for seq in group.get_seqs(SequenceStatus.RUNNING):
                seq_data[seq.seq_id] = seq.sequence_data
                block_tables[seq.seq_id] = self.block_manager.get_block_table_ids(
                    seq.seq_id
                )
                self.block_manager.access_all_blocks_in_sequence(seq, now)
                if self.block_manager.enable_prefix_caching:
                    # Mark fully-written blocks computed (their tokens were
                    # processed in earlier steps) and report the computed
                    # prefix to the worker (ref: block_manager.rs:1045-1119).
                    self.block_manager.compute_full_blocks_in_sequence(seq)
                    if group.is_prefill():
                        computed_block_nums = (
                            self.block_manager.get_all_computed_blocks(seq)
                        )

            is_prompt = group.is_prefill()
            do_sample = True
            if is_prompt:
                # Partial chunked prefills must not sample
                # (ref: scheduler.rs:1510-1520). The scheduled chunk is the
                # GROUP total; the worker contract (SequenceGroupMetadata)
                # is PER SEQUENCE — best_of candidates chunk in lockstep so
                # the per-seq size is the total over the candidate count.
                seqs = group.get_seqs(SequenceStatus.RUNNING)
                token_chunk_size = token_chunk_size // max(1, len(seqs))
                computed = seqs[0].sequence_data.get_num_computed_tokens()
                if token_chunk_size + computed < seqs[0].get_len():
                    do_sample = False

            spec_token_ids = None
            if not is_prompt:
                spec_token_ids = getattr(group, "_spec_tokens", None)
                group._spec_tokens = None

            metadata_list.append(
                SequenceGroupMetadata(
                    request_id=group.request_id,
                    is_prompt=is_prompt,
                    seq_data=seq_data,
                    block_tables=block_tables,
                    next_token_chooser_params=group.next_token_chooser_params,
                    stopping_criteria=group.stopping_criteria,
                    do_sample=do_sample,
                    token_chunk_size=token_chunk_size,
                    computed_block_nums=computed_block_nums,
                    logprobs=group.logprobs,
                    top_n_tokens=getattr(group, "top_n_tokens", 0),
                    spec_token_ids=spec_token_ids,
                )
            )
        return metadata_list, outputs

    def _schedule_decode_fast(
        self,
    ) -> Optional[Tuple[List[SequenceGroupMetadata], SchedulerOutputs]]:
        """Steady-decode fast path: every step of a long decode reschedules
        the SAME groups for one token each — the full pass (priority sort,
        budget accounting, per-group token counting, metadata rebuild) is
        ~6 ms at 256 sequences, dominating the engine's host budget. While
        the running set is unchanged and nothing is waiting/swapped, reuse
        the cached metadata: per step only the per-seq ``append_slots`` (and
        a block-table refresh when a sequence crosses a block boundary or a
        copy-on-write fires) runs. Any other condition falls back to the
        full scheduling pass."""
        if (
            self.waiting
            or self.swapped
            or not self.running
            or self.spec_proposer is not None
            or self.block_manager.enable_prefix_caching
        ):
            return None
        key = tuple(
            (g.request_id, g.num_seqs(SequenceStatus.RUNNING))
            for g in self.running
        )
        state = self._fast_state
        if state is None or state[0] != key:
            if any(g.is_prefill() for g in self.running):
                return None
            metadata_list = []
            per_group_seqs = []
            scheduled = []
            for g in self.running:
                seqs = g.get_seqs(SequenceStatus.RUNNING)
                metadata_list.append(
                    SequenceGroupMetadata(
                        request_id=g.request_id,
                        is_prompt=False,
                        seq_data={
                            s.seq_id: s.sequence_data for s in seqs
                        },
                        block_tables={
                            s.seq_id: self.block_manager.get_block_table_ids(
                                s.seq_id
                            )
                            for s in seqs
                        },
                        next_token_chooser_params=g.next_token_chooser_params,
                        stopping_criteria=g.stopping_criteria,
                        do_sample=True,
                        token_chunk_size=1,
                        computed_block_nums=None,
                        logprobs=g.logprobs,
                        top_n_tokens=getattr(g, "top_n_tokens", 0),
                        spec_token_ids=None,
                    )
                )
                per_group_seqs.append(seqs)
                scheduled.append(ScheduledSequenceGroup(g, 1))
            state = (key, metadata_list, per_group_seqs, scheduled)
            self._fast_state = state
        _, metadata_list, per_group_seqs, scheduled = state

        # Worst-case block demand this step; preemption needs the full pass.
        # Two ways append_slots net-consumes one free block per sequence:
        # crossing a block boundary (new block), or a copy-on-write when the
        # block the token lands in is shared (forked best_of groups) —
        # allocate new + decrement the still-shared old block. Count both so
        # the allocator can never raise mid-loop after tables were mutated.
        bs = self.cache_config.block_size
        bm = self.block_manager
        needed = 0
        for seqs in per_group_seqs:
            for s in seqs:
                if (s.get_len() - 1) % bs == 0:
                    needed += 1
                elif len(seqs) > 1 and bm.last_block_shared(s.seq_id):
                    needed += 1
        if needed > self.block_manager.get_num_free_device_blocks():
            return None

        blocks_to_copy: List[Tuple[int, int]] = []
        num_tokens = 0
        for md, seqs in zip(metadata_list, per_group_seqs):
            for s in seqs:
                cows = self.block_manager.append_slots(s)
                if cows:
                    blocks_to_copy.extend(cows)
                if cows or (s.get_len() - 1) % bs == 0:
                    md.block_tables[s.seq_id] = (
                        self.block_manager.get_block_table_ids(s.seq_id)
                    )
                num_tokens += 1
        outputs = SchedulerOutputs(
            scheduled_seq_groups=scheduled,
            num_prefill_groups=0,
            num_batched_tokens=num_tokens,
            blocks_to_swap_in=[],
            blocks_to_swap_out=[],
            blocks_to_copy=blocks_to_copy,
            ignored_seq_groups=[],
            preempted=0,
            running_queue_size=len(self.running),
        )
        return metadata_list, outputs

    def _schedule(self) -> SchedulerOutputs:
        if self.scheduler_config.enable_chunked_prefill:
            return self._schedule_chunked_prefill()
        return self._schedule_default()

    def _make_budget(self) -> SchedulingBudget:
        budget = SchedulingBudget(
            token_budget=self.scheduler_config.max_num_batched_tokens,
            max_num_seqs=self.scheduler_config.max_num_sequences,
        )
        # Running requests count against the sequence budget up front
        # (ref: scheduler.rs:1070-1078).
        for group in self.running:
            budget.add_num_seqs(group.request_id, group.get_max_num_running_seqs())
        return budget

    def _schedule_default(self) -> SchedulerOutputs:
        """Prefill-prioritized; never mixes prefill and decode
        (ref: scheduler.rs:1057-1217)."""
        budget = self._make_budget()

        prefills = _PrefillOutputs()
        running_scheduled = _RunningOutputs()
        swapped_in = _SwappedInOutputs()

        if not self.swapped:
            prefills = self._schedule_prefills(budget, enable_chunking=False)

        if not prefills.seq_groups:
            running_scheduled = self._schedule_running(
                budget, enable_chunking=False
            )
            # Only swap in if nothing got kicked out this step
            # (ref: scheduler.rs:1100-1110; also keeps the swap-in/out
            # exclusivity invariant).
            if not running_scheduled.preempted and not running_scheduled.swapped_out:
                swapped_in = self._schedule_swapped(budget)

        assert budget.num_batched_tokens <= (
            self.scheduler_config.max_num_batched_tokens
        )
        assert budget.num_curr_seqs <= self.scheduler_config.max_num_sequences

        self.waiting.extendleft(reversed(running_scheduled.preempted))
        self.running.extend(s.seq_group for s in prefills.seq_groups)
        self.running.extend(s.seq_group for s in swapped_in.decode_seq_groups)
        self.swapped.extend(running_scheduled.swapped_out)

        scheduled = (
            prefills.seq_groups
            + running_scheduled.decode_seq_groups
            + swapped_in.decode_seq_groups
        )
        return SchedulerOutputs(
            scheduled_seq_groups=scheduled,
            num_prefill_groups=len(prefills.seq_groups),
            num_batched_tokens=budget.num_batched_tokens,
            blocks_to_swap_in=swapped_in.blocks_to_swap_in,
            blocks_to_swap_out=running_scheduled.blocks_to_swap_out,
            blocks_to_copy=running_scheduled.blocks_to_copy
            + swapped_in.blocks_to_copy,
            ignored_seq_groups=prefills.ignored_seq_groups
            + swapped_in.infeasible_seq_groups,
            preempted=len(running_scheduled.preempted)
            + len(running_scheduled.swapped_out),
            running_queue_size=len(self.running),
        )

    def _schedule_chunked_prefill(self) -> SchedulerOutputs:
        """Decode-first with chunked prefills filling leftover budget
        (ref: scheduler.rs:1257-1379)."""
        budget = self._make_budget()

        running_scheduled = self._schedule_running(budget, enable_chunking=True)
        swapped_in = _SwappedInOutputs()
        if not running_scheduled.preempted and not running_scheduled.swapped_out:
            swapped_in = self._schedule_swapped(budget)

        prefills = self._schedule_prefills(budget, enable_chunking=True)

        assert budget.num_batched_tokens <= (
            self.scheduler_config.max_num_batched_tokens
        )
        assert budget.num_curr_seqs <= self.scheduler_config.max_num_sequences

        self.waiting.extendleft(reversed(running_scheduled.preempted))
        self.running.extend(s.seq_group for s in prefills.seq_groups)
        self.running.extend(s.seq_group for s in swapped_in.decode_seq_groups)
        self.running.extend(s.seq_group for s in swapped_in.prefill_seq_groups)
        self.swapped.extend(running_scheduled.swapped_out)

        # Batch layout contract: prefill groups first, then decodes
        # (ref: worker.rs:373, flash_attention.rs:156-174).
        scheduled = (
            prefills.seq_groups
            + running_scheduled.prefill_seq_groups
            + swapped_in.prefill_seq_groups
            + running_scheduled.decode_seq_groups
            + swapped_in.decode_seq_groups
        )
        num_prefill_groups = (
            len(prefills.seq_groups)
            + len(running_scheduled.prefill_seq_groups)
            + len(swapped_in.prefill_seq_groups)
        )
        return SchedulerOutputs(
            scheduled_seq_groups=scheduled,
            num_prefill_groups=num_prefill_groups,
            num_batched_tokens=budget.num_batched_tokens,
            blocks_to_swap_in=swapped_in.blocks_to_swap_in,
            blocks_to_swap_out=running_scheduled.blocks_to_swap_out,
            blocks_to_copy=running_scheduled.blocks_to_copy
            + swapped_in.blocks_to_copy,
            ignored_seq_groups=prefills.ignored_seq_groups
            + swapped_in.infeasible_seq_groups,
            preempted=len(running_scheduled.preempted)
            + len(running_scheduled.swapped_out),
            running_queue_size=len(self.running),
        )

    # ---------------------------------------------------------------- prefills
    def _get_prompt_limit(self, enable_chunking: bool) -> int:
        if enable_chunking:
            return self.scheduler_config.max_model_len
        return min(
            self.scheduler_config.max_model_len,
            self.scheduler_config.max_num_batched_tokens,
        )

    def _schedule_prefills(
        self, budget: SchedulingBudget, enable_chunking: bool
    ) -> _PrefillOutputs:
        """Admit waiting prompts while budget + blocks allow
        (ref: scheduler.rs:897-1040)."""
        out = _PrefillOutputs()
        now = time.monotonic()
        prompt_limit = self._get_prompt_limit(enable_chunking)

        while self.waiting and self._passed_delay(now):
            group = self.waiting[0]
            waiting_seqs = group.get_seqs(SequenceStatus.WAITING)
            # best_of groups carry several identical prompt candidates; they
            # share one block table (allocate() refcounts it) and their
            # identical prefill writes are idempotent on the shared slots.
            num_new_tokens = sum(
                s.get_num_new_tokens() for s in waiting_seqs
            )

            # Over-long prompts are ignored, not errored
            # (ref: scheduler.rs:957-970).
            if num_new_tokens > prompt_limit:
                logger.warning(
                    "prompt of %d tokens exceeds limit %d — ignoring request %s",
                    num_new_tokens,
                    prompt_limit,
                    group.request_id,
                )
                for seq in waiting_seqs:
                    seq.status = SequenceStatus.FINISHED_IGNORED
                out.ignored_seq_groups.append(group)
                self.waiting.popleft()
                continue

            can_alloc = self.block_manager.can_allocate(group)
            if can_alloc == AllocationStatus.LATER:
                break
            if can_alloc == AllocationStatus.NEVER:
                logger.warning(
                    "prompt of request %s can never fit in the KV cache — ignoring",
                    group.request_id,
                )
                for seq in waiting_seqs:
                    seq.status = SequenceStatus.FINISHED_IGNORED
                out.ignored_seq_groups.append(group)
                self.waiting.popleft()
                continue

            if enable_chunking:
                if len(waiting_seqs) == 1:
                    num_new_tokens = min(
                        num_new_tokens, budget.remaining_token_budget()
                    )
                else:
                    # Lockstep per-candidate chunk (see _get_num_new_tokens).
                    per = min(
                        waiting_seqs[0].get_num_new_tokens(),
                        budget.remaining_token_budget() // len(waiting_seqs),
                    )
                    num_new_tokens = per * len(waiting_seqs)

            num_new_seqs = group.get_max_num_running_seqs()
            if num_new_tokens <= 0 or not budget.can_schedule(
                num_new_tokens=num_new_tokens, num_new_seqs=num_new_seqs
            ):
                if (
                    num_new_tokens <= 0
                    and budget.num_batched_tokens == 0
                    and enable_chunking
                ):
                    # Even an empty step cannot fit one token per candidate
                    # (best_of > max_num_batched_tokens): reject instead of
                    # spinning on the queue head forever.
                    logger.warning(
                        "request %s needs more per-step tokens than "
                        "max_num_batched_tokens allows — ignoring",
                        group.request_id,
                    )
                    for seq in waiting_seqs:
                        seq.status = SequenceStatus.FINISHED_IGNORED
                    out.ignored_seq_groups.append(group)
                    self.waiting.popleft()
                    continue
                break

            self.waiting.popleft()
            self._allocate_and_set_running(group)
            # Prefix-cache hits discovered during allocation advance
            # num_computed_tokens — re-derive the chunk so cached prompt
            # tokens are never re-scheduled (the budget check above used the
            # conservative pre-allocation count).
            running_seqs = group.get_seqs(SequenceStatus.RUNNING)
            num_new_tokens = sum(
                s.get_num_new_tokens() for s in running_seqs
            )
            if enable_chunking:
                if len(running_seqs) == 1:
                    num_new_tokens = min(
                        num_new_tokens, budget.remaining_token_budget()
                    )
                else:
                    per = min(
                        running_seqs[0].get_num_new_tokens(),
                        budget.remaining_token_budget() // len(running_seqs),
                    )
                    num_new_tokens = per * len(running_seqs)
            out.seq_groups.append(
                ScheduledSequenceGroup(
                    seq_group=group, token_chunk_size=num_new_tokens
                )
            )
            budget.add_num_batched_tokens(group.request_id, num_new_tokens)
            budget.add_num_seqs(group.request_id, num_new_seqs)

        if out.seq_groups:
            self.prev_prompt = True
        return out

    def _passed_delay(self, now: float) -> bool:
        """Delay-factor heuristic letting the waiting queue fill
        (ref: scheduler.rs:2077-2097)."""
        if self.prev_prompt:
            self.last_prompt_latency = now - self.prev_time
        self.prev_time, self.prev_prompt = now, False
        if self.scheduler_config.delay_factor > 0 and self.waiting:
            earliest = min(g.metrics.arrival_time for g in self.waiting)
            return (
                now - earliest
                > self.scheduler_config.delay_factor * self.last_prompt_latency
            ) or not self.running
        return True

    def _allocate_and_set_running(self, group: SequenceGroup) -> None:
        """(ref: scheduler.rs:995)."""
        self.block_manager.allocate(group)
        for seq in group.get_seqs(SequenceStatus.WAITING):
            seq.status = SequenceStatus.RUNNING

    # ----------------------------------------------------------------- running
    def _schedule_running(
        self, budget: SchedulingBudget, enable_chunking: bool
    ) -> _RunningOutputs:
        """Keep running groups running; preempt from the back when blocks run
        out (ref: scheduler.rs:612-770)."""
        out = _RunningOutputs()
        now = time.monotonic()
        running_queue = self.policy.sort_by_priority(now, self.running)
        new_running: Deque[SequenceGroup] = deque()

        while running_queue:
            group = running_queue.popleft()
            num_running_tokens = self._get_num_new_tokens(
                group, SequenceStatus.RUNNING, enable_chunking, budget
            )
            if num_running_tokens == 0:
                # Token budget exhausted; keep the group running untouched.
                new_running.append(group)
                new_running.extend(running_queue)
                running_queue.clear()
                break

            # Speculative drafts ride the decode step as extra tokens
            # (clamped to the remaining budget) + lookahead KV slots.
            group._spec_tokens = None
            num_spec = 0
            if self.spec_proposer is not None and not group.is_prefill():
                from ..engine.spec_decode import eligible_group

                if eligible_group(group):
                    seq = group.get_seqs(SequenceStatus.RUNNING)[0]
                    drafts = self.spec_proposer.propose(
                        seq.sequence_data.get_token_ids(),
                        # Clamp to the step budget AND the model length so
                        # draft positions never exceed max_model_len.
                        max_len=min(
                            budget.remaining_token_budget()
                            - num_running_tokens,
                            self.scheduler_config.max_model_len
                            - seq.get_len(),
                        ),
                    )
                    if drafts:
                        group._spec_tokens = drafts
                        num_spec = len(drafts)
                        num_running_tokens += num_spec

            scheduled_this_group = True
            while not self.block_manager.can_append_slots(group, num_spec):
                budget.subtract_num_batched_tokens(
                    group.request_id, num_running_tokens
                )
                if running_queue:
                    # Preempt the lowest-priority group (back of queue).
                    victim = running_queue.pop()
                    budget.subtract_num_seqs(
                        victim.request_id, victim.get_max_num_running_seqs()
                    )
                    mode = self._preempt(victim, out.blocks_to_swap_out)
                    if mode == PreemptionMode.RECOMPUTE:
                        out.preempted.append(victim)
                    else:
                        out.swapped_out.append(victim)
                else:
                    # No victims left: preempt the group itself.
                    budget.subtract_num_seqs(
                        group.request_id, group.get_max_num_running_seqs()
                    )
                    mode = self._preempt(group, out.blocks_to_swap_out)
                    if mode == PreemptionMode.RECOMPUTE:
                        out.preempted.append(group)
                    else:
                        out.swapped_out.append(group)
                    scheduled_this_group = False
                    break

            if not scheduled_this_group:
                continue

            self._append_slots(group, out.blocks_to_copy, num_spec)
            new_running.append(group)
            if group.is_prefill():
                # A chunked prefill continuing from the running queue.
                out.prefill_seq_groups.append(
                    ScheduledSequenceGroup(group, num_running_tokens)
                )
            else:
                out.decode_seq_groups.append(ScheduledSequenceGroup(group, 1))
            budget.add_num_batched_tokens(group.request_id, num_running_tokens)

        self.running = new_running
        return out

    # ----------------------------------------------------------------- swapped
    def _schedule_swapped(self, budget: SchedulingBudget) -> _SwappedInOutputs:
        """Swap groups back in when blocks free up (ref: scheduler.rs:773-890)."""
        out = _SwappedInOutputs()
        now = time.monotonic()
        swapped_queue = self.policy.sort_by_priority(now, self.swapped)
        remaining: Deque[SequenceGroup] = deque()

        while swapped_queue:
            group = swapped_queue.popleft()
            can = self.block_manager.can_swap_in(group)
            if can == AllocationStatus.LATER:
                remaining.append(group)
                remaining.extend(swapped_queue)
                swapped_queue.clear()
                break
            if can == AllocationStatus.NEVER:
                # Infeasible swap: the group can never fit again
                # (ref: scheduler.rs infeasible-swap test; SURVEY §4).
                logger.warning(
                    "request %s can never be swapped back in — ignoring",
                    group.request_id,
                )
                for seq in group.get_seqs(SequenceStatus.SWAPPED):
                    seq.status = SequenceStatus.FINISHED_IGNORED
                    self.block_manager.free(seq)
                out.infeasible_seq_groups.append(group)
                continue

            num_new_seqs = group.get_max_num_running_seqs()
            num_new_tokens = self._get_num_new_tokens(
                group,
                SequenceStatus.SWAPPED,
                self.scheduler_config.enable_chunked_prefill,
                budget,
            )
            if num_new_tokens == 0 or not budget.can_schedule(
                num_new_tokens=num_new_tokens, num_new_seqs=num_new_seqs
            ):
                remaining.append(group)
                remaining.extend(swapped_queue)
                swapped_queue.clear()
                break

            out.blocks_to_swap_in.extend(self.block_manager.swap_in(group))
            for seq in group.get_seqs(SequenceStatus.SWAPPED):
                seq.status = SequenceStatus.RUNNING
            self._append_slots(group, out.blocks_to_copy)
            if group.is_prefill():
                out.prefill_seq_groups.append(
                    ScheduledSequenceGroup(group, num_new_tokens)
                )
            else:
                out.decode_seq_groups.append(ScheduledSequenceGroup(group, 1))
            budget.add_num_batched_tokens(group.request_id, num_new_tokens)
            budget.add_num_seqs(group.request_id, num_new_seqs)

        self.swapped = remaining
        return out

    # -------------------------------------------------------------- preemption
    def _preempt(
        self,
        group: SequenceGroup,
        blocks_to_swap_out: List[Tuple[int, int]],
    ) -> PreemptionMode:
        """Recompute single-seq groups, swap multi-seq/beam groups
        (ref: scheduler.rs:1778-1826)."""
        from ..server import metrics

        metrics.PREEMPTIONS.inc()
        if group.get_max_num_running_seqs() == 1:
            mode = PreemptionMode.RECOMPUTE
        else:
            mode = PreemptionMode.SWAP
        if mode == PreemptionMode.SWAP and not self.block_manager.can_swap_out(
            group
        ):
            # Out of host swap space: fall back to recompute if possible,
            # else the group is lost (the reference aborts here).
            if group.num_seqs(SequenceStatus.RUNNING) == 1:
                mode = PreemptionMode.RECOMPUTE
            else:
                logger.error(
                    "cannot swap out request %s — aborting it", group.request_id
                )
                for seq in group.get_seqs(SequenceStatus.RUNNING):
                    seq.status = SequenceStatus.FINISHED_ABORTED
                    self.block_manager.free(seq)
                return PreemptionMode.SWAP

        if mode == PreemptionMode.RECOMPUTE:
            self._preempt_by_recompute(group)
        else:
            self._preempt_by_swap(group, blocks_to_swap_out)
        return mode

    def _preempt_by_recompute(self, group: SequenceGroup) -> None:
        """Free blocks, reset to a fresh prefill, re-queue at the FRONT of
        waiting (ref: scheduler.rs:1128-1132)."""
        seqs = group.get_seqs(SequenceStatus.RUNNING)
        assert len(seqs) == 1
        for seq in seqs:
            seq.status = SequenceStatus.WAITING
            self.block_manager.free(seq)
            seq.reset_state_for_recompute()

    def _preempt_by_swap(
        self,
        group: SequenceGroup,
        blocks_to_swap_out: List[Tuple[int, int]],
    ) -> None:
        blocks_to_swap_out.extend(self.block_manager.swap_out(group))
        for seq in group.get_seqs(SequenceStatus.RUNNING):
            seq.status = SequenceStatus.SWAPPED

    # ------------------------------------------------------------------- helpers
    def _append_slots(
        self,
        group: SequenceGroup,
        blocks_to_copy: List[Tuple[int, int]],
        num_lookahead_slots: int = 0,
    ) -> None:
        for seq in group.get_seqs(SequenceStatus.RUNNING):
            blocks_to_copy.extend(
                self.block_manager.append_slots(seq, num_lookahead_slots)
            )

    def _get_num_new_tokens(
        self,
        group: SequenceGroup,
        status: SequenceStatus,
        enable_chunking: bool,
        budget: SchedulingBudget,
    ) -> int:
        seqs = group.get_seqs(status)
        num = sum(seq.get_num_new_tokens() for seq in seqs)
        if enable_chunking:
            if len(seqs) == 1:
                num = min(num, budget.remaining_token_budget())
            else:
                # Multi-candidate (best_of) groups chunk in LOCKSTEP: every
                # candidate advances by the same per-seq chunk (they share
                # one block table; identical prefill writes are idempotent).
                # Flooring per seq keeps the group schedulable even when the
                # combined prompt copies exceed the step budget — without
                # this a long best_of prompt pins the waiting-queue head
                # forever (admission livelock).
                per = min(
                    seqs[0].get_num_new_tokens(),
                    budget.remaining_token_budget() // len(seqs),
                )
                num = per * len(seqs)
        return num
