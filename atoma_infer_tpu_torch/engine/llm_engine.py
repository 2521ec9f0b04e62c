"""Continuous-batching engine event loop.

Ref: backends/vllm/src/llm_engine.rs — the ``tokio::select!`` loop over new
requests + model outputs (:96-133), the 100 ms batching delay when idle
(:31,121-124), ``step()`` scheduling + dispatch (:216-245), output processing
(sequence updates, incremental detokenize, stop-string/EOS/length checks,
:326-501), streaming chunks (:404-424) and liveness on errors (:195-200).

Here the loop is asyncio in one process: the worker call runs in a thread
executor so the event loop keeps admitting requests while the device
computes — the analog of the reference's engine-thread/model-thread split.

The PyTorch port's copy of ``atoma_infer_tpu/engine/llm_engine.py``, single
cohort: the synchronous path and async scheduling (steps dispatched ahead of
their predecessors' tokens, ``async_depth`` in flight), and speculative
decoding's multi-token advance (a verify step appends each sequence's
accepted drafts and the token after them, and runs synchronously), the
lockstep hook of tensor parallelism (``pre_step``, set by
``engine/multihost.py`` on rank 0), and pipeline parallelism's cohorts: one
scheduler a cohort over one shared block pool, each request in the
least-loaded cohort, one dispatched step a cohort in flight
(``_step_pipelined``), so that the stages of ``engine/pp_worker.py``
overlap across cohorts.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import queue
import time
from typing import Dict, List, Optional

from ..sequence import (
    ExecuteModelRequest,
    RequestMetrics,
    Sequence,
    SequenceGroup,
    SequenceGroupOutput,
    SequenceStatus,
)
from ..server import metrics
from ..utils.tracing import instrument, span
from .detokenizer import Detokenizer
from .worker import ModelWorker

logger = logging.getLogger(__name__)

# Batching delay while idle, letting the waiting queue fill
# (ref: llm_engine.rs:31 STREAMING_DELAY... 100ms batching delay :121-124).
IDLE_BATCHING_DELAY_S = 0.1


@dataclasses.dataclass
class InferenceOutput:
    """One finished sequence (ref: llm_engine.rs ``InferenceOutput``)."""

    seq_id: int
    output_text: str
    token_ids: List[int]
    cumulative_logprob: float
    logprobs: List[float]
    finish_reason: Optional[str]
    stop_reason: Optional[object] = None
    # Per generated token: top-n (token_id, logprob) alternatives, present
    # only when the request asked for top_n_tokens.
    top_logprobs: Optional[List[List[tuple]]] = None


@dataclasses.dataclass
class GenerateRequestOutput:
    """Final response for a request (ref: llm_engine.rs:326-336)."""

    request_id: str
    inputs: str
    prompt_token_ids: List[int]
    outputs: List[InferenceOutput]
    metrics: RequestMetrics


@dataclasses.dataclass
class StreamChunk:
    """One streamed token chunk (ref: llm_engine.rs StreamResponse::Chunk)."""

    request_id: str
    text: str           # newly generated text this step
    full_text: str      # text so far
    token_id: int
    logprob: float
    finished: bool = False
    finish_reason: Optional[str] = None


class LlmEngine:
    """The continuous-batching engine (ref: llm_engine.rs:61-245)."""

    def __init__(
        self,
        scheduler,
        worker: ModelWorker,
        tokenizer,
        eos_token_ids,
        max_model_len: int,
        extra_schedulers=(),
        async_scheduling: bool = False,
        async_depth: int = 2,
    ):
        self.scheduler = scheduler
        # Pipeline parallelism: one scheduler a cohort (all sharing one
        # block manager). A request joins the least-loaded cohort at
        # admission; step() keeps one dispatched step a cohort in flight, so
        # that the pipeline stages overlap across cohorts.
        self.schedulers = [scheduler, *extra_schedulers]
        self._next_cohort = 0
        # In-flight pipelined steps, oldest first: (cohort, metadata, PendingStep).
        self._pending: List[tuple] = []
        self.worker = worker
        self.detokenizer = Detokenizer(tokenizer)
        self.eos_token_ids = set(
            eos_token_ids if isinstance(eos_token_ids, (list, tuple, set))
            else [eos_token_ids]
        )
        self.max_model_len = max_model_len
        # request_id → (group, response future, optional stream queue)
        self._groups: Dict[str, SequenceGroup] = {}
        self._response_futures: Dict[str, asyncio.Future] = {}
        self._stream_queues: Dict[str, asyncio.Queue] = {}
        self._new_requests: asyncio.Queue = asyncio.Queue()
        self._pending_aborts: queue.SimpleQueue = queue.SimpleQueue()
        # Lockstep (pre_step set): admissions and aborts must be applied
        # locally at the exact point they are broadcast, or a request
        # arriving mid-burst is scheduled on followers steps before rank 0
        # and the replicated schedulers diverge. The run loop defers
        # admission to pre_step through this backlog, and _drain_aborts
        # consumes only the abort set pre_step snapshotted and broadcast.
        self._admit_backlog: List[SequenceGroup] = []
        self._abort_snapshot: List[str] = []
        self._stopping = False
        self._patched_tokens = 0
        self._consecutive_failures = 0
        # Captured by run(); step() may execute on a worker thread, so all
        # queue/future completions hop through call_soon_threadsafe.
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # ---- async scheduling ---------------------------------------------
        # Later steps are scheduled and dispatched BEFORE earlier steps'
        # sampled tokens reach the host: the scheduler runs on placeholder
        # bookkeeping (each sampled sequence gets a placeholder token
        # appended, its value patched when its step completes) and each
        # dispatched step reads continuing rows' input tokens from the
        # immediately previous step's device-resident output (the worker's
        # device-token feed). Host work — schedule, input prep, detokenize,
        # stop checks — overlaps device execution instead of serializing
        # with it. ``async_depth`` steps stay in flight: depth 1 detects
        # stop conditions one step late; depth 2 also hides the
        # device→host fetch behind a full host iteration. Cost: a finishing
        # sequence wastes ``depth`` sampled-and-discarded tokens. One cohort
        # only: cohorts overlap their steps instead.
        self._async_scheduling = async_scheduling and not extra_schedulers
        self._async_depth = max(1, async_depth)
        # In-flight steps, oldest first. Each entry:
        # (metadata, PendingStep, rows) with rows mapping
        # seq_id → (group, seq, sampled-row, output-index of placeholder).
        self._async_queue: List[tuple] = []
        # While _complete_pending runs: the finished groups' posts, held
        # until their cohort's remove_finished_sequences().
        self._deferred_posts: Optional[List] = None
    # -------------------------------------------------------------- admission
    def add_request(
        self,
        group: SequenceGroup,
        response_future: Optional[asyncio.Future] = None,
        stream_queue: Optional[asyncio.Queue] = None,
    ) -> None:
        self._groups[group.request_id] = group
        if response_future is not None:
            self._response_futures[group.request_id] = response_future
        if stream_queue is not None:
            self._stream_queues[group.request_id] = stream_queue
            group.stream = True
        if len(self.schedulers) > 1:
            # Cohort: the least-loaded scheduler (ties: the lowest id).
            group.cohort = min(
                range(len(self.schedulers)),
                key=lambda k: self.schedulers[k].get_num_unfinished_seq_groups(),
            )
        self._new_requests.put_nowait(group)

    def abort_request(self, request_id: str) -> bool:
        """Abort API (routed, unlike the reference's unexposed
        ``abort_sequence_group`` — SURVEY.md §3.5).

        Called from the asyncio event-loop thread while ``step()`` may be
        mutating the scheduler on an executor thread, so the scheduler is
        never touched here: the id goes on a thread-safe pending queue that
        ``step()`` drains before scheduling. Returns True if the request is
        currently known to the engine (it will be aborted by the next step).
        """
        if request_id not in self._groups:
            return False
        self._pending_aborts.put(request_id)
        return True

    def _drain_aborts(self) -> None:
        """Apply queued aborts at the top of step() — the only place
        scheduler state is mutated for aborts (single-threaded with the
        rest of step). Under lockstep (pre_step set) only the snapshot
        pre_step broadcast this step is applied; anything newer waits for
        the next step's broadcast so followers abort in the same step."""
        if self.pre_step is not None:
            ids = self._abort_snapshot
            self._abort_snapshot = []
        else:
            ids = []
            while True:
                try:
                    ids.append(self._pending_aborts.get_nowait())
                except queue.Empty:
                    break
        for request_id in ids:
            group = self._groups.get(request_id)
            if group is not None and any(
                sid in rows for _, _, rows in self._async_queue for sid in group.sequences
            ):
                # Resolve the in-flight async steps first so the aborted
                # response carries real tokens, not unpatched placeholders.
                self._complete_async_all()
                self.scheduler.remove_finished_sequences()
            for scheduler in self.schedulers:
                group = scheduler.abort_sequence_group(request_id)
                if group is not None:
                    self._finish_group(group)
                    break

    # ------------------------------------------------------------------- loop
    async def run(self) -> None:
        """Event loop: admit → step while work remains (ref: llm_engine.rs:92-133)."""
        loop = asyncio.get_running_loop()
        self._loop = loop
        while not self._stopping:
            if not self._has_unfinished():
                group = await self._new_requests.get()
                if group is None:  # shutdown sentinel
                    break
                if self.pre_step is None:
                    self._scheduler_for(group).add_sequence_group(group)
                else:
                    # Lockstep: pre_step admits and broadcasts atomically.
                    self._admit_backlog.append(group)
                # Batching delay: let more requests arrive (ref :121-124).
                await asyncio.sleep(IDLE_BATCHING_DELAY_S)
            if self.pre_step is None:
                self._drain_new_requests()
            try:
                await loop.run_in_executor(None, self._step_burst)
                self._consecutive_failures = 0
            except Exception as e:
                # Keep stepping for liveness (ref: llm_engine.rs:195-200) —
                # but a PERSISTENT failure (e.g. a program that can never
                # compile within HBM) would otherwise spin forever with
                # every request hung: after several consecutive failures,
                # fail the outstanding requests and stop.
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.MAX_STEP_FAILURES:
                    logger.error(
                        "engine step failed %d times consecutively; "
                        "failing %d outstanding requests and stopping",
                        self._consecutive_failures,
                        len(self._response_futures),
                    )
                    self._fail_all(e)
                    return
                logger.exception("engine step failed; continuing")
                await asyncio.sleep(0.05)
            # Yield so admissions/streams interleave between steps.
            await asyncio.sleep(0)

    # Consecutive step failures tolerated before the engine declares the
    # error persistent, fails outstanding requests, and stops.
    MAX_STEP_FAILURES = 5

    def _fail_all(self, exc: Exception) -> None:
        self._stopping = True
        for rid, fut in list(self._response_futures.items()):
            if not fut.done():
                fut.get_loop().call_soon_threadsafe(
                    lambda f=fut, e=exc: f.done() or f.set_exception(
                        RuntimeError(f"engine failed persistently: {e}")
                    )
                )
        self._response_futures.clear()
        for queue in self._stream_queues.values():
            self._put_threadsafe(queue, None)
        self._stream_queues.clear()

    # Steps executed per executor hop: the asyncio thread hand-off costs a
    # few ms per hop, which at ~15 ms steps is a ~20% tax. Burst several
    # steps per hop while no new request is waiting to be admitted —
    # admission latency stays ≤ one step because the burst breaks as soon
    # as the (thread-safe to inspect) queue goes non-empty.
    STEP_BURST = 8

    def _step_burst(self) -> None:
        for _ in range(self.STEP_BURST):
            self.step()
            if (
                self._stopping
                or not self._new_requests.empty()
                or not self._has_unfinished()
            ):
                break

    def stop(self) -> None:
        self._stopping = True
        self._new_requests.put_nowait(None)

    def _has_unfinished(self) -> bool:
        return (bool(self._pending) or bool(self._async_queue) or bool(self._admit_backlog)
                or any(s.has_unfinished_seqs() for s in self.schedulers))

    def _scheduler_for(self, group: SequenceGroup):
        """The scheduler a group is admitted to: its cohort's."""
        return self.schedulers[getattr(group, "cohort", 0)]

    def _drain_new_requests(self) -> None:
        while True:
            try:
                group = self._new_requests.get_nowait()
            except asyncio.QueueEmpty:
                return
            if group is not None:
                self._scheduler_for(group).add_sequence_group(group)

    # ------------------------------------------------------------------- step
    # The lockstep hook (engine/multihost.py): rank 0's PrimarySync
    # broadcasts the step's admission delta here, so that every rank's
    # replicated scheduler sees the identical request stream.
    pre_step = None

    @instrument("engine.step")
    def step(self) -> List[GenerateRequestOutput]:
        """One engine iteration (ref: llm_engine.rs:216-245)."""
        if self.pre_step is not None:
            self.pre_step()
        if len(self.schedulers) > 1:
            return self._step_pipelined()
        self._drain_aborts()
        metadata, outputs = self.scheduler.schedule()
        metrics.ENGINE_STEPS.inc()
        metrics.SCHEDULED_TOKENS.inc(outputs.num_batched_tokens)
        metrics.WAITING_SEQS.set(len(self.scheduler.waiting))
        for group in outputs.ignored_seq_groups:
            self._finish_group(group)
        finished: List[GenerateRequestOutput] = []
        if not metadata and outputs.is_empty():
            if self._async_queue:
                finished += self._complete_async_oldest()
                self.scheduler.remove_finished_sequences()
            return finished

        request = ExecuteModelRequest(
            sequence_groups_metadata=metadata,
            blocks_to_swap_in=outputs.blocks_to_swap_in,
            blocks_to_swap_out=outputs.blocks_to_swap_out,
            blocks_to_copy=outputs.blocks_to_copy,
            running_queue_size=outputs.running_queue_size,
        )

        if self._async_scheduling and self._async_eligible(metadata):
            # Async stepping: dispatch this step BEFORE fetching in-flight
            # ones — rows continuing a just-sampled sequence read their
            # input token on the device (worker feed), so the device never
            # waits for a host round trip. Then, with up to ``async_depth``
            # steps in flight, patch the OLDEST step's placeholders
            # (detokenize/stop checks overlap the newer steps' device
            # execution).
            feed = None
            if self._async_queue:
                _, newest, rows = self._async_queue[-1]
                feed = (
                    newest.tokens_device,
                    {sid: row for sid, (_, _, row, _) in rows.items()},
                )
            elif all(not m.is_prompt for m in metadata):
                # Null feed: keeps a post-idle decode step on the same graph
                # key as steady async decode (worker.dispatch).
                feed = (None, {})
            pending = self.worker.dispatch(request, feed=feed)
            if pending is not None:
                rows = self._book_placeholders(metadata)
                self._async_queue.append((metadata, pending, rows))
            while len(self._async_queue) > self._async_depth:
                finished += self._complete_async_oldest()
        else:
            # Synchronous path (penalties, speculative drafts, or a step
            # whose input tokens sit unpatched in an older in-flight step):
            # resolve the in-flight steps first so input prep reads real
            # token ids, then execute. Pure-decode fallbacks ride the null
            # feed so they reuse the steady async decode key.
            finished += self._complete_async_all()
            if (
                self._async_scheduling
                and all(not m.is_prompt for m in metadata)
                and self._async_eligible(metadata)  # queue now empty: only
                # penalties and drafts force False here, and those have
                # keys (or eager steps) of their own
            ):
                pending = self.worker.dispatch(request, feed=(None, {}))
                group_outputs = pending.complete() if pending is not None else {}
            else:
                group_outputs = self.worker.execute_model(request)
            finished += self._process_outputs(metadata, group_outputs)
        self.scheduler.remove_finished_sequences()
        metrics.RUNNING_SEQS.set(len(self.scheduler.running))
        return finished

    # -------------------------------------------------------------- cohorts
    def _step_pipelined(self) -> List[GenerateRequestOutput]:
        """One pipelined iteration: complete the active cohort's previous
        step (its tokens gate its next schedule), then schedule and dispatch
        its next step, leaving the OTHER cohorts' steps in flight — what
        keeps every pipeline stage busy (``engine/pp_worker.py``). The
        rotation is deterministic, so ranks in lockstep step alike."""
        self._drain_aborts()
        k = self._next_cohort
        self._next_cohort = (k + 1) % len(self.schedulers)
        scheduler = self.schedulers[k]

        finished: List[GenerateRequestOutput] = []
        for i, (cohort, _, _) in enumerate(self._pending):
            if cohort == k:
                finished += self._complete_pending(i)
                break

        metadata, outputs = scheduler.schedule()
        metrics.ENGINE_STEPS.inc()
        metrics.SCHEDULED_TOKENS.inc(outputs.num_batched_tokens)
        metrics.WAITING_SEQS.set(sum(len(s.waiting) for s in self.schedulers))
        for group in outputs.ignored_seq_groups:
            self._finish_group(group)
        if metadata or not outputs.is_empty():
            request = ExecuteModelRequest(
                sequence_groups_metadata=metadata,
                blocks_to_swap_in=outputs.blocks_to_swap_in,
                blocks_to_swap_out=outputs.blocks_to_swap_out,
                blocks_to_copy=outputs.blocks_to_copy,
                running_queue_size=outputs.running_queue_size,
            )
            pending = self.worker.dispatch(request)
            if pending is not None:
                self._pending.append((k, metadata, pending))
        elif not scheduler.has_unfinished_seqs() and self._pending:
            # This cohort is idle: drain the oldest in-flight step, so that
            # the other cohorts progress when the rotation stalls.
            finished += self._complete_pending(0)
        metrics.RUNNING_SEQS.set(sum(len(s.running) for s in self.schedulers))
        return finished

    def _complete_pending(self, index: int) -> List[GenerateRequestOutput]:
        cohort, metadata, pending = self._pending.pop(index)
        scheduler = self.schedulers[cohort]
        # The cohorts share one block manager, so the finished sequences'
        # blocks return to the one pool whichever scheduler frees them.
        # A finished group's future resolves only once its cohort has
        # dropped it: an awaiter resumed earlier could add its next request
        # while the group still counts, and add_request would pick that
        # request's cohort from the stale count.
        self._deferred_posts = []
        try:
            finished = self._process_outputs(metadata, pending.complete())
            scheduler.remove_finished_sequences()
        finally:
            posts, self._deferred_posts = self._deferred_posts, None
            for post in posts:
                post()
        return finished

    # ------------------------------------------------------- async scheduling
    _PLACEHOLDER = 0  # patched by position, value never read on host

    def _async_eligible(self, metadata) -> bool:
        """A step can be dispatched ahead of the in-flight one iff nothing in
        it needs the in-flight step's token VALUES on the host: penalties
        read the newest token into ``recent_tokens``, speculative drafts
        are verified from real tokens (and advance by a count known only
        after acceptance), and a (recompute-)prefill's input ids must be
        real. Pure decode — the steady state where host overlap matters —
        always qualifies."""
        older: set = set()
        for _, _, rows in self._async_queue[:-1]:
            older.update(rows)
        newest = self._async_queue[-1][2] if self._async_queue else {}
        for meta in metadata:
            p = meta.next_token_chooser_params
            if p.repetition_penalty != 1.0 or p.frequency_penalty != 0.0:
                return False
            if meta.spec_token_ids:
                return False
            if meta.is_prompt and self._async_queue:
                for seq_id in meta.seq_data:
                    if seq_id in older or seq_id in newest:
                        return False
            elif older:
                # A decode row reads its input token from the device feed
                # only when its last sample came from the NEWEST in-flight
                # step; a token still unpatched in an older in-flight step
                # would be read from the host as a placeholder (depth >1 —
                # e.g. the first decode after a split prefill wave).
                for seq_id in meta.seq_data:
                    if seq_id in older and seq_id not in newest:
                        return False
        return True

    def _book_placeholders(self, metadata) -> Dict[int, tuple]:
        """Advance bookkeeping for a dispatched-but-unfetched step: computed
        token counts move forward and every sampled sequence appends a
        placeholder token (so the next schedule() sees correct lengths and
        block demand). Returns seq_id → (group, seq, row, output-index);
        values are patched when the step completes."""
        rows: Dict[int, tuple] = {}
        row = 0
        for meta in metadata:
            group = self._groups.get(meta.request_id)
            if group is not None:
                group.update_num_computed_tokens(meta.token_chunk_size)
            for seq_id in meta.seq_data:
                r = row
                row += 1
                if group is None or not meta.do_sample:
                    continue
                seq = group.sequences.get(seq_id)
                if seq is None or seq.is_finished():
                    continue
                seq.append_token_id(self._PLACEHOLDER, 0.0)
                out_idx = len(seq.sequence_data.output_token_ids) - 1
                rows[seq_id] = (group, seq, r, out_idx)
        return rows

    def _complete_async_all(self) -> List[GenerateRequestOutput]:
        finished: List[GenerateRequestOutput] = []
        while self._async_queue:
            finished += self._complete_async_oldest()
        return finished

    def _complete_async_oldest(self) -> List[GenerateRequestOutput]:
        """Fetch the oldest in-flight step and patch its placeholder tokens
        with the real values, then run the usual detokenize/stop/stream path
        on them."""
        if not self._async_queue:
            return []
        metadata, pending, placeholders = self._async_queue.pop(0)
        group_outputs = pending.complete()
        finished: List[GenerateRequestOutput] = []
        with span("engine.patch_outputs"):
            now = time.monotonic()
            for meta in metadata:
                group = self._groups.get(meta.request_id)
                if group is None:
                    continue
                out = group_outputs.get(meta.request_id)
                if out is None:
                    continue
                # Computed counts already advanced at dispatch time.
                group.metrics.last_token_time = now
                if not meta.do_sample:
                    continue
                group.maybe_set_first_token_time(now)
                for seq_id, seq_out in out.outputs.items():
                    entry = placeholders.get(seq_id)
                    if entry is None:
                        continue  # finished/aborted after dispatch: discard
                    _, seq, _, out_idx = entry
                    if seq.is_finished():
                        continue
                    self._patch_sequence(group, seq, seq_out, out_idx)
                    self._patched_tokens += 1
                if group.is_finished():
                    finished.append(self._finish_group(group))
            # One locked counter update per step, not per token.
            if self._patched_tokens:
                metrics.GENERATED_TOKENS.inc(self._patched_tokens)
                self._patched_tokens = 0
        return finished

    def _patch_sequence(self, group: SequenceGroup, seq: Sequence, seq_out, out_idx: int):
        """Replace the placeholder at ``out_idx`` with the sampled token,
        then detokenize + stop-check + stream it (the async analog of
        :meth:`_update_sequence` for exactly one token). With async depth >1
        the sequence may carry newer, still-unpatched placeholders past
        ``out_idx``; detokenization and length checks stop at the patched
        token, and if the sequence finishes here the newer placeholders are
        discarded."""
        data = seq.sequence_data
        data.output_token_ids[out_idx] = seq_out.output_token
        data.cumulative_logprob += seq_out.logprob
        lp = seq.output_logprobs[out_idx]
        lp.token_id = seq_out.output_token
        lp.logprob = seq_out.logprob
        lp.top_tokens = seq_out.top_tokens
        new_text, finish_reason = self._postprocess_token(
            group, seq, seq_out.output_token, end=out_idx + 1
        )
        if seq.is_finished():
            # Trailing placeholders from newer in-flight steps are bogus
            # beyond the finish point: truncate, and drop this sequence from
            # the newer steps' patch maps so their tokens are discarded.
            del data.output_token_ids[out_idx + 1:]
            del seq.output_logprobs[out_idx + 1:]
            for _, _, rows in self._async_queue:
                rows.pop(seq.seq_id, None)
            self.scheduler.free_seq(seq)
        queue = self._stream_queues.get(group.request_id)
        if queue is not None:
            self._put_threadsafe(
                queue,
                StreamChunk(
                    request_id=group.request_id,
                    text=new_text,
                    full_text=seq.output_text,
                    token_id=seq_out.output_token,
                    logprob=seq_out.logprob,
                    finished=seq.is_finished(),
                    finish_reason=finish_reason,
                ),
            )

    # ---------------------------------------------------------------- outputs
    @instrument("engine.process_outputs")
    def _process_outputs(
        self,
        metadata_list,
        group_outputs: Dict[str, SequenceGroupOutput],
    ) -> List[GenerateRequestOutput]:
        """Update sequences with sampled tokens; detokenize; stop-check; emit
        stream chunks + finished responses (ref: llm_engine.rs:264-521)."""
        now = time.monotonic()
        finished: List[GenerateRequestOutput] = []
        for meta in metadata_list:
            group = self._groups.get(meta.request_id)
            if group is None:
                # Request of an already-aborted group; drop.
                continue
            out = group_outputs.get(meta.request_id)
            if out is None:
                continue
            # A verify step advances by the tokens acceptance kept, applied
            # AFTER the appends below: the group's update clamps to the
            # sequence's uncomputed count (1 before any append in decode).
            # Other steps advance by the scheduled chunk here, before them.
            spec_advance = out.num_computed_advance
            if spec_advance is None:
                group.update_num_computed_tokens(meta.token_chunk_size)
            group.metrics.last_token_time = now

            if not meta.do_sample:
                continue  # partial chunked prefill: no token this step

            group.maybe_set_first_token_time(now)
            for seq_id, seq_out in out.outputs.items():
                seq = group.sequences.get(seq_id)
                if seq is None or seq.is_finished():
                    continue
                self._update_sequence(group, seq, seq_out)
            if spec_advance is not None:
                group.update_num_computed_tokens(spec_advance)

            if group.is_finished():
                finished.append(self._finish_group(group))
        return finished

    def _update_sequence(self, group: SequenceGroup, seq: Sequence, seq_out) -> None:
        """Append the token(s), detokenize, stop checks (ref:
        llm_engine.rs:367-521). A verify step gives several tokens at once;
        each is appended and stop-checked in order, as if decoded on steps
        of its own, and the first finish drops the rest."""
        texts = []
        finish_reason = None
        for n, (token_id, logprob) in enumerate(seq_out.all_tokens):
            seq.append_token_id(token_id, logprob)
            if n == 0 and seq_out.top_tokens is not None:
                seq.output_logprobs[-1].top_tokens = seq_out.top_tokens
            new_text, finish_reason = self._postprocess_token(group, seq, token_id)
            texts.append(new_text)
            if seq.is_finished():
                break
        metrics.GENERATED_TOKENS.inc(len(texts))
        if seq.is_finished():
            self.scheduler.free_seq(seq)

        queue = self._stream_queues.get(group.request_id)
        if queue is not None:
            self._put_threadsafe(
                queue,
                StreamChunk(
                    request_id=group.request_id,
                    text="".join(texts),
                    full_text=seq.output_text,
                    token_id=token_id,
                    logprob=logprob,
                    finished=seq.is_finished(),
                    finish_reason=finish_reason,
                ),
            )

    def _postprocess_token(
        self, group: SequenceGroup, seq: Sequence, token_id: int, end: Optional[int] = None
    ) -> tuple:
        """Detokenize the sequence's newest token and apply the stop checks
        (ref: llm_engine.rs:367-521); returns ``(new_text, finish_reason)``
        and sets the sequence's finished status/stop_reason. The token must
        already be appended (sync path) or patched in place (async path);
        ``end`` bounds the output tokens considered — with async depth >1
        there may be newer unpatched placeholders past it."""
        stopping = group.stopping_criteria
        # Lazy detokenization: per-token incremental decode is only needed
        # for stop-string matching and streaming. Plain requests skip it
        # entirely (≈1-1.5 ms/step at 256 sequences) — the finish-time
        # finalize below decodes the whole output in one call.
        lazy = not getattr(group, "stream", False) and (
            not stopping.stop_sequences
        )
        new_text = (
            ""
            if lazy
            else self.detokenizer.decode_sequence_inplace(seq, end=end)
        )
        finish_reason: Optional[str] = None

        # Stop strings: truncate at the earliest stop match
        # (ref: llm_engine.rs:438-460). Incremental: only the tail that
        # a match could newly span (new text + longest stop − 1) is
        # searched, not the whole output each token — O(stop_len)/step.
        for stop_str in stopping.stop_sequences:
            search_from = max(
                0,
                len(seq.output_text) - len(new_text) - len(stop_str) + 1,
            )
            idx = seq.output_text.find(stop_str, search_from)
            if idx != -1:
                seq.output_text = seq.output_text[:idx]
                seq.status = SequenceStatus.FINISHED_STOPPED
                seq.stop_reason = stop_str
                finish_reason = "stop_sequence"
                break

        if finish_reason is None:
            output_len = end if end is not None else seq.get_output_len()
            total_len = seq.get_len() - (seq.get_output_len() - output_len)
            if (
                not stopping.ignore_eos_token
                and token_id in self.eos_token_ids
            ):
                seq.status = SequenceStatus.FINISHED_STOPPED
                seq.stop_reason = token_id
                finish_reason = "eos_token"
            elif output_len >= stopping.max_new_tokens:
                seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
                finish_reason = "length"
            elif total_len >= self.max_model_len:
                seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
                finish_reason = "model_length"
        if finish_reason is not None and finish_reason != "stop_sequence":
            # A trailing incomplete UTF-8/byte-fallback fragment will never
            # complete now — flush it (replacement chars), matching what a
            # full re-decode of the finished token list produces. Stop-string
            # finishes skip this: their text was truncated at the match.
            tail = self.detokenizer.finalize_sequence(seq, end=end)
            if tail:
                new_text += tail
        return new_text, finish_reason

    def _finish_group(self, group: SequenceGroup) -> GenerateRequestOutput:
        group.set_finished_time(time.monotonic())
        first = group.get_first_seq()
        # best_of semantics: return the top-n candidates by cumulative
        # logprob (ref: best_of handling, sequence.rs get_max_num_running_seqs
        # + vLLM output selection).
        seqs = sorted(
            group.get_seqs(),
            key=lambda s: s.get_cumulative_logprob(),
            reverse=True,
        )[: getattr(group, "num_return", None) or len(group.sequences)]
        # Lazy detokenization decodes nothing per-token for plain requests;
        # natural finishes flush in _postprocess_token, but aborts reach
        # here with output_text lagging the token ids — catch up now
        # (finalize is a no-op for already-decoded sequences).
        for s in seqs:
            self.detokenizer.finalize_sequence(s)
        result = GenerateRequestOutput(
            request_id=group.request_id,
            inputs=first.prompt,
            prompt_token_ids=list(first.sequence_data.prompt_token_ids),
            outputs=[
                InferenceOutput(
                    seq_id=s.seq_id,
                    output_text=s.output_text,
                    token_ids=list(s.sequence_data.output_token_ids),
                    cumulative_logprob=s.get_cumulative_logprob(),
                    logprobs=[lp.logprob for lp in s.output_logprobs],
                    finish_reason=s.status.finished_reason,
                    stop_reason=s.stop_reason,
                    top_logprobs=(
                        [lp.top_tokens or [] for lp in s.output_logprobs]
                        if getattr(group, "top_n_tokens", 0) > 0
                        else None
                    ),
                )
                for s in seqs
            ],
            metrics=group.metrics,
        )
        # Forget the group BEFORE resolving its future: step() runs on an
        # executor thread, and the loop thread may resume the request's
        # awaiter as soon as the result is scheduled.
        self._groups.pop(group.request_id, None)
        fut = self._response_futures.pop(group.request_id, None)
        if fut is not None and not fut.done():
            self._post(lambda f=fut, r=result: f.get_loop().call_soon_threadsafe(
                lambda: f.done() or f.set_result(r)))
        queue = self._stream_queues.pop(group.request_id, None)
        if queue is not None:
            self._post(lambda q=queue: self._put_threadsafe(q, None))  # stream terminator
        return result

    def _post(self, post) -> None:
        """Run ``post`` (a finished group's future or stream terminator)
        now, or after the cohort's removal when :meth:`_complete_pending`
        defers it."""
        if self._deferred_posts is None:
            post()
        else:
            self._deferred_posts.append(post)

    def _put_threadsafe(self, queue: asyncio.Queue, item) -> None:
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(queue.put_nowait, item)
        else:
            queue.put_nowait(item)
