"""Continuous-batching engine event loop.

Ref: backends/vllm/src/llm_engine.rs — the ``tokio::select!`` loop over new
requests + model outputs (:96-133), the 100 ms batching delay when idle
(:31,121-124), ``step()`` scheduling + dispatch (:216-245), output processing
(sequence updates, incremental detokenize, stop-string/EOS/length checks,
:326-501), streaming chunks (:404-424) and liveness on errors (:195-200).

Here the loop is asyncio in one process: the worker call runs in a thread
executor so the event loop keeps admitting requests while the device
computes — the analog of the reference's engine-thread/model-thread split.

The PyTorch port's copy of ``atoma_infer_tpu/engine/llm_engine.py`` with its
synchronous, single-cohort path only: async scheduling, pipeline cohorts and
the multi-host lockstep hook are not ported yet (ROADMAP.md, Queue 1).
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
from ..utils.tracing import instrument
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
    ):
        self.scheduler = scheduler
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
        self._stopping = False
        self._consecutive_failures = 0
        # Captured by run(); step() may execute on a worker thread, so all
        # queue/future completions hop through call_soon_threadsafe.
        self._loop: Optional[asyncio.AbstractEventLoop] = None
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
        rest of step)."""
        while True:
            try:
                request_id = self._pending_aborts.get_nowait()
            except queue.Empty:
                return
            group = self.scheduler.abort_sequence_group(request_id)
            if group is not None:
                self._finish_group(group)

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
                self.scheduler.add_sequence_group(group)
                # Batching delay: let more requests arrive (ref :121-124).
                await asyncio.sleep(IDLE_BATCHING_DELAY_S)
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
        return self.scheduler.has_unfinished_seqs()

    def _drain_new_requests(self) -> None:
        while True:
            try:
                group = self._new_requests.get_nowait()
            except asyncio.QueueEmpty:
                return
            if group is not None:
                self.scheduler.add_sequence_group(group)

    # ------------------------------------------------------------------- step
    @instrument("engine.step")
    def step(self) -> List[GenerateRequestOutput]:
        """One engine iteration (ref: llm_engine.rs:216-245)."""
        self._drain_aborts()
        metadata, outputs = self.scheduler.schedule()
        metrics.ENGINE_STEPS.inc()
        metrics.SCHEDULED_TOKENS.inc(outputs.num_batched_tokens)
        metrics.WAITING_SEQS.set(len(self.scheduler.waiting))
        for group in outputs.ignored_seq_groups:
            self._finish_group(group)
        if not metadata and outputs.is_empty():
            return []

        request = ExecuteModelRequest(
            sequence_groups_metadata=metadata,
            blocks_to_swap_in=outputs.blocks_to_swap_in,
            blocks_to_swap_out=outputs.blocks_to_swap_out,
            blocks_to_copy=outputs.blocks_to_copy,
            running_queue_size=outputs.running_queue_size,
        )

        group_outputs = self.worker.execute_model(request)
        finished = self._process_outputs(metadata, group_outputs)
        self.scheduler.remove_finished_sequences()
        metrics.RUNNING_SEQS.set(len(self.scheduler.running))
        return finished

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

            if group.is_finished():
                finished.append(self._finish_group(group))
        return finished

    def _update_sequence(self, group: SequenceGroup, seq: Sequence, seq_out) -> None:
        """Append the token, detokenize, stop checks (ref:
        llm_engine.rs:367-521)."""
        token_id, logprob = seq_out.output_token, seq_out.logprob
        seq.append_token_id(token_id, logprob)
        if seq_out.top_tokens is not None:
            seq.output_logprobs[-1].top_tokens = seq_out.top_tokens
        metrics.GENERATED_TOKENS.inc()
        new_text, finish_reason = self._postprocess_token(group, seq, token_id)
        if seq.is_finished():
            self.scheduler.free_seq(seq)

        queue = self._stream_queues.get(group.request_id)
        if queue is not None:
            self._put_threadsafe(
                queue,
                StreamChunk(
                    request_id=group.request_id,
                    text=new_text,
                    full_text=seq.output_text,
                    token_id=token_id,
                    logprob=logprob,
                    finished=seq.is_finished(),
                    finish_reason=finish_reason,
                ),
            )

    def _postprocess_token(
        self, group: SequenceGroup, seq: Sequence, token_id: int
    ) -> tuple:
        """Detokenize the sequence's newest (appended) token and apply the
        stop checks (ref: llm_engine.rs:367-521); returns
        ``(new_text, finish_reason)`` and sets the sequence's finished
        status/stop_reason."""
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
            else self.detokenizer.decode_sequence_inplace(seq)
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
            output_len = seq.get_output_len()
            total_len = seq.get_len()
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
            tail = self.detokenizer.finalize_sequence(seq)
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
        fut = self._response_futures.pop(group.request_id, None)
        if fut is not None and not fut.done():
            fut.get_loop().call_soon_threadsafe(
                lambda f=fut, r=result: f.done() or f.set_result(r)
            )
        queue = self._stream_queues.pop(group.request_id, None)
        if queue is not None:
            self._put_threadsafe(queue, None)  # stream terminator
        self._groups.pop(group.request_id, None)
        return result

    def _put_threadsafe(self, queue: asyncio.Queue, item) -> None:
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(queue.put_nowait, item)
        else:
            queue.put_nowait(item)
