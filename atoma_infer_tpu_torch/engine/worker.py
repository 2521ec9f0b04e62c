"""Model worker: one step = cache maintenance, forward, last-token gather,
logits and batched sampling on the device.

Counterpart of ``atoma_infer_tpu/engine/worker.py`` (ref:
backends/vllm/src/worker.rs:111-191), run eagerly: the JAX ``jit`` with
donated caches becomes a plain method whose kernels update the per-layer
caches in place, and the JAX step's one compiled program per bucket becomes,
on the card, one CUDA graph per bucket (``engine/cuda_graphs.py``): every
step replays one, prefill, mixed, verify and penalty steps included, and a
tensor-parallel rank's in segments between its collectives. Per
step the host sends ONE packed int32 metadata buffer (the JAX worker's
layout) and receives ONE packed buffer of
sampled tokens and logprob bits, copied into pinned host memory without
blocking; a CUDA event marks when it has landed, and
``PendingStep.complete()`` waits on it. ``dispatch(request, feed=…)`` takes
async scheduling's device-token feed: decode rows read their input token
from the previous, still in-flight step's device output. A speculative
verify step (``engine/spec_decode.py``) samples the [S, K+1] verify rows
with each sequence's parameters, and ``PendingStep.complete()`` accepts
each drafted sequence's longest run of drafts the model agrees with, plus
the token after it (greedy acceptance: the output is the greedy one without
speculation).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import CacheConfig, SchedulerConfig
from ..ops.attention import AttentionMetadata
from ..sequence import ExecuteModelRequest, SequenceGroupOutput, SequenceOutput
from ..server import metrics
from ..utils.tracing import instrument, span
from .cache_engine import CacheEngine
from .cuda_graphs import StepGraphs, page_capacity, step_graph_key, token_capacity
from .input_prep import ModelInput, bucket, prepare_model_input
from .sampler import PENALTY_WINDOW, SamplingTensors, gumbel_noise, sample

logger = logging.getLogger(__name__)


def _pack_outputs(tokens: torch.Tensor, logprobs: torch.Tensor) -> torch.Tensor:
    """Fuse the step's tokens [S] and f32 logprobs [S] into ONE int32
    buffer (logprob bits reinterpreted) so the host pays one device→host
    copy per step."""
    return torch.cat(
        [tokens.to(torch.int32).reshape(-1), logprobs.float().reshape(-1).view(torch.int32)]
    )


def _to_host(t: torch.Tensor):
    """Start copying ``t`` to the host: returns (host tensor, event). On
    CUDA the copy is non-blocking into PINNED memory (a pageable target
    would make it synchronous) and the event marks its completion; on the
    CPU it is the tensor itself and no event. Each call allocates its own
    pinned buffer, owned by one ``PendingStep`` until its ``complete()``:
    with async scheduling two steps are in flight, and neither's buffer is
    reused while the other's copy may still land in it."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    # The copy runs on the stream of t's device, which need not be the
    # current device's (a pipeline's last stage).
    event.record(torch.cuda.current_stream(t.device))
    return host, event


class PendingStep:
    """A dispatched-but-unfetched model step.

    Holds the packed token/logprob buffer's host copy, in flight, plus what
    is needed to package the outputs. ``complete()`` waits for the copy
    (never read the pinned buffer before the event: it may be stale) and
    builds the per-group outputs.
    """

    def __init__(self, metadata, tokens: torch.Tensor, packed: torch.Tensor, top_out, t0: float,
                 spec_draft: Optional[np.ndarray] = None, spec_k: Optional[np.ndarray] = None):
        self._metadata = metadata
        self._tokens = tokens          # device tensor, kept for the feed
        self._shape = tuple(tokens.shape)
        # (host tensor, event) for the packed buffer, then top-n ids/logprobs.
        self._copies = [_to_host(t) for t in (packed, *(top_out or ()))]
        self._t0 = t0
        self._spec_draft = spec_draft  # [S, K] host drafts (−1 pad), verify steps only
        self._spec_k = spec_k          # [S] draft counts, verify steps only

    @property
    def tokens_device(self) -> torch.Tensor:
        """The sampled tokens on the device ([S] int32): async scheduling's
        feed for the NEXT dispatched step. A verify step ([S, K+1]) runs
        synchronously and feeds no step."""
        return self._tokens

    def complete(self) -> Dict[str, SequenceGroupOutput]:
        with span("worker.fetch"):
            for _, event in self._copies:
                if event is not None:
                    event.synchronize()
            packed_np, *top_np = [host.numpy() for host, _ in self._copies]
            top_ids_np, top_lps_np = top_np if top_np else (None, None)
        n = packed_np.shape[0] // 2
        tokens_np = packed_np[:n].reshape(self._shape)
        logprobs_np = packed_np[n:].view(np.float32).reshape(self._shape)
        spec = self._spec_k is not None  # the [S, K+1] layout this step
        if spec and top_ids_np is not None:
            # Verify layout [S, K+1, n]: row 0 is the distribution of the
            # token every sequence appends.
            top_ids_np, top_lps_np = top_ids_np[:, 0], top_lps_np[:, 0]
        elapsed = time.monotonic() - self._t0

        # Package per-group outputs (ref: model_executor.rs:339-354).
        outputs: Dict[str, SequenceGroupOutput] = {}
        proposed = accepted = 0
        i = 0
        for meta in self._metadata:
            seq_outputs: Dict[int, SequenceOutput] = {}
            advance = None
            for seq_id in meta.seq_data:
                top_tokens = None
                if top_ids_np is not None and meta.top_n_tokens > 0:
                    k = min(meta.top_n_tokens, top_ids_np.shape[1])
                    top_tokens = [
                        (int(top_ids_np[i, j]), float(top_lps_np[i, j]))
                        for j in range(k)
                    ]
                extra = None
                if spec:
                    token, logprob = int(tokens_np[i, 0]), float(logprobs_np[i, 0])
                    k_i = int(self._spec_k[i])
                    if k_i:
                        # Greedy acceptance: the model's token at draft
                        # position j must equal draft j; the first mismatch
                        # ends the run, and the model's token there is the
                        # bonus (exactly the greedy output without drafts).
                        m = 0
                        while m < k_i and tokens_np[i, m] == self._spec_draft[i, m]:
                            m += 1
                        extra = [(int(tokens_np[i, j]), float(logprobs_np[i, j]))
                                 for j in range(1, m + 1)]
                        proposed += k_i
                        accepted += m
                        advance = 1 + m
                else:
                    token, logprob = int(tokens_np[i]), float(logprobs_np[i])
                seq_outputs[seq_id] = SequenceOutput(
                    parent_seq_id=seq_id,
                    output_token=token,
                    logprob=logprob,
                    is_new_token=meta.do_sample,
                    top_tokens=top_tokens,
                    extra_tokens=extra or None,
                )
                i += 1
            outputs[meta.request_id] = SequenceGroupOutput(
                outputs=seq_outputs, time_to_generate=elapsed, num_computed_advance=advance
            )
        if proposed:
            metrics.SPEC_PROPOSED.inc(proposed)
            metrics.SPEC_ACCEPTED.inc(accepted)
        return outputs


class ModelWorker:
    """Executes scheduled batches against the model + paged KV cache."""

    def __init__(
        self,
        model,                  # models.llama.Llama-compatible
        params,
        cache_engine: CacheEngine,
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
        cuda_graphs: bool = True,
        step_graphs: Optional[type] = None,
    ):
        self.model = model
        self.params = params
        self.cache_engine = cache_engine
        self.scheduler_config = scheduler_config
        self.cache_config = cache_config
        self.device = cache_engine.device
        self.max_pages_per_seq = max(
            1, -(-scheduler_config.max_model_len // cache_config.block_size)
        )
        # (signature, SamplingTensors, device tensors): steady decode
        # reschedules the same batch every step, so the per-sequence
        # sampling parameters (and their transfer) are reused until the
        # batch changes. Penalty batches never cache (recent_tokens moves).
        self._sampling_cache = None
        # Changes whenever the sampling tensors are rebuilt: a graph replay
        # copies them in only then.
        self._sampling_version = 0
        max_rows = bucket(scheduler_config.max_num_sequences)
        # The null feed: async decode with nothing in flight reads no
        # previous token, but keeps the key of steady async decode.
        self._null_feed = torch.zeros(max_rows, dtype=torch.int32, device=self.device)
        # Every step on the card replays a CUDA graph, a tensor-parallel
        # rank's in segments between its collectives; the CUDA graph API has
        # no CPU counterpart, so a CPU worker steps eagerly unless it is
        # given ``step_graphs``, a ``StepGraphs`` class of its own (a test's
        # graphs that replay by recomputing). A pipelined worker keeps a
        # graph set a stage instead (``engine/pp_worker.py``).
        graphs_cls = graphs_class(self.device, step_graphs) if cuda_graphs else None
        self.graphs = None if graphs_cls is None else graphs_cls(
            max_rows,
            page_capacity(scheduler_config.max_model_len, cache_config.block_size),
            token_capacity(scheduler_config.max_num_batched_tokens),
            scheduler_config.num_speculative_tokens,
            group=getattr(model, "group", None),
        )

    # ------------------------------------------------------------------ step
    def _unpack(self, packed: torch.Tensor, prev_tokens: Optional[torch.Tensor], *, T: int,
                S: int, P: int, decode_only: bool, max_q_len: int, spec_width: int = 0):
        """The step's inputs from the packed int32 metadata on the device →
        (token ids [T], positions [T], attention metadata, selected rows).
        With ``prev_tokens`` (async scheduling's feed) rows continuing a
        sequence sampled by the previous, still in-flight step read their
        input token from its device output (the host holds a placeholder),
        so the two steps chain without a host round trip."""
        off = 0

        def take(n):
            nonlocal off
            part = packed[off: off + n]
            off += n
            return part

        token_ids = take(T)
        positions = take(T)
        slot_mapping = take(T)
        block_tables = take(S * P).reshape(S, P)
        seq_lens = take(S)
        query_start_loc = take(S + 1)
        take(S)  # per-sequence sampling steps (used on the host for the noise)
        num_seqs = take(1)
        selected = take(S * spec_width if spec_width else S)
        if prev_tokens is not None:
            prev_map = take(T)
            gathered = prev_tokens[prev_map.clamp(0, prev_tokens.shape[0] - 1).long()]
            token_ids = torch.where(prev_map >= 0, gathered, token_ids)
        attn_meta = AttentionMetadata(
            slot_mapping=slot_mapping,
            block_tables=block_tables,
            seq_lens=seq_lens,
            query_start_loc=query_start_loc,
            num_seqs=num_seqs,
            block_size=self.cache_config.block_size,
            decode_only=decode_only,
            max_q_len=max_q_len,
        )
        return token_ids, positions, attn_meta, selected

    def _tail(self, model, params, hidden: torch.Tensor, selected: torch.Tensor,
              sampling: dict, gumbel: Optional[torch.Tensor], *, S: int,
              needs_penalties: bool, needs_typical: bool, top_n: int, spec_width: int = 0):
        """Last-token rows, logits and sampling → (tokens, logprobs, packed
        outputs, top-n). Only the selected rows reach the LM head (ref:
        llama.rs:474-477); on a verify step every verify row, sampled with
        its sequence's parameters and noise (a drafted sequence is greedy;
        an undrafted one's row 0 draws the noise of a step without drafts)."""
        sel = hidden[selected.long()]
        logits = model.compute_logits(params, sel)  # [rows, V] f32
        if spec_width:
            sampling = {name: t.repeat_interleave(spec_width, dim=0)
                        for name, t in sampling.items()}
            if gumbel is not None:
                gumbel = gumbel.repeat_interleave(spec_width, dim=0)
        tokens, logprobs, top_out = sample(
            logits,
            temperature=sampling["temperature"],
            top_k=sampling["top_k"],
            top_p=sampling["top_p"],
            typical_p=sampling["typical_p"],
            do_sample=sampling["do_sample"],
            repetition_penalty=sampling["repetition_penalty"],
            frequency_penalty=sampling["frequency_penalty"],
            recent_tokens=sampling["recent_tokens"],
            gumbel=gumbel,
            needs_penalties=needs_penalties,
            needs_typical=needs_typical,
            top_n=top_n,
        )
        if spec_width:
            tokens = tokens.reshape(S, spec_width)
            logprobs = logprobs.reshape(S, spec_width)
            if top_out is not None:
                top_out = tuple(t.reshape(S, spec_width, -1) for t in top_out)
        return tokens, logprobs, _pack_outputs(tokens, logprobs), top_out

    @torch.inference_mode()
    def _step(
        self,
        packed: torch.Tensor,   # [N] int32 on the device — all step metadata
        sampling: dict,         # per-row sampling tensors on the device
        gumbel: Optional[torch.Tensor],
        prev_tokens: Optional[torch.Tensor],  # [≥ S_prev] int32: the feed
        *,
        T: int,
        S: int,
        P: int,
        decode_only: bool,
        max_q_len: int,
        needs_penalties: bool,
        needs_typical: bool,
        top_n: int,
        spec_width: int = 0,
    ):
        """Forward + logits + sampling for one bucketed batch →
        (tokens, logprobs, packed outputs, top-n). The caches in
        ``self.cache_engine.kv_cache`` (and an int8 cache's scales) are
        updated in place. ``spec_width`` is K+1 on a verify step, whose
        packed metadata carries the [S, K+1] verify rows in place of the
        [S] last-token rows; tokens, logprobs and top-n come back
        [S, K+1, …]."""
        token_ids, positions, attn_meta, selected = self._unpack(
            packed, prev_tokens, T=T, S=S, P=P, decode_only=decode_only, max_q_len=max_q_len,
            spec_width=spec_width)
        hidden = self.model.forward(
            self.params, token_ids, positions, self.cache_engine.kv_cache, attn_meta,
            kv_scales=self.cache_engine.kv_scales,
        )
        return self._tail(self.model, self.params, hidden, selected, sampling, gumbel, S=S,
                          needs_penalties=needs_penalties, needs_typical=needs_typical,
                          top_n=top_n, spec_width=spec_width)

    # ---------------------------------------------------------------- public
    @instrument("worker.execute_model")
    def execute_model(self, request: ExecuteModelRequest) -> Dict[str, SequenceGroupOutput]:
        """One engine step (ref: worker.rs:111-191): swap/copy cache blocks,
        prepare inputs, forward+sample, package outputs per group."""
        pending = self.dispatch(request)
        return pending.complete() if pending is not None else {}

    @instrument("worker.dispatch")
    def dispatch(self, request: ExecuteModelRequest, feed=None) -> Optional[PendingStep]:
        """Enqueue one step on the device without waiting for its results;
        ``PendingStep.complete()`` waits for the sampled tokens.
        Cache-maintenance swaps/copies run first, in the reference's order
        (worker.rs:111-160).

        ``feed`` — async scheduling's device-token feed: a
        ``(prev_tokens_device, {seq_id: prev_row})`` pair from the still
        in-flight previous step. Decode rows of those sequences read their
        input token from ``prev_tokens_device`` instead of the host
        placeholder. ``(None, {})`` is the null feed: nothing is read, and
        a decode step keeps the key of steady async decode."""
        t0 = time.monotonic()
        self._cache_execute(request)
        if not request.sequence_groups_metadata:
            return None

        with span("worker.input_prep"):
            model_input = prepare_model_input(
                request.sequence_groups_metadata,
                block_size=self.cache_config.block_size,
                max_pages_per_seq=self.max_pages_per_seq,
                sliding_window=self.cache_config.sliding_window,
                num_spec_tokens=self.scheduler_config.num_speculative_tokens,
            )
        with span("worker.sampling_build"):
            sampling, sampling_arrays, sample_steps = self._sampling_inputs(
                request, model_input
            )
        prev = None
        if feed is not None:
            prev_tokens, rows_by_seq = feed
            prev_map = feed_map(model_input, rows_by_seq)
            # A prefill wave with nothing to override runs as a no-feed
            # step (the JAX worker forks no feed program for it).
            if (prev_map >= 0).any() or model_input.num_prefills == 0:
                if prev_tokens is None:
                    # Null feed: the map is all −1, so the values are never
                    # read.
                    prev_tokens = self._null_feed
                prev = (prev_tokens, prev_map)
        with span("worker.invoke"):
            tokens, logprobs, packed, top_out = self._invoke(
                model_input, sampling_arrays, sample_steps, sampling, prev
            )
        return PendingStep(request.sequence_groups_metadata, tokens, packed, top_out, t0,
                           spec_draft=model_input.spec_draft, spec_k=model_input.spec_k)

    def _cache_execute(self, request: ExecuteModelRequest) -> None:
        """The step's swaps and copy-on-write copies, before its inputs."""
        self.cache_engine.execute(
            request.blocks_to_swap_in, request.blocks_to_swap_out, request.blocks_to_copy
        )

    def _sampling_inputs(self, request: ExecuteModelRequest, model_input: ModelInput):
        """(SamplingTensors, device tensors, per-row step counts) for the
        batch, reusing the previous step's while the batch is unchanged."""
        S = model_input.seq_lens.shape[0]
        metas = request.sequence_groups_metadata
        # Same groups, same seq counts, same flags at the same bucket →
        # identical sampling tensors (parameters are fixed at admission;
        # best_of candidate seeds derive from the group's seed).
        sig = (
            S,
            tuple(
                (m.request_id, len(m.seq_data), m.top_n_tokens, m.do_sample)
                for m in metas
            ),
        )
        # PRNG step: each sequence's own output length, so sampling replays
        # identically across preemption/swap reschedules.
        sample_steps = np.zeros(S, dtype=np.int32)
        i = 0
        for meta in metas:
            for seq_data in meta.seq_data.values():
                sample_steps[i] = seq_data.get_output_len()
                i += 1
        cached = self._sampling_cache
        if cached is not None and cached[0] == sig and not cached[1].needs_penalties:
            return cached[1], cached[2], sample_steps

        params_list: List = []
        recent: List[List[int]] = []
        top_n_list: List[int] = []
        for meta in metas:
            for idx, seq_data in enumerate(meta.seq_data.values()):
                p = meta.next_token_chooser_params
                if idx > 0:
                    # Distinct sampling streams per best_of candidate.
                    p = dataclasses.replace(p, seed=p.seed + idx)
                params_list.append(p)
                recent.append(seq_data.get_token_ids()[-PENALTY_WINDOW:])
                top_n_list.append(meta.top_n_tokens)
        sampling = SamplingTensors.build(params_list, recent, S, top_n_list)
        with span("worker.transfers"):
            arrays = sampling.to_device(self.device, model_input.sample_mask)
        self._sampling_cache = (sig, sampling, arrays)
        self._sampling_version += 1
        return sampling, arrays, sample_steps

    @staticmethod
    def _pack_metadata(model_input: ModelInput, sample_steps, prev_map=None) -> torch.Tensor:
        """The step's metadata as ONE host int32 buffer (the JAX worker's
        layout; ``prev_map`` last, with the feed)."""
        spec_rows = model_input.spec_rows
        parts = [
            model_input.token_ids,
            model_input.positions,
            model_input.slot_mapping,
            model_input.block_tables.ravel(),
            model_input.seq_lens,
            model_input.query_start_loc,
            np.asarray(sample_steps, dtype=np.int32),
            np.asarray([model_input.num_seqs], dtype=np.int32),
            model_input.selected_token_indices if spec_rows is None else spec_rows.ravel(),
        ]
        if prev_map is not None:
            parts.append(prev_map)
        return torch.from_numpy(np.concatenate(parts).astype(np.int32))

    @staticmethod
    def _send(host: torch.Tensor, device: torch.device) -> torch.Tensor:
        """The packed metadata on ``device``: one host→device copy, from
        pinned memory without blocking on CUDA."""
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host

    def _noise(self, model_input: ModelInput, sampling, sample_steps, device):
        """The sampled rows' Gumbel noise on ``device``, or None when no row
        samples."""
        if not sampling.needs_sampling:
            return None
        rows = np.nonzero(sampling.do_sample & model_input.sample_mask)[0]
        return gumbel_noise(sampling.seeds, sample_steps, rows,
                            self.model.config.vocab_size, device)

    def _invoke(self, model_input: ModelInput, sampling_arrays, sample_steps, sampling,
                prev=None):
        """Send the packed metadata (one host→device copy, from pinned
        memory on CUDA), run the step — a graph replay of its key on the
        card — and return device (tokens, logprobs, packed outputs,
        top-n)."""
        T = model_input.token_ids.shape[0]
        S, P = model_input.block_tables.shape
        spec_rows = model_input.spec_rows
        spec_width = 0 if spec_rows is None else spec_rows.shape[1]
        prev_tokens = None
        with span("worker.meta_transfer"):
            prev_map = None
            if prev is not None:
                prev_tokens, prev_map = prev
            packed = self._send(self._pack_metadata(model_input, sample_steps, prev_map),
                                self.device)
        gumbel = self._noise(model_input, sampling, sample_steps, self.device)

        def step(packed, sampling_arrays, gumbel, prev_tokens):
            return self._step(
                packed,
                sampling_arrays,
                gumbel,
                prev_tokens,
                T=T,
                S=S,
                P=P,
                decode_only=model_input.decode_only,
                max_q_len=model_input.max_q_len,
                needs_penalties=sampling.needs_penalties,
                needs_typical=sampling.needs_typical,
                top_n=sampling.top_n,
                spec_width=spec_width,
            )

        with span("worker.step_call"):
            if self.graphs is None:
                return step(packed, sampling_arrays, gumbel, prev_tokens)
            return self.graphs.run(step_graph_key(model_input, sampling, feed=prev is not None),
                                   step, packed, sampling_arrays, self._sampling_version,
                                   gumbel, prev_tokens)


def graphs_class(device: torch.device, step_graphs: Optional[type] = None) -> Optional[type]:
    """The ``StepGraphs`` class a worker or stage on ``device`` keeps:
    ``step_graphs`` when given, ``StepGraphs`` on the card, else None (the
    CPU steps eagerly)."""
    if step_graphs is not None:
        return step_graphs
    return StepGraphs if device.type == "cuda" else None


def feed_map(model_input: ModelInput, rows_by_seq: Dict[int, int]) -> np.ndarray:
    """``prev_map`` [T] int32: for each token row, the row of the previous
    step's tokens that holds its input token, or −1 (read the host's). Only
    decode rows (one query token, the placeholder) of sequences the previous
    step sampled are mapped (ref worker ``dispatch``)."""
    qsl = model_input.query_start_loc
    prev_map = np.full(model_input.token_ids.shape[0], -1, dtype=np.int32)
    for i, seq_id in enumerate(model_input.seq_ids):
        row = rows_by_seq.get(seq_id)
        if row is not None and qsl[i + 1] - qsl[i] == 1:
            prev_map[qsl[i]] = row
    return prev_map
