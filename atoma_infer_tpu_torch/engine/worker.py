"""Model worker: one step = cache maintenance, forward, last-token gather,
logits and batched sampling on the device.

Counterpart of ``atoma_infer_tpu/engine/worker.py`` (ref:
backends/vllm/src/worker.rs:111-191), run eagerly: the JAX ``jit`` with
donated caches becomes a plain method whose kernels update the per-layer
caches in place. Per step the host sends ONE packed int32 metadata buffer
(the JAX worker's layout) and receives ONE packed buffer of sampled tokens
and logprob bits, copied into pinned host memory without blocking; a CUDA
event marks when it has landed, and ``PendingStep.complete()`` waits on it.
Speculative verification and the async-scheduling token feed are not ported
yet (ROADMAP.md, Queue 1).
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
from ..utils.tracing import instrument, span
from .cache_engine import CacheEngine
from .input_prep import ModelInput, prepare_model_input
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
    CPU it is the tensor itself and no event."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class PendingStep:
    """A dispatched-but-unfetched model step.

    Holds the packed token/logprob buffer's host copy, in flight, plus what
    is needed to package the outputs. ``complete()`` waits for the copy
    (never read the pinned buffer before the event: it may be stale) and
    builds the per-group outputs.
    """

    def __init__(self, metadata, tokens: torch.Tensor, packed: torch.Tensor, top_out, t0: float):
        self._metadata = metadata
        self._shape = tuple(tokens.shape)
        # (host tensor, event) for the packed buffer, then top-n ids/logprobs.
        self._copies = [_to_host(t) for t in (packed, *(top_out or ()))]
        self._t0 = t0

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
        elapsed = time.monotonic() - self._t0

        # Package per-group outputs (ref: model_executor.rs:339-354).
        outputs: Dict[str, SequenceGroupOutput] = {}
        i = 0
        for meta in self._metadata:
            seq_outputs: Dict[int, SequenceOutput] = {}
            for seq_id in meta.seq_data:
                top_tokens = None
                if top_ids_np is not None and meta.top_n_tokens > 0:
                    k = min(meta.top_n_tokens, top_ids_np.shape[1])
                    top_tokens = [
                        (int(top_ids_np[i, j]), float(top_lps_np[i, j]))
                        for j in range(k)
                    ]
                seq_outputs[seq_id] = SequenceOutput(
                    parent_seq_id=seq_id,
                    output_token=int(tokens_np[i]),
                    logprob=float(logprobs_np[i]),
                    is_new_token=meta.do_sample,
                    top_tokens=top_tokens,
                )
                i += 1
            outputs[meta.request_id] = SequenceGroupOutput(
                outputs=seq_outputs, time_to_generate=elapsed
            )
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

    # ------------------------------------------------------------------ step
    @torch.inference_mode()
    def _step(
        self,
        packed: torch.Tensor,   # [N] int32 on the device — all step metadata
        sampling: dict,         # per-row sampling tensors on the device
        gumbel: Optional[torch.Tensor],
        *,
        T: int,
        S: int,
        P: int,
        decode_only: bool,
        max_q_len: int,
        needs_penalties: bool,
        needs_typical: bool,
        top_n: int,
    ):
        """Forward + logits + sampling for one bucketed batch. The caches in
        ``self.cache_engine.kv_cache`` are updated in place."""
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
        selected_token_indices = take(S)
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
        hidden = self.model.forward(
            self.params, token_ids, positions, self.cache_engine.kv_cache, attn_meta
        )
        # Last-token rows only, before the LM head (ref: llama.rs:474-477).
        sel = hidden[selected_token_indices.long()]
        logits = self.model.compute_logits(self.params, sel)  # [S, V] f32
        return sample(
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

    # ---------------------------------------------------------------- public
    @instrument("worker.execute_model")
    def execute_model(self, request: ExecuteModelRequest) -> Dict[str, SequenceGroupOutput]:
        """One engine step (ref: worker.rs:111-191): swap/copy cache blocks,
        prepare inputs, forward+sample, package outputs per group."""
        pending = self.dispatch(request)
        return pending.complete() if pending is not None else {}

    @instrument("worker.dispatch")
    def dispatch(self, request: ExecuteModelRequest) -> Optional[PendingStep]:
        """Enqueue one step on the device without waiting for its results;
        ``PendingStep.complete()`` waits for the sampled tokens.
        Cache-maintenance swaps/copies run first, in the reference's order
        (worker.rs:111-160)."""
        t0 = time.monotonic()
        self.cache_engine.execute(
            request.blocks_to_swap_in, request.blocks_to_swap_out, request.blocks_to_copy
        )
        if not request.sequence_groups_metadata:
            return None

        with span("worker.input_prep"):
            model_input = prepare_model_input(
                request.sequence_groups_metadata,
                block_size=self.cache_config.block_size,
                max_pages_per_seq=self.max_pages_per_seq,
                sliding_window=self.cache_config.sliding_window,
            )
        with span("worker.sampling_build"):
            sampling, sampling_arrays, sample_steps = self._sampling_inputs(
                request, model_input
            )
        with span("worker.invoke"):
            tokens, logprobs, top_out = self._invoke(
                model_input, sampling_arrays, sample_steps, sampling
            )
            packed = _pack_outputs(tokens, logprobs)
        return PendingStep(request.sequence_groups_metadata, tokens, packed, top_out, t0)

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
        return sampling, arrays, sample_steps

    def _invoke(self, model_input: ModelInput, sampling_arrays, sample_steps, sampling):
        """Send the packed metadata (one host→device copy, from pinned
        memory on CUDA), run the step, return device (tokens, logprobs,
        top-n)."""
        T = model_input.token_ids.shape[0]
        S, P = model_input.block_tables.shape
        with span("worker.meta_transfer"):
            host = torch.from_numpy(
                np.concatenate(
                    [
                        model_input.token_ids,
                        model_input.positions,
                        model_input.slot_mapping,
                        model_input.block_tables.ravel(),
                        model_input.seq_lens,
                        model_input.query_start_loc,
                        np.asarray(sample_steps, dtype=np.int32),
                        np.asarray([model_input.num_seqs], dtype=np.int32),
                        model_input.selected_token_indices,
                    ]
                ).astype(np.int32)
            )
            if self.device.type == "cuda":
                packed = host.pin_memory().to(self.device, non_blocking=True)
            else:
                packed = host
        gumbel = None
        if sampling.needs_sampling:
            rows = np.nonzero(sampling.do_sample & model_input.sample_mask)[0]
            gumbel = gumbel_noise(
                sampling.seeds, sample_steps, rows,
                self.model.config.vocab_size, self.device,
            )
        with span("worker.step_call"):
            return self._step(
                packed,
                sampling_arrays,
                gumbel,
                T=T,
                S=S,
                P=P,
                decode_only=model_input.decode_only,
                max_q_len=model_input.max_q_len,
                needs_penalties=sampling.needs_penalties,
                needs_typical=sampling.needs_typical,
                top_n=sampling.top_n,
            )
