"""Pipeline-parallel model worker: the stages of one step, chained by
asynchronous launches across devices.

Counterpart of ``atoma_infer_tpu/engine/pp_worker.py``. Each stage ``s``
owns a contiguous layer slice (``parallel/pipeline.py``), its parameters,
its own ``CacheEngine`` over those layers (with an INT8 cache's scales),
its device and, under tensor parallelism, its group; stage 0 embeds, the
last stage gathers the last-token rows, computes the logits and samples.
Where JAX jits one program a stage, a stage here has one step function, made
of the single-stage worker's pieces (``ModelWorker._unpack``, the model's
``embed_tokens`` and ``forward_hidden``, ``ModelWorker._tail``): stage 0
embeds and runs its layers, a middle stage runs its layers, the last runs
its layers and the tail. On CUDA each stage replays CUDA graphs of its
step, from a ``StepGraphs`` of its own (``engine/cuda_graphs.py``: the
last stage keyed as a single-stage step, the others by ``StageKey``;
stages on one device share its memory pool); under tensor parallelism a
stage captures in segments between the collectives of its own group
(``TpGroup.for_stage``). On the CPU every stage steps eagerly.

Stage ``s`` runs with its device current, on that device's current stream,
and receives the packed metadata there and the hidden state [T, H]: eagerly
by ``.to(device, non_blocking=True)`` — nothing when both stages share a
device —, with graphs by a ``copy_`` into its static hidden input. PyTorch
launches asynchronously, so the host dispatches every stage of a step
without waiting and the engine's cohorts (``llm_engine.py``) keep one step
each in flight: while stage 1 computes cohort A, stage 0 computes cohort B.
A cross-device copy orders the two devices' streams; on one device the
stream orders everything. No side stream is used. Cohorts whose steps have
one key replay one graph a stage and share its outputs; what reads them —
the next stage's fill, the host copy of the tokens (``PendingStep``) — is
enqueued at dispatch, before the next cohort's replay overwrites them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import CacheConfig, SchedulerConfig
from ..sequence import ExecuteModelRequest
from ..utils.tracing import span
from .cache_engine import CacheEngine
from .cuda_graphs import StepGraphs, page_capacity, stage_graph_key, token_capacity
from .input_prep import ModelInput, bucket
from .worker import ModelWorker, graphs_class


@dataclasses.dataclass
class Stage:
    """One pipeline stage as this rank holds it."""

    model: Any                  # the stage's model view (device, group)
    params: Dict[str, Any]      # its layers (+ embed / final norm, LM head)
    cache_engine: CacheEngine   # the KV cache of its layers
    layer_offset: int           # its first layer's index in the model
    graphs: Optional[StepGraphs] = None  # its CUDA graphs (None: eager)

    @property
    def device(self) -> torch.device:
        return self.cache_engine.device


def _current(device: torch.device):
    """``device`` made current for a stage's launches (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class PipelinedModelWorker(ModelWorker):
    """``ModelWorker`` over ``pp`` pipeline stages (each tensor-parallel
    when the rank has a group). Its graphs are its stages' (``Stage.graphs``):
    the single-stage ``graphs`` stays None."""

    def __init__(
        self,
        stage_models: Sequence,
        stage_params: Sequence[Dict[str, Any]],
        cache_engines: Sequence[CacheEngine],
        bounds: Sequence[Tuple[int, int]],
        scheduler_config: SchedulerConfig,
        cache_config: CacheConfig,
        cuda_graphs: bool = True,
        step_graphs: Optional[type] = None,
    ):
        if not len(stage_models) == len(stage_params) == len(cache_engines) == len(bounds):
            raise ValueError("one model, parameter dict, cache engine and bound a stage")
        self.stages: List[Stage] = [
            Stage(m, p, ce, lo)
            for m, p, ce, (lo, _) in zip(stage_models, stage_params, cache_engines, bounds)
        ]
        # The single-stage state the base class keeps is the last stage's:
        # it samples, so the sampling tensors and the noise live there.
        super().__init__(stage_models[-1], stage_params[-1], cache_engines[-1],
                         scheduler_config, cache_config, cuda_graphs=False)
        # A graph set a stage when every stage is on the card (or the caller
        # gives ``step_graphs``), each captured in segments between the
        # collectives of the stage's group under tensor parallelism.
        if cuda_graphs and all(graphs_class(st.device, step_graphs) for st in self.stages):
            pools: dict = {}
            for stage in self.stages:
                stage.graphs = graphs_class(stage.device, step_graphs)(
                    bucket(scheduler_config.max_num_sequences),
                    page_capacity(scheduler_config.max_model_len, cache_config.block_size),
                    token_capacity(scheduler_config.max_num_batched_tokens),
                    pools=pools, group=getattr(stage.model, "group", None))

    @property
    def cache_engines(self) -> List[CacheEngine]:
        return [stage.cache_engine for stage in self.stages]

    def _cache_execute(self, request: ExecuteModelRequest) -> None:
        """Swaps and copies apply to every stage's layers: block ids are
        global over the layers, so each stage executes the same mapping."""
        for stage in self.stages:
            with _current(stage.device):
                stage.cache_engine.execute(request.blocks_to_swap_in,
                                           request.blocks_to_swap_out,
                                           request.blocks_to_copy)

    def _stage_step(self, stage: Stage, *, first: bool, last: bool, dims: dict, sampling):
        """Stage ``stage``'s step function, ``step(packed, sampling_arrays,
        gumbel, prev_tokens[, hidden])``: stage 0 embeds the token ids and
        runs its layers, a middle stage runs its layers on the previous
        stage's hidden state, the last runs its layers and the tail (LM head
        and sampling) → (hidden,), or the last stage's (tokens, logprobs,
        packed outputs, top-n)."""

        @torch.inference_mode()
        def step(packed, sampling_arrays, gumbel, prev_tokens, hidden=None):
            token_ids, positions, meta, selected = self._unpack(packed, prev_tokens, **dims)
            if first:
                hidden = stage.model.embed_tokens(stage.params, token_ids)
            else:
                hidden = hidden.to(stage.device, non_blocking=True)
            ce = stage.cache_engine
            hidden = stage.model.forward_hidden(
                stage.params, hidden, positions, ce.kv_cache, meta,
                kv_scales=ce.kv_scales, layer_offset=stage.layer_offset)
            if not last:
                return (hidden,)
            return self._tail(stage.model, stage.params, hidden, selected, sampling_arrays,
                              gumbel, S=dims["S"], needs_penalties=sampling.needs_penalties,
                              needs_typical=sampling.needs_typical, top_n=sampling.top_n)

        return step

    def _invoke(self, model_input: ModelInput, sampling_arrays, sample_steps, sampling,
                prev=None):
        """Dispatch the step through every stage → device (tokens, logprobs,
        packed outputs, top-n) on the last stage's device; each stage's step
        replays its graph of the step's key where it has graphs. No
        device-token feed: the cohorts overlap steps instead (async
        scheduling is off with more than one cohort), and no verify rows
        (speculative decoding is refused with pipeline stages)."""
        if prev is not None or model_input.spec_rows is not None:
            raise ValueError("a pipelined step takes no device-token feed and no verify rows")
        T = model_input.token_ids.shape[0]
        S, P = model_input.block_tables.shape
        dims = dict(T=T, S=S, P=P, decode_only=model_input.decode_only,
                    max_q_len=model_input.max_q_len)
        with span("worker.meta_transfer"):
            host = self._pack_metadata(model_input, sample_steps)
        hidden = None
        with span("worker.step_call"):
            for s, stage in enumerate(self.stages):
                first, last = s == 0, s == len(self.stages) - 1
                with _current(stage.device):
                    packed = self._send(host, stage.device)
                    arrays, gumbel = {}, None
                    if last:
                        arrays = sampling_arrays
                        gumbel = self._noise(model_input, sampling, sample_steps, stage.device)
                    step = self._stage_step(stage, first=first, last=last, dims=dims,
                                            sampling=sampling)
                    if stage.graphs is None:
                        out = step(packed, arrays, gumbel, None, hidden)
                    else:
                        out = stage.graphs.run(
                            stage_graph_key(model_input, sampling, last=last), step, packed,
                            arrays, self._sampling_version, gumbel, None, hidden)
                if not last:
                    hidden = out[0]
            return out
