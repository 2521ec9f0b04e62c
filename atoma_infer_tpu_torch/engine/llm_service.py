"""LLM service: startup orchestration + request admission.

Counterpart of ``atoma_infer_tpu/engine/llm_service.py`` (ref:
backends/vllm/src/llm_service.rs): startup (model load → KV profiling →
engine boot, :116-245), the admission path (validate → build
Sequence/SequenceGroup with per-request sampling params → engine, :318-388)
and shutdown (:404-442), on ONE device. The KV pool is sized after the
weights are resident (SURVEY.md §3.1), from ``torch.cuda.mem_get_info``.

Tensor parallelism (``tensor_parallel_size`` > 1) runs one process per
rank: ``start`` spawns the host's other ranks, each building the same
service on its own device (or sharing a card) with its shard of the weights
and KV heads, and returns rank 0's service, whose engine broadcasts every
step's admissions to the followers (``engine/multihost.py``). Multi-host
(``num_hosts``, ``host_id``, ``coordinator_address``) is the same code with
the ranks spread over hosts. Pipeline parallelism
(``pipeline_parallel_size`` > 1, :meth:`LlmService._start_pipelined`) splits
the layers into stages, each with its cache engine and device, served by
one scheduler a cohort over one block pool; under tensor parallelism each
rank holds its shard of every stage. The block manager is the native (C++)
core when ``use_native_core`` is set (the default; ``native/``), else the
Python one, and the Python one under speculative decoding, as the JAX
service chooses (:meth:`LlmService._build_block_manager`); prefix caching
(``enable_prefix_caching``) runs over either, and float16 (``dtype``) on
the kernels' fp16 instantiations. Async scheduling (``async_scheduling``,
``async_depth``) is ported, and so is ``warmup``, which on the card captures
the CUDA graphs of every step it reaches before traffic, prefill and mixed
steps at the token budget and long contexts' page buckets included
(``engine/cuda_graphs.py``), under pipeline parallelism each stage's own,
and under tensor parallelism, pipelined or not, every rank's, in segments
between the collectives. So is speculative decoding
(``num_speculative_tokens``: n-gram drafts verified in the same forward,
greedy acceptance; a step with drafts runs synchronously). Weight quantization
(``quantization`` "int8" or "int4", and W8A8 under ``ATOMA_W8A8=1``) is
ported: the loader quantizes on load. So are the KV-cache dtypes
(``kv_cache_dtype`` "int8": an int8 cache with per-(slot, K/V) bf16 scales;
"fp8": an e4m3 cache), chosen as the JAX service chooses them. Every model
family of the registry is served; on the card, a shape no attention kernel
takes (``check_kernel_shapes``: head dim, GQA group, dtype, KV dtype) is
refused before anything is loaded.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import logging
import math
import os
import shutil
import socket
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..core.scheduler import Scheduler
from ..parallel.distributed import init_distributed, rendezvous
from ..parallel.group import local_device
from ..parallel.pipeline import stage_layer_bounds
from ..parallel.sharding import check_divisibility, kv_repeat, shard_params
from ..sequence import Sequence, SequenceGroup
from ..types import GenerateParameters, GenerateRequest
from ..utils.device import resolve_device
from ..utils.tracing import instrument
from .cache_engine import CacheEngine
from .cuda_graphs import MAX_GRAPHS, packed_capacity, page_capacity, token_capacity
from .input_prep import bucket
from .llm_engine import LlmEngine
from .tokenizer import TokenizerPool
from .sampler import PENALTY_WINDOW
from .validation import Validation
from .worker import ModelWorker

logger = logging.getLogger(__name__)

_SEQ_COUNTER = itertools.count()

# The dtypes the port's kernels take.
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
# KV-cache dtypes by ``kv_cache_dtype``; None keeps the model's dtype.
_KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _load_tokenizer(model_dir: str):
    from tokenizers import Tokenizer

    return Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))


def check_kernel_shapes(model_config, config: EngineConfig) -> None:
    """Raise ``ValueError`` when the card has no attention kernel for the
    model's shapes served as ``config`` says: its head dim and a rank's GQA
    group (its q heads over its kv heads, copies of a kv head counted when
    ``tensor_parallel_size`` is wider than the kv heads), the activations'
    dtype and the KV cache's (``ops/paged_attention.py``
    ``check_kernel_shape``, which the kernels' wrappers call too): the
    ragged kernel's, which every step runs (any group; any head dim from 1
    up, past 512 in column slices), and the fused kernel's where
    ``decode_route`` sends pure-decode steps to it (up to
    ``MAX_FUSED_GROUP``; past that they take the write and the ragged
    kernel). ``LlmService.start`` calls it on the card before anything is
    loaded or allocated."""
    from ..ops.paged_attention import check_kernel_shape, decode_route

    hq, hk = model_config.num_attention_heads, model_config.num_key_value_heads
    hk *= kv_repeat(config.model.tensor_parallel_size, hk)
    check_kernel_shape(
        head_dim=model_config.head_dim, dtype=_DTYPES[config.model.dtype],
        kind=_KV_DTYPES.get(config.model.kv_cache_dtype), group=hq // hk,
        block_size=config.cache.block_size, fused=decode_route(hq, hk) == "fused",
    )


@dataclasses.dataclass(frozen=True)
class ModelFactory:
    """A model that every rank of a tensor-parallel service builds for
    itself: ``build(device, *args)`` → (model, params, tokenizer) with the
    full, unsharded parameters (the service cuts the rank's shard), and the
    model's ``config``, which ``LlmService.start`` checks before it starts
    any rank. ``build``, ``args`` and ``step_graphs`` travel to the spawned
    ranks by pickle (``build`` and ``step_graphs`` by import path).
    ``step_graphs``: the ``engine/cuda_graphs.py`` ``StepGraphs`` class every
    rank's workers keep, on any device (None: ``StepGraphs`` on the card,
    none on the CPU); tests give one whose graphs replay by recomputing."""

    config: Any
    build: Callable
    args: Tuple = ()
    step_graphs: Optional[type] = None

    def __call__(self, device):
        return self.build(device, *self.args)


# Seconds ``LlmService.stop`` waits for each follower rank to exit.
FOLLOWER_JOIN_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_devices(device: torch.device, config: EngineConfig) -> int:
    """The CUDA devices one host's ranks may use (``num_devices`` caps
    them); 1 on the CPU."""
    if device.type != "cuda":
        return 1
    n = torch.cuda.device_count()
    return min(n, config.model.num_devices) if config.model.num_devices else n


def _check_followers(procs) -> None:
    """Raise when a follower rank has exited with an error."""
    for p in procs:
        if p.exitcode not in (None, 0):
            raise RuntimeError(f"tensor-parallel rank process {p.name} exited with "
                               f"code {p.exitcode}")


def _follower_main(config: EngineConfig, rank: int, local_ranks: int, local_devices: int,
                   init_method: str, model_factory, model_dir, device_type: str,
                   num_threads: int) -> None:
    """A spawned follower rank: join the group, build the same service on
    this rank's device, and step in lockstep with rank 0 until it stops."""
    from .multihost import follower_loop

    torch.set_num_threads(num_threads)
    device = local_device(device_type, rank % local_ranks, local_devices)
    group = init_distributed(init_method, config.model.tensor_parallel_size, rank,
                             device=device, local_ranks=local_ranks,
                             local_devices=local_devices)
    service = LlmService.start(config, model_factory=model_factory, model_dir=model_dir,
                               group=group)
    follower_loop(service)
    service.tokenizer_pool.shutdown()


# The step graphs' pool, in [R, V] f32 buffers at the largest sequence
# bucket S (R = S, or S·(1+K) verify rows): what one step's sampler and LM
# head leave allocated at once at the widest key (every sampling option and
# the most top-n alternatives). Measured on an H100 (chip_smoke.py,
# V = 128256, S = 64): 572–614 MiB, 18.3–19.6 such buffers, for 1B-, 3B-
# and 8B-width models.
GRAPH_POOL_ROWS = 24
# What a penalty step's sampler adds (``sampler.apply_penalties``): its
# [S, V+1] counts, the penalized logits and the two selects' results.
PENALTY_POOL_ROWS = 4
# Device bytes CUDA holds outside PyTorch's allocator for one instantiated
# graph, per model layer (its kernel nodes). Measured likewise: 96–154 KiB.
GRAPH_BYTES_PER_LAYER = 256 * 1024
# What each segment of a tensor-parallel step's capture holds there besides
# its layers' kernel nodes (an instantiated graph of its own). Measured on an
# H100 (chip_smoke.py, 8B INT8 + INT8 KV at tp 2, ranks capturing one after
# another): 16.3–20.0 MiB a key of 98 segments at 32 layers, 170–209 KiB a
# segment with the layers' share; the reserve counts 26.2 MiB a key.
GRAPH_BYTES_PER_SEGMENT = 192 * 1024
# The K splits' f32 partial sums of one quantized matmul, in elements, less
# its own M·N: a split plan keeps splits·M·N within slots·128·128 + M·N on
# the tensor-core route (``quant_kernels.mma_plan``: blocks of up to 128 ×
# 128, as many splits as fill the card's slots; taken at 8 blocks an SM of
# an H100's 132), and within 264·4·2,048 + M·N on the CUDA cores.
QMM_SPLIT_ELEMENTS = 8 * 132 * 128 * 128


def _rank_widths(model_config, tp: int):
    """A rank's (q heads, kv heads, intermediate size) at ``tp``: its
    shard's (``parallel/sharding.py``; kv heads copied when tp is wider,
    each rank's experts' intermediate summed under expert parallelism)."""
    c = model_config
    experts = getattr(c, "num_local_experts", 1)
    kv = c.num_kv_heads * kv_repeat(tp, c.num_kv_heads)
    return c.num_attention_heads // tp, kv // tp, experts * c.intermediate_size // tp


def activation_bytes(num_tokens: int, model_config, tp: int = 1) -> int:
    """One step's forward at T = ``num_tokens`` tokens on a rank of ``tp``:
    what one layer holds at once, the hidden state and its residual sum, the
    norm's f32 copy, the rank's q/k/v and rope's copies, its attention's
    output, its MLP's gate, up and product (on every expert of a dense MoE),
    each counted at 4 bytes an element."""
    c = model_config
    hq, hk, inter = _rank_widths(c, tp)
    qkv = (hq + 2 * hk) * c.head_dim
    per_token = 4 * c.hidden_size + 2 * qkv + hq * c.head_dim + 3 * inter
    return 4 * num_tokens * per_token


def quantized_bytes(num_tokens: int, model_config, tp: int = 1) -> int:
    """A quantized linear's temporaries at T tokens: W8A8's per-token
    quantization (three f32 copies of the activations, at the widest K) and
    the K splits' partial sums (:data:`QMM_SPLIT_ELEMENTS` and one M·N, at
    the widest N but the LM head's, which never splits); a rank's widths."""
    c = model_config
    wide = max(c.hidden_size, c.intermediate_size // tp)
    return 4 * (3 * num_tokens * wide + QMM_SPLIT_ELEMENTS + num_tokens * wide)


def split_workspace_bytes(num_tokens: int, model_config, max_pages: int,
                          block_size: int, tp: int = 1) -> int:
    """The ragged kernel's split workspace at T tokens (allocated in the
    capture, ``ops/paged_attention.py`` ``ragged_paged_attention_mma_launch``,
    shapes from ``split_workspace_shapes``): splits · T · Hq · (D + 2) f32
    (Hq the rank's, D the model's head dim, which the kernels stride the
    workspace by at every instantiation width), at the most splits any plan
    takes over ``max_pages`` pages (``rpa_mma_plan``: at most
    ``RPA_MAX_SPLITS``, and at most one a ``RPA_MIN_TILES`` key tiles)."""
    from ..ops.paged_attention import (
        RPA_KEY_TILE, RPA_MAX_SPLITS, RPA_MIN_TILES, split_workspace_shapes,
    )

    key_tiles = -(-max_pages * block_size // RPA_KEY_TILE)
    splits = min(RPA_MAX_SPLITS, -(-key_tiles // RPA_MIN_TILES))
    c = model_config
    shapes = split_workspace_shapes(splits, num_tokens, c.num_attention_heads // tp, c.head_dim)
    return 4 * sum(math.prod(shape) for shape in shapes)


def graph_pool_bytes(model_config, scheduler_config, block_size: int, *,
                     quantized: bool = False, sampler: bool = True, tp: int = 1) -> int:
    """The step graphs' pool, which holds one step's temporaries whatever
    the number of graphs: the LM head and the sampler over R rows (S, or
    S·(1+K) with K drafts a sequence: ``GRAPH_POOL_ROWS`` [R, V] f32
    buffers, and a penalty step's ``PENALTY_POOL_ROWS``; under tensor
    parallelism one more, the logits' gather's static output; without
    ``sampler``, a pipeline stage before the last, none), and a step's
    forward at its T on a rank of ``tp`` (:func:`activation_bytes`,
    :func:`quantized_bytes` with ``quantized`` weights,
    :func:`split_workspace_bytes`), taken at the widest T bucket, where each
    is largest: the split workspace's bound does not fall with T (the plans'
    splits do)."""
    R = bucket(scheduler_config.max_num_sequences) * (1 + scheduler_config.num_speculative_tokens)
    T = token_capacity(scheduler_config.max_num_batched_tokens)
    P = page_capacity(scheduler_config.max_model_len, block_size)
    forward = activation_bytes(T, model_config, tp) + split_workspace_bytes(
        T, model_config, P, block_size, tp)
    if quantized:
        forward += quantized_bytes(T, model_config, tp)
    if not sampler:
        return forward
    rows = GRAPH_POOL_ROWS + PENALTY_POOL_ROWS + (tp > 1)
    return 4 * rows * R * model_config.vocab_size + forward


def graph_reserve_bytes(model_config, scheduler_config, block_size: int, *,
                        quantized: bool = False, tp: int = 1) -> int:
    """Device memory a single-stage worker's step graphs take, which the KV
    pool must leave free, from the model's config and the scheduler's
    limits: their static inputs (``engine/cuda_graphs.py``: one set for
    every graph, at the largest sequence, page and token buckets — the
    Gumbel noise over R rows, the packed metadata, the sampling tensors, the
    feed), their pool (:func:`graph_pool_bytes`) and each instantiated
    graph's own memory, ``MAX_GRAPHS`` of them and the one being captured,
    on a rank of ``tp`` (its segments counted):
    :func:`stage_graph_reserve_bytes` of one stage."""
    (reserve,) = stage_graph_reserve_bytes(
        model_config, scheduler_config, block_size, [(0, model_config.num_layers)], [None],
        hidden_bytes=0, quantized=quantized, tp=tp).values()
    return reserve


def graph_segments(num_layers: int, tp: int) -> int:
    """The most graphs one key's capture makes on a rank of ``tp``: one at
    tp 1; else a segment after each collective and one more, 3·L + 2 with
    an INT8 cache's scales (2·L + 2 without)."""
    return 1 if tp == 1 else 3 * num_layers + 2


def stage_graph_reserve_bytes(model_config, scheduler_config, block_size: int, bounds,
                              devices, *, hidden_bytes: int, quantized: bool = False,
                              tp: int = 1) -> dict:
    """Device memory the pipeline stages' step graphs take on each device
    (``engine/pp_worker.py``: a ``StepGraphs`` a stage, stages on one device
    sharing its pool), by device, on a rank of ``tp``: the sum over the
    stages it holds of
    - the static inputs: the packed metadata on every stage; the hidden
      state ``[token_capacity, H]`` at ``hidden_bytes`` an element on a
      stage after the first; the Gumbel noise and the sampling tensors on
      the last stage only;
    - the hidden state each graph of a stage before the last keeps as its
      output, at the widest T, ``MAX_GRAPHS`` of them and the one being
      captured;
    - each instantiated graph's own memory at the stage's layers,
      ``(MAX_GRAPHS + 1) × GRAPH_BYTES_PER_LAYER`` a layer, and under tensor
      parallelism ``GRAPH_BYTES_PER_SEGMENT`` for each of a key's
      :func:`graph_segments`;
    and the device's pool once: the largest of its stages' pools
    (:func:`graph_pool_bytes` at the rank's widths, the LM head and sampler
    rows, the gather's output under TP, on the last stage only, a step's
    forward at the widest T on every stage)."""
    S = bucket(scheduler_config.max_num_sequences)
    K = scheduler_config.num_speculative_tokens
    T = token_capacity(scheduler_config.max_num_batched_tokens)
    P = page_capacity(scheduler_config.max_model_len, block_size)
    packed = 4 * packed_capacity(S, P, T, K)
    sampler = 4 * (S * (1 + K) * model_config.vocab_size + S * (8 + PENALTY_WINDOW))
    hidden = T * model_config.hidden_size * hidden_bytes
    last = len(bounds) - 1
    reserve: dict = {}
    pools: dict = {}
    for s, ((lo, hi), device) in enumerate(zip(bounds, devices)):
        reserve[device] = (reserve.get(device, 0) + packed
                           + (hidden if s else 0)
                           + (sampler if s == last else (MAX_GRAPHS + 1) * hidden)
                           + (MAX_GRAPHS + 1) * GRAPH_BYTES_PER_LAYER * (hi - lo)
                           + (MAX_GRAPHS + 1) * GRAPH_BYTES_PER_SEGMENT
                           * (graph_segments(hi - lo, tp) - 1))
        pools[device] = max(pools.get(device, 0), graph_pool_bytes(
            model_config, scheduler_config, block_size, quantized=quantized,
            sampler=s == last, tp=tp))
    return {device: reserve[device] + pools[device] for device in reserve}


def resolve_model_dir(config) -> str:
    """Model weights directory: a local path or the cache dir (the port has
    no hub download)."""
    name = config.model.model_name
    if os.path.isdir(name):
        return name
    local = os.path.join(config.model.cache_dir, name.replace("/", "--"))
    if os.path.isdir(local):
        return local
    raise FileNotFoundError(f"model {name!r} not found locally")


class LlmService:
    """Boots the stack and admits requests (ref: llm_service.rs:102-296)."""

    def __init__(
        self,
        config: EngineConfig,
        engine: LlmEngine,
        validation: Validation,
        tokenizer_pool: TokenizerPool,
        block_size: int,
        eos_token_ids,
        group=None,
    ):
        self.config = config
        self.engine = engine
        self.validation = validation
        self.tokenizer_pool = tokenizer_pool
        self.block_size = block_size
        self.eos_token_ids = eos_token_ids
        # Tensor parallelism: this rank's group (None: one rank), the
        # follower processes rank 0 started, and rank 0's lockstep hook.
        self.group = group
        self.followers = []
        self.lockstep = None

    # ----------------------------------------------------------------- startup
    @classmethod
    def start(
        cls,
        config: EngineConfig,
        *,
        model=None,
        params=None,
        tokenizer=None,
        model_dir: Optional[str] = None,
        device=None,
        model_factory: Optional[ModelFactory] = None,
        group=None,
    ) -> "LlmService":
        """Build the full stack (ref: llm_service.rs:102-245) on ``device``
        — the current CUDA device unless the caller asks for another
        (``device="cpu"`` in the tests); without a GPU the default raises.

        ``model``/``params``/``tokenizer`` may be injected (tests, the chip
        smoke); an injected model must live on ``device``. With
        ``tensor_parallel_size`` > 1 each rank builds its own model, from
        ``model_factory``, the checkpoint, or ``tiny-random``: see
        :meth:`_start_tensor_parallel`. ``group`` is a rank's
        ``TpGroup``; a rank's own start passes it, callers do not.
        """
        t0 = time.monotonic()
        tp = config.model.tensor_parallel_size
        if tp > 1 and group is None:
            if model is not None or params is not None:
                raise ValueError(
                    "tensor_parallel_size > 1: every rank builds its own model; pass "
                    "model_factory (or a checkpoint), not an injected model")
            return cls._start_tensor_parallel(config, device=device, model_dir=model_dir,
                                              model_factory=model_factory)
        device = group.device if group is not None else resolve_device(device)
        sharded = False
        if model is None or params is None or tokenizer is None:
            if model_factory is not None:
                model, params, tokenizer = model_factory(device)
            elif config.model.model_name == "tiny-random":
                from ..entrypoints.offline import build_tiny_random

                model, params, tokenizer = build_tiny_random(device)
            else:
                from ..models.registry import get_model_cls
                from ..models.weights import load_hf_config, load_llama_params

                model_dir = model_dir or resolve_model_dir(config)
                model_cfg = load_hf_config(model_dir)
                if device.type == "cuda":
                    check_kernel_shapes(model_cfg, config)
                dtype = _DTYPES[config.model.dtype]
                model = get_model_cls(model_cfg.architecture or "llama")(
                    model_cfg, dtype=dtype, device=device
                )
                params = load_llama_params(
                    model_dir, model_cfg, dtype=dtype, device=device,
                    quantization=config.model.quantization, group=group,
                )
                sharded = True
                tokenizer = _load_tokenizer(model_dir)
            logger.info("model loaded in %.1fs", time.monotonic() - t0)
        if model.device != device:
            raise ValueError(f"model is on {model.device}, service on {device}")
        step_graphs = getattr(model_factory, "step_graphs", None)
        if config.model.pipeline_parallel_size > 1:
            return cls._start_pipelined(config, model, params, tokenizer, device, group,
                                        sharded, step_graphs)

        cfg = model.config
        if group is not None and group.tp > 1:
            # This rank's shard (ref: model_executor.rs:394-545, the NCCL
            # dispatcher; JAX: shard_params over the mesh).
            check_divisibility(cfg.num_attention_heads, cfg.num_kv_heads, group.tp)
            model.group = group
            if not sharded:
                params = shard_params(params, group, cfg.num_kv_heads)
        if device.type == "cuda":
            check_kernel_shapes(cfg, config)
        # The KV cache's dtype, as the JAX service picks it: int8 (with
        # scales), e4m3, or the model's own.
        kv_dtype = _KV_DTYPES.get(config.model.kv_cache_dtype, model.dtype)
        # Every worker on the card replays CUDA graphs, a tensor-parallel
        # rank's in segments between its collectives; the CPU steps eagerly
        # unless the factory gives its own ``step_graphs``.
        graphs = device.type == "cuda" or step_graphs is not None
        reserve = graph_reserve_bytes(cfg, config.scheduler, config.cache.block_size,
                                      quantized=config.model.quantization is not None,
                                      tp=model.tp) if graphs else 0
        cls._profile_kv(config, model, kv_dtype, [device], group, reserve)
        cache_engine = CacheEngine(
            num_layers=cfg.num_layers,
            num_kv_heads=model.local_kv_heads,
            head_dim=cfg.head_dim,
            block_size=config.cache.block_size,
            num_device_blocks=config.cache.num_device_blocks,
            num_host_blocks=config.cache.num_host_blocks or 0,
            dtype=kv_dtype,
            device=device,
        )
        worker = ModelWorker(model, params, cache_engine, config.scheduler, config.cache,
                             cuda_graphs=graphs, step_graphs=step_graphs)
        scheduler = Scheduler(config.scheduler, config.cache,
                              block_manager=cls._build_block_manager(config))
        tokenizer_pool = TokenizerPool(tokenizer, config.model.num_tokenizer_workers)
        validation = Validation(config.validation, tokenizer_pool)
        engine = LlmEngine(
            scheduler,
            worker,
            tokenizer,
            cfg.eos_token_ids,
            config.scheduler.max_model_len,
            async_scheduling=config.scheduler.async_scheduling,
            async_depth=config.scheduler.async_depth,
        )
        return cls(
            config,
            engine,
            validation,
            tokenizer_pool,
            config.cache.block_size,
            cfg.eos_token_ids,
            group=group,
        )

    @classmethod
    def _start_pipelined(cls, config: EngineConfig, model, params, tokenizer, device, group,
                         sharded: bool, step_graphs=None) -> "LlmService":
        """Pipeline-parallel start (JAX ``engine/llm_service.py:259-369``):
        the layers split into ``pipeline_parallel_size`` stages, each with
        its parameters (this rank's shard under tensor parallelism), its
        device (``parallel/pipeline.py`` ``stage_devices``), its cache engine
        over its layers and, under TP, its group; one scheduler a cohort,
        all over one block pool (block ids are global over the layers). The
        pool is sized by the layers on the most crowded device, less the
        largest device's reserve for its stages' CUDA graphs
        (:func:`stage_graph_reserve_bytes`): stages that share a card share
        its memory. On the card each stage replays graphs of its own
        (``engine/pp_worker.py``), under tensor parallelism in segments
        between the collectives of its stage's group."""
        from ..parallel.pipeline import (
            log_layout, place_stage_params, split_params, stage_devices,
        )
        from .pp_worker import PipelinedModelWorker

        cfg = model.config
        pp = config.model.pipeline_parallel_size
        tp = 1 if group is None else group.tp
        check_divisibility(cfg.num_attention_heads, cfg.num_kv_heads, tp)
        bounds = stage_layer_bounds(cfg.num_layers, pp)
        devices = stage_devices(pp, device, tp // (config.model.num_hosts or 1),
                                _local_devices(device, config))
        log_layout(bounds, devices, 0 if group is None else group.rank)
        groups = [None] * pp
        if tp > 1:
            model.group = group
            groups = [group.for_stage(s, d) for s, d in enumerate(devices)]
        stage_models = [model.for_stage(d, g) for d, g in zip(devices, groups)]
        stage_params = place_stage_params(split_params(params, pp),
                                          [None] * pp if sharded else groups, devices,
                                          cfg.num_kv_heads)
        del params
        if device.type == "cuda":
            check_kernel_shapes(cfg, config)
        kv_dtype = _KV_DTYPES.get(config.model.kv_cache_dtype, model.dtype)
        layers_on: dict = {}
        for (lo, hi), d in zip(bounds, devices):
            layers_on[d] = layers_on.get(d, 0) + hi - lo
        # A graph set a stage, on the card or with the factory's own
        # ``step_graphs``.
        graphs = device.type == "cuda" or step_graphs is not None
        reserve = max(stage_graph_reserve_bytes(
            cfg, config.scheduler, config.cache.block_size, bounds, devices,
            hidden_bytes=model.dtype.itemsize,
            quantized=config.model.quantization is not None, tp=tp).values()) if graphs else 0
        cls._profile_kv(config, model, kv_dtype, list(layers_on), group, reserve,
                        num_layers=max(layers_on.values()))
        cache_engines = [
            CacheEngine(
                num_layers=hi - lo,
                num_kv_heads=model.local_kv_heads,
                head_dim=cfg.head_dim,
                block_size=config.cache.block_size,
                num_device_blocks=config.cache.num_device_blocks,
                num_host_blocks=config.cache.num_host_blocks or 0,
                dtype=kv_dtype,
                device=d,
            )
            for (lo, hi), d in zip(bounds, devices)
        ]
        worker = PipelinedModelWorker(stage_models, stage_params, cache_engines, bounds,
                                      config.scheduler, config.cache, cuda_graphs=graphs,
                                      step_graphs=step_graphs)
        # One pool for every cohort, native or Python (JAX shares the native
        # one only: its Python path builds a pool a cohort, ROADMAP.md Queue 3).
        first = Scheduler(config.scheduler, config.cache,
                          block_manager=cls._build_block_manager(config))
        others = [Scheduler(config.scheduler, config.cache, block_manager=first.block_manager)
                  for _ in range(pp - 1)]
        tokenizer_pool = TokenizerPool(tokenizer, config.model.num_tokenizer_workers)
        engine = LlmEngine(
            first,
            worker,
            tokenizer,
            cfg.eos_token_ids,
            config.scheduler.max_model_len,
            extra_schedulers=others,
            async_scheduling=config.scheduler.async_scheduling,
            async_depth=config.scheduler.async_depth,
        )
        return cls(config, engine, Validation(config.validation, tokenizer_pool),
                   tokenizer_pool, config.cache.block_size, cfg.eos_token_ids, group=group)

    @staticmethod
    def _build_block_manager(config: EngineConfig):
        """The native (C++) block manager when ``use_native_core`` is set
        and the core builds, else None, from which the ``Scheduler`` builds
        the Python manager (JAX ``engine/llm_service.py:372-403``). Under
        speculative decoding the Python one: lookahead slots spanning a
        shared block need its multi-block copy-on-write. Where the library
        cannot be built the reference falls back to the Python manager with
        a warning, and so does the port (:attr:`native_core` tells them
        apart)."""
        if not config.scheduler.use_native_core:
            return None
        if config.scheduler.num_speculative_tokens:
            logger.info("speculative decoding enabled — using the Python block manager "
                        "(lookahead slots spanning shared blocks need its multi-block "
                        "copy-on-write)")
            return None
        try:
            from ..native.block_manager import NativeBlockSpaceManager

            manager = NativeBlockSpaceManager(
                block_size=config.cache.block_size,
                num_device_blocks=config.cache.num_device_blocks or 0,
                num_host_blocks=config.cache.num_host_blocks or 0,
                sliding_window=config.cache.sliding_window,
                enable_prefix_caching=config.cache.enable_prefix_caching,
            )
            logger.info("using native (C++) block-manager core")
            return manager
        except Exception as e:
            logger.warning("native core unavailable (%s); using Python block manager", e)
            return None

    @property
    def block_manager(self):
        """The block manager the scheduler (every cohort's, under PP) uses."""
        return self.engine.scheduler.block_manager

    @property
    def native_core(self) -> bool:
        """Whether this service runs on the native (C++) block manager."""
        from ..native.block_manager import NativeBlockSpaceManager

        return isinstance(self.block_manager, NativeBlockSpaceManager)

    @staticmethod
    def _profile_kv(config: EngineConfig, model, kv_dtype, devices, group, reserve_bytes: int,
                    num_layers: Optional[int] = None) -> None:
        """Size the KV pools AFTER the weights are resident (ref:
        config.rs:624-625): the least free memory over ``devices`` ÷ bytes
        per block of ``num_layers`` layers (default: the model's; a
        pipeline's most crowded device's), an INT8 cache's scales counted,
        less ``reserve_bytes`` (the step graphs'). Under tensor parallelism
        the replicated schedulers need identical pools: every rank takes the
        least of the ranks' counts. Ranks that share a card profile one
        after another, each holding its pool's bytes while the next
        measures, and each takes its share of what it finds free, so that no
        rank counts another's pool as free."""
        cfg = model.config
        kw = dict(
            devices=list(devices),
            scale_pages=kv_dtype == torch.int8,
            reserve_bytes=reserve_bytes,
        )
        shape = (num_layers or cfg.num_layers, model.local_kv_heads, cfg.head_dim,
                 config.model.kv_dtype_size)
        if group is None or group.tp == 1:
            config.cache.profile(*shape, **kw)
            return
        cuda = devices[0].type == "cuda"
        if cuda:
            torch.cuda.empty_cache()  # the load's temporaries: free for every rank
        held = []
        index, count = group.device_share
        for turn in range(group.tp):
            group.barrier()
            if turn == group.rank:
                config.cache.profile(*shape, share=count - index, **kw)
                if group.stage_on_host and cuda:
                    per_block = config.cache.block_bytes(*shape, kw["scale_pages"])
                    held = [torch.empty(config.cache.num_device_blocks * per_block,
                                        dtype=torch.uint8, device=d) for d in devices]
        config.cache.num_device_blocks = group.min_int(config.cache.num_device_blocks)
        config.cache.num_host_blocks = group.min_int(config.cache.num_host_blocks or 0)
        if held:
            del held
            torch.cuda.empty_cache()
        logger.info("rank %d of %d: %d KV blocks, the least over the ranks", group.rank,
                    group.tp, config.cache.num_device_blocks)

    @classmethod
    def _start_tensor_parallel(cls, config: EngineConfig, *, device, model_dir,
                               model_factory) -> "LlmService":
        """Start this host's ranks of a ``tensor_parallel_size`` service
        (JAX: one SPMD program over a mesh, ``engine/llm_service.py:150-190``).

        The heads must divide (checked before anything starts). Each host
        runs ``tp / num_hosts`` ranks, ``rank = host_id · local + i``: this
        process is the host's first, and it spawns the others
        (``torch.multiprocessing``, ``spawn``), each building the same
        service on its own device — card ``i % cards``, so ranks share a
        card when there are fewer cards than ranks — and entering
        ``follower_loop``. The ranks join at ``coordinator_address``
        (``host:port``, ``tcp://`` or ``file://``; one host: a free local
        port when it is unset). Rank 0 attaches the lockstep hook and
        returns its service; ``stop()`` releases and joins the followers. On
        another host, the returned service is a follower's: run
        ``engine.multihost.follower_loop`` on it."""
        from .multihost import attach_primary

        m = config.model
        tp, hosts, host_id = m.tensor_parallel_size, m.num_hosts or 1, m.host_id or 0
        if tp % hosts:
            raise ValueError(f"tensor_parallel_size {tp} does not divide over {hosts} hosts")
        if hosts > 1 and not m.coordinator_address:
            raise ValueError("multi-host serving needs coordinator_address")
        if model_factory is not None:
            model_cfg = model_factory.config
        elif m.model_name == "tiny-random":
            from ..entrypoints.offline import tiny_random_config

            model_cfg = tiny_random_config()
        else:
            from ..models.weights import load_hf_config

            model_dir = model_dir or resolve_model_dir(config)
            model_cfg = load_hf_config(model_dir)
        check_divisibility(model_cfg.num_attention_heads, model_cfg.num_key_value_heads, tp)
        stage_layer_bounds(model_cfg.num_hidden_layers, m.pipeline_parallel_size)
        device = resolve_device(device)
        if device.type == "cuda":
            check_kernel_shapes(model_cfg, config)
        local = tp // hosts
        cards = _local_devices(device, config)
        init_method = rendezvous(m.coordinator_address or f"127.0.0.1:{_free_port()}")
        base = host_id * local
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [
            ctx.Process(
                target=_follower_main, name=f"atoma-tp-rank{base + i}", daemon=True,
                args=(config, base + i, local, cards, init_method, model_factory, model_dir,
                      device.type, torch.get_num_threads()),
            )
            for i in range(1, local)
        ]
        for p in procs:
            p.start()
        try:
            group = init_distributed(
                init_method, tp, base, device=local_device(device.type, 0, cards),
                local_ranks=local, local_devices=cards, watch=lambda: _check_followers(procs))
            service = cls.start(config, model_factory=model_factory, model_dir=model_dir,
                                group=group)
        except BaseException:
            for p in procs:
                p.terminate()
                p.join(FOLLOWER_JOIN_TIMEOUT_S)
            raise
        service.followers = procs
        if group.is_primary:
            service.lockstep = attach_primary(service)
        return service

    # --------------------------------------------------------------- admission
    @instrument("service.handle_request")
    async def handle_request(self, request: GenerateRequest, *, stream: bool = False):
        """Validate → sequences → engine (ref: llm_service.rs:318-388).

        Returns an awaitable response future, or (future, stream_queue) when
        streaming.
        """
        valid = await self.validation.validate(request)

        eos = self.eos_token_ids
        eos_id = (eos[0] if eos else None) if isinstance(eos, (list, tuple)) else eos
        # Admit best_of parallel candidates (ref: llm_service.rs:374-388);
        # the engine returns the top-n by cumulative logprob at finish.
        num_seqs = max(valid.best_of, valid.n, 1)
        sequences = [
            Sequence(
                seq_id=next(_SEQ_COUNTER),
                prompt=valid.inputs,
                prompt_token_ids=list(valid.input_token_ids),
                block_size=self.block_size,
                eos_token_id=eos_id,
            )
            for _ in range(num_seqs)
        ]
        group = SequenceGroup(
            request_id=valid.request_id,
            sequences=sequences,
            next_token_chooser_params=valid.parameters,
            stopping_criteria=valid.stopping_criteria,
            logprobs=valid.logprobs,
            best_of=valid.best_of,
            top_n_tokens=valid.top_n_tokens,
        )
        group.num_return = max(valid.n, 1)
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()
        queue: Optional[asyncio.Queue] = asyncio.Queue() if stream else None
        self.engine.add_request(group, future, queue)
        if stream:
            return future, queue
        return future

    # ----------------------------------------------------------------- warmup
    async def warmup(
        self,
        *,
        num_seqs: Optional[int] = None,
        prompt_len: int = 64,
        max_new: Optional[int] = None,
        waves: int = 2,
    ) -> float:
        """Run the serving steps' first uses before traffic (ref:
        ``atoma_infer_tpu/engine/llm_service.py:458-517``, which compiles
        one program per bucket there). Drives ``waves`` synthetic request
        waves through the FULL engine at the configured steady-state
        shapes: the max-batch prefill and decode buckets, a block-boundary
        table refresh, sampling and detokenize. The last wave's first
        prompt is the longest validation admits beside ``max_new`` tokens,
        so that its chunks fill the scheduler's token budget (the mixed
        steps' widest keys) and its context crosses the page buckets of long
        contexts. Before the waves, one prompt alone at each token bucket up
        to the budget, one new token each: a lone request's prefill step,
        which is what an idle server's next request runs. On the card every
        step of these captures the CUDA graph of its key
        (``engine/cuda_graphs.py``), so traffic at those keys replays them
        from its first step. Under pipeline parallelism each stage captures
        its own graph of the step, the last by the step's key, the others by
        their forward's alone: a stage before the last reaches the traffic's
        keys whatever their sampling options (top-n, sampled rows,
        penalties), which warmup's greedy requests do not ask for.

        Under tensor parallelism, pipelined or not, rank 0's lockstep
        carries the warmup requests to the followers like any other
        admission, so every rank steps the same keys and, on the card,
        captures each in segments between the collectives at the same step
        (its eager first step's collectives are real; a capture makes none).

        Call with the engine loop running (``asyncio.create_task(
        service.engine.run())``). Returns the wall seconds spent.
        """
        S = num_seqs or self.config.scheduler.max_num_sequences
        # Cross at least one block boundary, as the JAX warmup does, so
        # decode steps that take a new block run before traffic too.
        N = max_new or (self.block_size + 2)
        # The longest prompt admitted beside N new tokens: a character is at
        # least one token, and one more may be a BOS.
        limits = self.config.validation
        long_len = min(limits.max_input_tokens, limits.max_total_tokens - N,
                       self.config.scheduler.max_model_len - N) - 1
        rng = np.random.default_rng(0)

        def text(n):
            return bytes(rng.integers(32, 127, size=n, dtype=np.uint8)).decode("latin-1")

        t0 = time.monotonic()
        T = 8
        while T <= min(token_capacity(self.config.scheduler.max_num_batched_tokens),
                       long_len + 1):
            # T − 1 characters: at most T tokens with a BOS, so the T bucket.
            await (await self.handle_request(GenerateRequest(
                request_id=f"_warmup-alone-{T}", inputs=text(T - 1),
                parameters=GenerateParameters(max_new_tokens=1))))
            T *= 2
        for wave in range(waves):
            futs = []
            for i in range(S):
                n = long_len if wave == waves - 1 and i == 0 else prompt_len
                body = text(max(n, prompt_len))
                futs.append(
                    await self.handle_request(
                        GenerateRequest(
                            request_id=f"_warmup-{wave}-{i}",
                            inputs=body,
                            parameters=GenerateParameters(max_new_tokens=N),
                        )
                    )
                )
            await asyncio.gather(*futs)
        dt = time.monotonic() - t0
        logger.info("warmup: %d waves x %d seqs x %d tokens (one prompt of %d) in %.1fs",
                    waves, S, N, max(long_len, prompt_len), dt)
        return dt

    # ---------------------------------------------------------------- shutdown
    def stop(self) -> None:
        """Graceful shutdown (ref: llm_service.rs:404-442). Rank 0 of a
        tensor-parallel service then releases its followers and joins them
        (each within ``FOLLOWER_JOIN_TIMEOUT_S``); a follower that fails or
        does not exit raises here."""
        from .multihost import shutdown

        self.engine.stop()
        self.tokenizer_pool.shutdown()
        if self.lockstep is not None:
            shutdown(self)
            self.lockstep = None
        failed = []
        for p in self.followers:
            p.join(FOLLOWER_JOIN_TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(FOLLOWER_JOIN_TIMEOUT_S)
                failed.append(f"{p.name} did not exit in {FOLLOWER_JOIN_TIMEOUT_S:.0f} s")
            elif p.exitcode != 0:
                failed.append(f"{p.name} exited with code {p.exitcode}")
        self.followers = []
        if failed:
            raise RuntimeError("tensor-parallel ranks failed: " + "; ".join(failed))
        if self.config.model.flush_storage:
            shutil.rmtree(self.config.model.cache_dir, ignore_errors=True)
