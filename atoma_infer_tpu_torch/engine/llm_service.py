"""LLM service: startup orchestration + request admission.

Counterpart of ``atoma_infer_tpu/engine/llm_service.py`` (ref:
backends/vllm/src/llm_service.rs): startup (model load → KV profiling →
engine boot, :116-245), the admission path (validate → build
Sequence/SequenceGroup with per-request sampling params → engine, :318-388)
and shutdown (:404-442), on ONE device. The KV pool is sized after the
weights are resident (SURVEY.md §3.1), from ``torch.cuda.mem_get_info``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): multi-host serving, tensor and pipeline parallelism, async
scheduling, speculative decoding, prefix caching, float16 (no kernel takes
fp16 yet), and the native (C++) block manager — the port always uses the
Python one. Weight quantization
(``quantization`` "int8" or "int4", and W8A8 under ``ATOMA_W8A8=1``) is
ported: the loader quantizes on load. So are the KV-cache dtypes
(``kv_cache_dtype`` "int8": an int8 cache with per-(slot, K/V) bf16 scales;
"fp8": an e4m3 cache), chosen as the JAX service chooses them.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import shutil
import time
from typing import Optional

import torch

from ..config import EngineConfig
from ..core.scheduler import Scheduler
from ..sequence import Sequence, SequenceGroup
from ..types import GenerateRequest
from ..utils.device import resolve_device
from ..utils.tracing import instrument
from .cache_engine import CacheEngine
from .llm_engine import LlmEngine
from .tokenizer import TokenizerPool
from .validation import Validation
from .worker import ModelWorker

logger = logging.getLogger(__name__)

_SEQ_COUNTER = itertools.count()

# The dtypes the port's kernels take.
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# KV-cache dtypes by ``kv_cache_dtype``; None keeps the model's dtype.
_KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _load_tokenizer(model_dir: str):
    from tokenizers import Tokenizer

    return Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))


def _reject_unported(config: EngineConfig) -> None:
    """Raise for every configured feature the port does not have yet."""
    m, s, c = config.model, config.scheduler, config.cache
    unported = [
        ((m.num_hosts or 1) > 1, "multi-host serving", "parallelism"),
        (m.tensor_parallel_size > 1, "tensor parallelism", "parallelism"),
        (m.pipeline_parallel_size > 1, "pipeline parallelism", "parallelism"),
        (s.async_scheduling, "async scheduling", "async scheduling depth 2"),
        (s.num_speculative_tokens > 0, "speculative decoding", "speculative decoding"),
        (c.enable_prefix_caching, "prefix caching", "prefix caching"),
        (m.dtype == "float16", "float16", "float16 instantiations of A–H"),
    ]
    for on, what, item in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet (ROADMAP.md, Queue 1: {item})"
            )


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
    ):
        self.config = config
        self.engine = engine
        self.validation = validation
        self.tokenizer_pool = tokenizer_pool
        self.block_size = block_size
        self.eos_token_ids = eos_token_ids

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
    ) -> "LlmService":
        """Build the full stack (ref: llm_service.rs:102-245) on ``device``
        — the current CUDA device unless the caller asks for another
        (``device="cpu"`` in the tests); without a GPU the default raises.

        ``model``/``params``/``tokenizer`` may be injected (tests, the chip
        smoke); an injected model must live on ``device``.
        """
        t0 = time.monotonic()
        device = resolve_device(device)
        _reject_unported(config)
        if model is None or params is None or tokenizer is None:
            if config.model.model_name == "tiny-random":
                from ..entrypoints.offline import build_tiny_random

                model, params, tokenizer = build_tiny_random(device)
            else:
                from ..models.registry import get_model_cls
                from ..models.weights import load_hf_config, load_llama_params

                model_dir = model_dir or resolve_model_dir(config)
                model_cfg = load_hf_config(model_dir)
                dtype = _DTYPES[config.model.dtype]
                model = get_model_cls(model_cfg.architecture or "llama")(
                    model_cfg, dtype=dtype, device=device
                )
                params = load_llama_params(
                    model_dir, model_cfg, dtype=dtype, device=device,
                    quantization=config.model.quantization,
                )
                tokenizer = _load_tokenizer(model_dir)
            logger.info("model loaded in %.1fs", time.monotonic() - t0)
        if model.device != device:
            raise ValueError(f"model is on {model.device}, service on {device}")

        cfg = model.config
        # The KV cache's dtype, as the JAX service picks it: int8 (with
        # scales), e4m3, or the model's own.
        kv_dtype = _KV_DTYPES.get(config.model.kv_cache_dtype, model.dtype)
        # Profile the KV pools AFTER the weights are resident
        # (ref: config.rs:624-625): free device memory ÷ bytes per block,
        # an INT8 cache's scales counted.
        config.cache.profile(
            cfg.num_layers,
            cfg.num_kv_heads,
            cfg.head_dim,
            config.model.kv_dtype_size,
            devices=[device],
            scale_pages=kv_dtype == torch.int8,
        )
        cache_engine = CacheEngine(
            num_layers=cfg.num_layers,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            block_size=config.cache.block_size,
            num_device_blocks=config.cache.num_device_blocks,
            num_host_blocks=config.cache.num_host_blocks or 0,
            dtype=kv_dtype,
            device=device,
        )
        worker = ModelWorker(model, params, cache_engine, config.scheduler, config.cache)
        scheduler = Scheduler(config.scheduler, config.cache)
        tokenizer_pool = TokenizerPool(tokenizer, config.model.num_tokenizer_workers)
        validation = Validation(config.validation, tokenizer_pool)
        engine = LlmEngine(
            scheduler, worker, tokenizer, cfg.eos_token_ids, config.scheduler.max_model_len
        )
        return cls(
            config,
            engine,
            validation,
            tokenizer_pool,
            config.cache.block_size,
            cfg.eos_token_ids,
        )

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

    # ---------------------------------------------------------------- shutdown
    def stop(self) -> None:
        """Graceful shutdown (ref: llm_service.rs:404-442)."""
        self.engine.stop()
        self.tokenizer_pool.shutdown()
        if self.config.model.flush_storage:
            shutil.rmtree(self.config.model.cache_dir, ignore_errors=True)
