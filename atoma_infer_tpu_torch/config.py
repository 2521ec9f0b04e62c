"""Configuration system: TOML sections + runtime memory profiling.

Mirrors the reference's layered config (ref: backends/vllm/src/config.rs):
TOML sections ``[inference] [cache] [scheduler] [validation]``
(:73-83,163-223,436-451,477-488), env-file alternative (:86-132), scheduler
invariant checks (:388-406), and runtime profiling that sizes the KV block
pools from free accelerator memory (:590-643) via ``torch.cuda.mem_get_info``
(the reference's ``cudaMemGetInfo``).

The PyTorch port's copy of ``atoma_infer_tpu/config.py``: the dataclasses are
identical; the free-device-memory probe differs, and so does the INT8 KV
scale storage that ``CacheConfig.block_bytes`` counts (two bf16 per slot,
not the TPU's 128-lane page). ``tensor_parallel_size`` > 1 runs one
process per rank (``LlmService.start``), and ``num_hosts``, ``host_id``
and ``coordinator_address`` spread the ranks over hosts;
``pipeline_parallel_size`` > 1 splits the layers into stages, each rank
holding every stage (``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tomllib
from typing import List, Optional

logger = logging.getLogger(__name__)

_DTYPE_SIZES = {
    "bfloat16": 2,
    "float16": 2,
    "float32": 4,
    "int8": 1,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
}


@dataclasses.dataclass
class ModelConfig:
    """``[inference]`` section (ref: config.rs:73-160)."""

    model_name: str = "meta-llama/Llama-3.2-1B"
    dtype: str = "bfloat16"
    revision: str = "main"
    cache_dir: str = "./.weights_cache"
    api_key: Optional[str] = None
    flush_storage: bool = False
    num_tokenizer_workers: int = 4
    # The CUDA devices a host's tensor-parallel ranks use, in order (the
    # reference's device-id list, config.rs device_ids). None = every
    # local device; ranks share cards when there are fewer than ranks.
    num_devices: Optional[int] = None
    # Tensor parallelism: one process per rank, each holding its shard of
    # the weights and kv heads (parallel/sharding.py), collectives over
    # torch.distributed (parallel/group.py: nccl with a card per rank,
    # gloo through host memory when ranks share a card, gloo on the CPU).
    tensor_parallel_size: int = 1
    # Pipeline parallelism (beyond the reference, SURVEY.md §2.6): layers
    # split into contiguous stages, each with its own device and KV cache;
    # the engine pipelines per-cohort steps across stages
    # (parallel/pipeline.py, engine/pp_worker.py). Under tensor parallelism
    # each rank holds its shard of every stage.
    pipeline_parallel_size: int = 1
    # Multi-host serving (BASELINE config #5): each host runs
    # tensor_parallel_size / num_hosts of the ranks (rank = host_id ·
    # local + i), all joining the rendezvous at coordinator_address
    # ("host:port"); the scheduler is replicated on every rank and rank 0
    # broadcasts each step's admissions (parallel/distributed.py,
    # engine/multihost.py). num_hosts None/1 = single-host.
    num_hosts: Optional[int] = None
    host_id: Optional[int] = None
    coordinator_address: Optional[str] = None
    # Weight-only quantization: None | "int8" | "int4" (beyond the reference —
    # required by BASELINE.json configs #3-5).
    quantization: Optional[str] = None
    # KV-cache quantization: None | "int8" | "fp8".
    kv_cache_dtype: Optional[str] = None

    def __post_init__(self) -> None:
        if self.dtype not in _DTYPE_SIZES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.quantization not in (None, "int8", "int4"):
            raise ValueError(f"unsupported quantization {self.quantization!r}")
        if self.kv_cache_dtype not in (None, "int8", "fp8"):
            raise ValueError(f"unsupported kv_cache_dtype {self.kv_cache_dtype!r}")
        if self.pipeline_parallel_size < 1:
            raise ValueError("pipeline_parallel_size must be >= 1")

    @property
    def dtype_size(self) -> int:
        return _DTYPE_SIZES[self.dtype]

    @property
    def kv_dtype_size(self) -> int:
        if self.kv_cache_dtype in ("int8", "fp8"):
            return 1
        return self.dtype_size


@dataclasses.dataclass
class CacheConfig:
    """``[cache]`` section + derived block pool sizes (ref: config.rs:163-330).

    ``num_device_blocks``/``num_host_blocks`` are filled by :func:`profile` at
    startup (after weights are resident — same two-phase ordering constraint as
    the reference, SURVEY.md §3.1) unless overridden.
    """

    block_size: int = 16
    # Fraction of TPU HBM the KV cache may use out of what is free after
    # weight loading (ref: gpu_memory_utilization, config.rs:186).
    hbm_memory_utilization: float = 0.9
    # Fraction of free host RAM for the swap tier (ref: config.rs:523-549).
    swap_space_fraction: float = 0.1
    num_device_blocks_override: Optional[int] = None
    num_host_blocks_override: Optional[int] = None
    sliding_window: Optional[int] = None
    # Content-hash prefix caching over the device block pool (the reference
    # ships its evictor unwired — block_manager.rs:1045-1119; here it is
    # end-to-end: cached prompt blocks skip prefill compute).
    enable_prefix_caching: bool = False
    # Filled in by profiling:
    num_device_blocks: Optional[int] = None
    num_host_blocks: Optional[int] = None

    def __post_init__(self) -> None:
        if self.block_size <= 0 or self.block_size % 8 != 0:
            # TPU lane tiling wants block_size multiples of 8 (sublane dim).
            raise ValueError("block_size must be a positive multiple of 8")
        if not 0.0 < self.hbm_memory_utilization <= 1.0:
            raise ValueError("hbm_memory_utilization must be in (0, 1]")
        # Host swap sizing guardrails (ref: config.rs:523-549).
        if self.swap_space_fraction > 0.7:
            raise ValueError(
                "swap_space_fraction too large — refusing >70% of free host RAM"
            )
        if self.swap_space_fraction > 0.4:
            logger.warning(
                "swap_space_fraction %.2f uses >40%% of free host RAM",
                self.swap_space_fraction,
            )
        if self.num_device_blocks_override is not None:
            self.num_device_blocks = self.num_device_blocks_override
        if self.num_host_blocks_override is not None:
            self.num_host_blocks = self.num_host_blocks_override

    @classmethod
    def new_from_blocks(
        cls,
        block_size: int,
        num_device_blocks: int,
        num_host_blocks: int,
        sliding_window: Optional[int] = None,
    ) -> "CacheConfig":
        """Test-only constructor bypassing profiling
        (ref: config.rs:229-256 ``CacheConfig::new_from_blocks``)."""
        cfg = cls(block_size=block_size, sliding_window=sliding_window)
        cfg.num_device_blocks = num_device_blocks
        cfg.num_host_blocks = num_host_blocks
        return cfg

    # -- profiling -------------------------------------------------------------
    def block_bytes(
        self,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        kv_dtype_size: int,
        scale_pages: bool = False,
    ) -> int:
        """Bytes of one KV block across all layers: K+V (ref: config.rs:708-718).

        With ``scale_pages`` (INT8 KV) a block also carries its scales: two
        bf16 per slot per layer (K and V, ``ops/kv_cache.py``
        ``alloc_kv_scales``), the bytes the port allocates. FP8 stores e4m3
        scale-free. (The JAX package counts a 128-lane bf16 scale page per
        slot, its Mosaic DMA layout, and counts it for FP8 too.)"""
        kv = 2 * self.block_size * num_layers * num_kv_heads * head_dim * kv_dtype_size
        if scale_pages:
            kv += self.block_size * 2 * 2 * num_layers
        return kv

    def profile(
        self,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        kv_dtype_size: int,
        devices: Optional[list] = None,
        scale_pages: bool = False,
        reserve_bytes: int = 0,
        share: int = 1,
    ) -> None:
        """Size the device/host block pools from live memory stats.

        The reference's per-device ``cudaMemGetInfo`` scan
        (config.rs:590-643), through ``torch.cuda.mem_get_info``: takes the
        minimum free device memory across devices, less ``reserve_bytes``
        (what the decode steps' CUDA graphs will hold), ×
        ``hbm_memory_utilization`` ÷ ``share`` (the tensor-parallel ranks
        still to size their pools on the same card, this one included) ÷
        per-block bytes (an INT8 cache's scales counted when
        ``scale_pages``). Must run AFTER weights are loaded so "free"
        reflects weight residency.
        """
        per_block = self.block_bytes(
            num_layers, num_kv_heads, head_dim, kv_dtype_size, scale_pages
        )

        if self.num_device_blocks is None:
            free = _min_free_device_memory(devices)
            if free is None:
                # CPU fallback mirroring the reference's CUDA-absent path
                # (block_manager.rs:63-76): small fixed pool for tests.
                logger.warning(
                    "no device memory stats available — defaulting to 512 blocks"
                )
                self.num_device_blocks = 512
            else:
                self.num_device_blocks = int(
                    max(0, free - reserve_bytes) * self.hbm_memory_utilization / share
                    // per_block
                )
        if self.num_host_blocks is None:
            free_ram = _free_host_memory()
            self.num_host_blocks = int(
                free_ram * self.swap_space_fraction // per_block
            )
        logger.info(
            "KV cache profile: %d device blocks, %d host blocks (%d bytes/block)",
            self.num_device_blocks,
            self.num_host_blocks,
            per_block,
        )


def _min_free_device_memory(devices: Optional[list] = None) -> Optional[int]:
    """Minimum free CUDA memory across ``devices`` (torch devices or
    indices; default: the current device), or None when no device is CUDA
    — the CPU path then takes the fixed test pool in :meth:`CacheConfig.profile`.

    ``torch.cuda.mem_get_info`` reports the driver's free bytes; PyTorch's
    caching allocator keeps blocks it has freed reserved, so those count as
    free here too (they are reusable by the KV cache allocation)."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            return None
        devices = [torch.cuda.current_device()]
    frees: List[int] = []
    for d in devices:
        d = torch.device(d) if not isinstance(d, int) else torch.device("cuda", d)
        if d.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(d)
        reserved_idle = torch.cuda.memory_reserved(d) - torch.cuda.memory_allocated(d)
        frees.append(int(free) + int(reserved_idle))
    return min(frees) if frees else None


def _free_host_memory() -> int:
    """Free host RAM in bytes (ref: sys-info usage, config.rs:667-684)."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):  # pragma: no cover - non-POSIX
        return 8 << 30


@dataclasses.dataclass
class SchedulerConfig:
    """``[scheduler]`` section (ref: config.rs:333-433)."""

    max_num_batched_tokens: int = 2048
    max_num_sequences: int = 256
    max_model_len: int = 4096
    delay_factor: float = 0.0
    enable_chunked_prefill: bool = False
    # Host-side native (C++) block-manager core; falls back to the Python
    # implementation when the toolchain is unavailable.
    use_native_core: bool = True
    # Speculative decoding (engine/spec_decode.py): 0 disables; N > 0 drafts
    # up to N tokens per greedy decode step by n-gram prompt lookup and
    # verifies them in one forward. (The reference carries only spec-decode
    # metric types — sequence.rs:2131-2154; this makes the feature real.)
    num_speculative_tokens: int = 0
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # Async scheduling (vLLM-v1 style): schedule + dispatch step N+1 before
    # step N's sampled tokens reach the host — decode rows read their input
    # token from the previous step's device-resident output, so host work
    # (schedule, input prep, detokenize, stop checks) overlaps device
    # execution. Single-cohort engines only; steps that need token VALUES on
    # the host (penalties, spec drafts, recompute prefills) drop to the
    # synchronous path automatically (engine/llm_engine.py).
    async_scheduling: bool = False
    # Number of steps kept in flight when async scheduling is on. Depth 2
    # additionally hides the device→host token fetch behind a full host
    # iteration — on remote/tunneled TPU runtimes that round trip is the
    # single biggest per-step host cost. Cost: stop conditions detected
    # ``depth`` steps late (that many sampled-and-discarded tokens per
    # finishing sequence).
    async_depth: int = 2

    def __post_init__(self) -> None:
        # Invariant checks (ref: config.rs:388-406).
        if self.num_speculative_tokens < 0:
            raise ValueError("num_speculative_tokens must be >= 0")
        if self.num_speculative_tokens and not (
            1 <= self.spec_ngram_min <= self.spec_ngram_max
        ):
            raise ValueError("need 1 <= spec_ngram_min <= spec_ngram_max")
        if self.max_num_batched_tokens < self.max_num_sequences:
            raise ValueError(
                f"max_num_batched_tokens ({self.max_num_batched_tokens}) must be "
                f">= max_num_sequences ({self.max_num_sequences})"
            )
        if (
            not self.enable_chunked_prefill
            and self.max_num_batched_tokens < self.max_model_len
        ):
            raise ValueError(
                f"max_num_batched_tokens ({self.max_num_batched_tokens}) is "
                f"smaller than max_model_len ({self.max_model_len}); prompts "
                "that long could never be scheduled — enable chunked prefill "
                "or raise the token budget"
            )
        if self.delay_factor < 0:
            raise ValueError("delay_factor must be >= 0")


@dataclasses.dataclass
class ValidationConfig:
    """``[validation]`` section (ref: config.rs:477-488, validation.rs)."""

    best_of: int = 1
    max_stop_sequences: int = 4
    max_top_n_tokens: int = 5
    max_input_tokens: int = 4096
    max_total_tokens: int = 8192

    def __post_init__(self) -> None:
        if self.max_input_tokens >= self.max_total_tokens:
            raise ValueError("max_input_tokens must be < max_total_tokens")


@dataclasses.dataclass
class EngineConfig:
    """All four sections bundled."""

    model: ModelConfig
    cache: CacheConfig
    scheduler: SchedulerConfig
    validation: ValidationConfig

    def __post_init__(self) -> None:
        # Cross-section invariants.
        if (
            self.scheduler.num_speculative_tokens
            and self.model.pipeline_parallel_size > 1
        ):
            raise ValueError(
                "speculative decoding is not supported with pipeline "
                "parallelism (num_speculative_tokens requires "
                "pipeline_parallel_size == 1)"
            )
        if (
            self.scheduler.num_speculative_tokens
            and self.cache.sliding_window is not None
        ):
            # Block-level window reuse maps lookahead slots modulo the
            # window; a rejected draft's KV write can then have displaced a
            # row still INSIDE the attention window (wraps when ≥2 drafts
            # are rejected past the window boundary) — silent corruption,
            # so reject the combination outright. Model-level per-layer
            # windows (gemma2) keep full tables and are unaffected.
            raise ValueError(
                "speculative decoding is not supported with a block-level "
                "sliding window (cache.sliding_window)"
            )

    @classmethod
    def from_file_path(cls, path: str) -> "EngineConfig":
        """Parse the four TOML sections (ref: config.rs:73-83 et al.)."""
        with open(path, "rb") as f:
            raw = tomllib.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "EngineConfig":
        return cls(
            model=ModelConfig(**raw.get("inference", {})),
            cache=CacheConfig(**raw.get("cache", {})),
            scheduler=SchedulerConfig(**raw.get("scheduler", {})),
            validation=ValidationConfig(**raw.get("validation", {})),
        )

    @classmethod
    def from_env(cls) -> "EngineConfig":
        """Env-var alternative (ref: config.rs:86-132 ``from_env_file``)."""

        def _get(name: str, cast, default):
            v = os.environ.get(name)
            return cast(v) if v is not None else default

        model = ModelConfig(
            model_name=_get("MODEL_NAME", str, ModelConfig.model_name),
            dtype=_get("DTYPE", str, ModelConfig.dtype),
            revision=_get("REVISION", str, ModelConfig.revision),
            cache_dir=_get("CACHE_DIR", str, ModelConfig.cache_dir),
            api_key=os.environ.get("HF_API_KEY"),
            flush_storage=_get("FLUSH_STORAGE", lambda s: s == "true", False),
        )
        cache = CacheConfig(
            block_size=_get("BLOCK_SIZE", int, CacheConfig.block_size),
            hbm_memory_utilization=_get(
                "HBM_MEMORY_UTILIZATION", float, CacheConfig.hbm_memory_utilization
            ),
            swap_space_fraction=_get(
                "SWAP_SPACE_FRACTION", float, CacheConfig.swap_space_fraction
            ),
        )
        sched = SchedulerConfig(
            max_num_batched_tokens=_get(
                "MAX_NUM_BATCHED_TOKENS", int, SchedulerConfig.max_num_batched_tokens
            ),
            max_num_sequences=_get(
                "MAX_NUM_SEQUENCES", int, SchedulerConfig.max_num_sequences
            ),
            max_model_len=_get("MAX_MODEL_LEN", int, SchedulerConfig.max_model_len),
            enable_chunked_prefill=_get(
                "ENABLE_CHUNKED_PREFILL", lambda s: s == "true", False
            ),
            num_speculative_tokens=_get(
                "NUM_SPECULATIVE_TOKENS",
                int,
                SchedulerConfig.num_speculative_tokens,
            ),
        )
        valid = ValidationConfig()
        return cls(model=model, cache=cache, scheduler=sched, validation=valid)
