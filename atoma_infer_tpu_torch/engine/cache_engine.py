"""Device KV-cache allocation + swap/copy execution.

Counterpart of ``atoma_infer_tpu/engine/cache_engine.py`` (ref:
backends/vllm/src/worker.rs:486-642): owns one paged KV tensor per layer on
the device and a host swap tier, and executes the scheduler's
swap-out / swap-in / copy decisions each step, IN PLACE on the preallocated
tensors.

The cache dtype is the model's, ``torch.int8`` (INT8 KV: one
``[pages, bs, 2]`` bf16 scales tensor per layer beside it, ``kv_scales``) or
``torch.float8_e4m3fn`` (scale-free). The host tier is one
``[L, host_blocks, bs, 2·Hk·D]`` tensor in the SAME dtype as the device cache
(plus ``host_scales`` for INT8; pinned when the cache is on CUDA), and swaps
and copies move scales with their pages, so a swap round trip is bit-exact.

Under tensor parallelism each rank's engine holds its own kv heads
(``num_kv_heads`` is the rank's, ``Llama.local_kv_heads``); the INT8 scales
are the same on every rank, as the JAX package replicates them
(``atoma_infer_tpu/engine/cache_engine.py:66-85``), because the model takes
them over every rank's heads.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch

from ..ops.kv_cache import (
    alloc_kv_scales,
    copy_blocks_layer,
    gather_blocks_layer,
    scatter_blocks_layer,
)
from ..utils.tracing import instrument

logger = logging.getLogger(__name__)


class CacheEngine:
    """Owns the paged KV storage on the device + the host swap tier."""

    def __init__(
        self,
        *,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        block_size: int,
        num_device_blocks: int,
        num_host_blocks: int,
        dtype: torch.dtype = torch.bfloat16,
        device="cpu",
    ):
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.block_size = block_size
        self.num_device_blocks = num_device_blocks
        self.num_host_blocks = num_host_blocks
        self.dtype = dtype
        self.device = torch.device(device)

        row = 2 * num_kv_heads * head_dim
        pin = self.device.type == "cuda"
        # One tensor per layer: the model walks them by identity and the
        # kernels write into them in place.
        self.kv_cache: List[torch.Tensor] = [
            torch.zeros((num_device_blocks, block_size, row), dtype=dtype, device=self.device)
            for _ in range(num_layers)
        ]
        # INT8 KV: per-(slot, K/V) dequantization scales, one tensor per layer.
        self.kv_scales: Optional[List[torch.Tensor]] = (
            [alloc_kv_scales(num_device_blocks, block_size, self.device) for _ in range(num_layers)]
            if dtype == torch.int8
            else None
        )
        self.host_cache = (
            torch.zeros(
                (num_layers, num_host_blocks, block_size, row), dtype=dtype, pin_memory=pin
            )
            if num_host_blocks > 0
            else None
        )
        self.host_scales = (
            torch.zeros(
                (num_layers, num_host_blocks, block_size, 2),
                dtype=self.kv_scales[0].dtype, pin_memory=pin,
            )
            if num_host_blocks > 0 and self.kv_scales is not None
            else None
        )

    @property
    def num_slots(self) -> int:
        return self.num_device_blocks * self.block_size

    @property
    def quantized(self) -> bool:
        return self.kv_scales is not None

    def _tiers(self):
        """(device layers, host tier) pairs: the caches, then the scales."""
        yield self.kv_cache, self.host_cache
        if self.kv_scales is not None:
            yield self.kv_scales, self.host_scales

    # ------------------------------------------------------------------ swaps
    @instrument("cache.swap_out")
    def swap_out(self, mapping: List[Tuple[int, int]]) -> None:
        """Device→host block copies, (device_block, host_block) pairs
        (ref: worker.rs:600-614). Synchronous: the host tier holds the pages
        (and their scales) when this returns."""
        if not mapping or self.host_cache is None:
            return
        dev_ids = [src for src, _ in mapping]
        dst_ids = torch.tensor([dst for _, dst in mapping], dtype=torch.long)
        for device_layers, host in self._tiers():
            for layer, cache in enumerate(device_layers):
                host[layer, dst_ids] = gather_blocks_layer(cache, dev_ids).cpu()

    @instrument("cache.swap_in")
    def swap_in(self, mapping: List[Tuple[int, int]]) -> None:
        """Host→device block copies, (host_block, device_block) pairs
        (ref: worker.rs:616-630)."""
        if not mapping or self.host_cache is None:
            return
        src_ids = torch.tensor([src for src, _ in mapping], dtype=torch.long)
        dev_ids = [dst for _, dst in mapping]
        for device_layers, host in self._tiers():
            for layer, cache in enumerate(device_layers):
                scatter_blocks_layer(cache, dev_ids, host[layer, src_ids])

    def copy(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy-on-write block duplication (ref: worker.rs:632-642), scales
        with their pages."""
        if not pairs:
            return
        for device_layers, _ in self._tiers():
            for cache in device_layers:
                copy_blocks_layer(cache, pairs)

    def swap_blocks_to(self, dst: "CacheEngine", mapping: List[Tuple[int, int]]) -> None:
        """Copy whole blocks into ANOTHER cache engine's device buffers,
        (src_block, dst_block) pairs, scales with their pages when both are
        INT8 (JAX ``swap_blocks_to``; the reference's ``swap_blocks`` with
        both tensors on devices, ``cache_manager.rs:18-128``): from one
        stage or device to another. Same-engine moves are :meth:`copy`."""
        if not mapping:
            return
        src_ids = [s for s, _ in mapping]
        dst_ids = [d for _, d in mapping]
        pairs = [(self.kv_cache, dst.kv_cache)]
        if self.kv_scales is not None and dst.kv_scales is not None:
            pairs.append((self.kv_scales, dst.kv_scales))
        for src_layers, dst_layers in pairs:
            for src, out in zip(src_layers, dst_layers):
                scatter_blocks_layer(out, dst_ids, gather_blocks_layer(src, src_ids))

    def execute(
        self,
        blocks_to_swap_in: List[Tuple[int, int]],
        blocks_to_swap_out: List[Tuple[int, int]],
        blocks_to_copy: List[Tuple[int, int]],
    ) -> None:
        """One step's cache maintenance, in the reference's order
        (worker.rs:111-160: swap first, then CoW copies)."""
        self.swap_out(blocks_to_swap_out)
        self.swap_in(blocks_to_swap_in)
        self.copy(blocks_to_copy)
