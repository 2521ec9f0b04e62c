"""Device KV-cache allocation + swap/copy execution.

Counterpart of ``atoma_infer_tpu/engine/cache_engine.py`` (ref:
backends/vllm/src/worker.rs:486-642): owns one paged KV tensor per layer on
the device and a host swap tier, and executes the scheduler's
swap-out / swap-in / copy decisions each step, IN PLACE on the preallocated
tensors.

The host tier is one ``[L, host_blocks, bs, 2·Hk·D]`` tensor in the SAME
dtype as the device cache (pinned when the cache is on CUDA), so a swap round
trip is bit-exact.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import torch

from ..ops.kv_cache import copy_blocks_layer, gather_blocks_layer, scatter_blocks_layer
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
        # One tensor per layer: the model walks them by identity and the
        # kernels write into them in place.
        self.kv_cache: List[torch.Tensor] = [
            torch.zeros((num_device_blocks, block_size, row), dtype=dtype, device=self.device)
            for _ in range(num_layers)
        ]
        self.host_cache = (
            torch.zeros(
                (num_layers, num_host_blocks, block_size, row),
                dtype=dtype,
                pin_memory=self.device.type == "cuda",
            )
            if num_host_blocks > 0
            else None
        )

    @property
    def num_slots(self) -> int:
        return self.num_device_blocks * self.block_size

    # ------------------------------------------------------------------ swaps
    @instrument("cache.swap_out")
    def swap_out(self, mapping: List[Tuple[int, int]]) -> None:
        """Device→host block copies, (device_block, host_block) pairs
        (ref: worker.rs:600-614). Synchronous: the host tier holds the pages
        when this returns."""
        if not mapping or self.host_cache is None:
            return
        dev_ids = [src for src, _ in mapping]
        dst_ids = torch.tensor([dst for _, dst in mapping], dtype=torch.long)
        for layer in range(self.num_layers):
            pages = gather_blocks_layer(self.kv_cache[layer], dev_ids)
            self.host_cache[layer, dst_ids] = pages.cpu()

    @instrument("cache.swap_in")
    def swap_in(self, mapping: List[Tuple[int, int]]) -> None:
        """Host→device block copies, (host_block, device_block) pairs
        (ref: worker.rs:616-630)."""
        if not mapping or self.host_cache is None:
            return
        src_ids = torch.tensor([src for src, _ in mapping], dtype=torch.long)
        dev_ids = [dst for _, dst in mapping]
        for layer in range(self.num_layers):
            scatter_blocks_layer(
                self.kv_cache[layer], dev_ids, self.host_cache[layer, src_ids]
            )

    def copy(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy-on-write block duplication (ref: worker.rs:632-642)."""
        if not pairs:
            return
        for cache in self.kv_cache:
            copy_blocks_layer(cache, pairs)

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
