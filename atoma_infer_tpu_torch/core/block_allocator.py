"""Free-list block allocator with double-free detection.

Ref: backends/vllm/src/block_allocator.rs:18-120 — uncached allocator: pop a
block on allocate (ref_count=1), push back when the refcount hits 0.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional

from .block import BlockDevice, PhysicalTokenBlock
from .evictor import LRUEvictor


class BlockAllocatorError(Exception):
    """Out-of-blocks / double-free errors (ref: block_allocator.rs error enum)."""


class BlockAllocator:
    """Uncached free-list allocator over a fixed pool of physical blocks."""

    def __init__(self, device: BlockDevice, block_size: int, num_blocks: int):
        self.device = device
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.free_blocks: Deque[PhysicalTokenBlock] = deque(
            PhysicalTokenBlock(device, i, block_size) for i in range(num_blocks)
        )

    def allocate(self) -> PhysicalTokenBlock:
        """Pop a free block; ref_count starts at 1 (ref: block_allocator.rs:40-60)."""
        if not self.free_blocks:
            raise BlockAllocatorError(
                f"out of {self.device.name} KV blocks ({self.num_blocks} total)"
            )
        block = self.free_blocks.popleft()
        block.ref_count = 1
        block.computed = False
        block.block_hash = None
        block.num_hashed_tokens = 0
        return block

    def free(self, block: PhysicalTokenBlock) -> None:
        """Drop one reference; return to the free list at zero
        (ref: block_allocator.rs:62-90, double-free detection :80-85)."""
        if block.ref_count == 0:
            raise BlockAllocatorError(
                f"double free of block {block.block_number} on {self.device.name}"
            )
        block.ref_count -= 1
        if block.ref_count == 0:
            self.free_blocks.append(block)

    def get_num_free_blocks(self) -> int:
        return len(self.free_blocks)

    def get_num_total_blocks(self) -> int:
        return self.num_blocks


class CachedBlockAllocator:
    """Prefix-caching allocator: content-hashed blocks with LRU eviction.

    The reference ships the evictor (evictor.rs) as groundwork but never wires
    it in (SURVEY.md §2.2); here it is wired: blocks carrying a content hash
    are kept in an LRU table after their refcount drops to zero and can be
    reused by hash before being evicted for fresh allocations.
    """

    def __init__(self, device: BlockDevice, block_size: int, num_blocks: int):
        self.device = device
        self.block_size = block_size
        self.num_blocks = num_blocks
        self._counter = 0
        self.evictor = LRUEvictor()
        self.cached_blocks: dict[int, PhysicalTokenBlock] = {}
        self.free_blocks: Deque[PhysicalTokenBlock] = deque(
            PhysicalTokenBlock(device, i, block_size) for i in range(num_blocks)
        )

    def allocate(
        self, block_hash: Optional[int] = None, num_hashed_tokens: int = 0
    ) -> PhysicalTokenBlock:
        if block_hash is not None:
            # Cache hit on an in-use block: share it.
            hit = self.cached_blocks.get(block_hash)
            if hit is not None:
                hit.ref_count += 1
                return hit
            # Cache hit on an evictable (refcount-0) block: revive it.
            revived = self.evictor.remove_by_hash(block_hash)
            if revived is not None:
                revived.ref_count = 1
                self.cached_blocks[block_hash] = revived
                return revived
        block = self._allocate_fresh()
        block.block_hash = block_hash
        block.num_hashed_tokens = num_hashed_tokens
        if block_hash is not None:
            self.cached_blocks[block_hash] = block
        return block

    def _allocate_fresh(self) -> PhysicalTokenBlock:
        if self.free_blocks:
            block = self.free_blocks.popleft()
        elif self.evictor.num_blocks > 0:
            block = self.evictor.evict()
            if block.block_hash is not None:
                self.cached_blocks.pop(block.block_hash, None)
        else:
            raise BlockAllocatorError(
                f"out of {self.device.name} KV blocks ({self.num_blocks} total)"
            )
        block.ref_count = 1
        block.computed = False
        block.block_hash = None
        block.num_hashed_tokens = 0
        return block

    def free(self, block: PhysicalTokenBlock) -> None:
        if block.ref_count == 0:
            raise BlockAllocatorError(
                f"double free of block {block.block_number} on {self.device.name}"
            )
        block.ref_count -= 1
        if block.ref_count == 0:
            if block.block_hash is not None:
                self.evictor.add(block)
                self.cached_blocks.pop(block.block_hash, None)
            else:
                self.free_blocks.append(block)

    def get_num_free_blocks(self) -> int:
        return len(self.free_blocks) + self.evictor.num_blocks

    def get_num_total_blocks(self) -> int:
        return self.num_blocks
