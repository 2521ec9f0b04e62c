"""LRU eviction policy for prefix-cached blocks.

Ref: backends/vllm/src/evictor.rs:6-136 — LRU over an insertion-ordered map
with a max-hashed-tokens tiebreak. The reference declares this but never wires
it in; here it backs ``CachedBlockAllocator``.
"""

from __future__ import annotations

import abc
from typing import Dict, Optional

from .block import PhysicalTokenBlock


class Evictor(abc.ABC):
    """Eviction policy interface (ref: evictor.rs Evictor trait)."""

    @abc.abstractmethod
    def evict(self) -> PhysicalTokenBlock: ...

    @abc.abstractmethod
    def add(self, block: PhysicalTokenBlock) -> None: ...

    @abc.abstractmethod
    def remove_by_hash(self, block_hash: int) -> Optional[PhysicalTokenBlock]: ...

    @property
    @abc.abstractmethod
    def num_blocks(self) -> int: ...


class LRUEvictor(Evictor):
    """Least-recently-used with max num_hashed_tokens tiebreak
    (ref: evictor.rs LRUEvictor)."""

    def __init__(self) -> None:
        # Python dicts are insertion-ordered — equivalent to the reference's
        # IndexMap for iteration order.
        self._table: Dict[int, PhysicalTokenBlock] = {}

    def evict(self) -> PhysicalTokenBlock:
        if not self._table:
            raise ValueError("no blocks to evict")
        victim: Optional[PhysicalTokenBlock] = None
        for block in self._table.values():
            if victim is None or block.last_accessed < victim.last_accessed:
                victim = block
            elif (
                block.last_accessed == victim.last_accessed
                and block.num_hashed_tokens > victim.num_hashed_tokens
            ):
                victim = block
        assert victim is not None and victim.block_hash is not None
        del self._table[victim.block_hash]
        victim.computed = False
        return victim

    def add(self, block: PhysicalTokenBlock) -> None:
        assert block.block_hash is not None
        self._table[block.block_hash] = block

    def remove_by_hash(self, block_hash: int) -> Optional[PhysicalTokenBlock]:
        return self._table.pop(block_hash, None)

    @property
    def num_blocks(self) -> int:
        return len(self._table)
