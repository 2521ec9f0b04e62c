"""Physical KV block bookkeeping types.

Ref: backends/vllm/src/block.rs:140-295. The reference also materializes
``LogicalTokenBlock`` lists per sequence (block.rs:35-131); here logical block
counts are derived arithmetically from sequence lengths (see
``Sequence.num_logical_blocks``) — the physical table is the real state.

No locks: the engine loop is single-threaded (the reference's
``Arc<RwLock<…>>`` exists because Rust requires it even for its effectively
single-threaded access pattern, SURVEY.md §5).
"""

from __future__ import annotations

import enum
from typing import List


class BlockDevice(enum.Enum):
    """Where a physical block lives: TPU HBM or host RAM (swap tier).

    Ref: block.rs Device enum — GPU/CPU becomes DEVICE/HOST.
    """

    DEVICE = enum.auto()
    HOST = enum.auto()


class PhysicalTokenBlock:
    """A slot in the paged KV cache (ref: block.rs:140-258)."""

    __slots__ = (
        "device",
        "block_number",
        "block_size",
        "ref_count",
        "computed",
        "last_accessed",
        "num_hashed_tokens",
        "block_hash",
    )

    def __init__(self, device: BlockDevice, block_number: int, block_size: int):
        self.device = device
        self.block_number = block_number
        self.block_size = block_size
        self.ref_count = 0
        # Prefix-caching groundwork (ref: block.rs computed/last_accessed/
        # num_hashed_tokens fields; wired into BlockSpaceManager's
        # computed-block tracking, block_manager.rs:1045-1119).
        self.computed = False
        self.last_accessed: float = 0.0
        self.num_hashed_tokens = 0
        self.block_hash: int | None = None

    def is_shared(self) -> bool:
        return self.ref_count > 1

    def __repr__(self) -> str:
        return (
            f"PhysicalTokenBlock({self.device.name}, num={self.block_number}, "
            f"refs={self.ref_count})"
        )


# A sequence's block table: ordered physical blocks backing its logical blocks
# (ref: block.rs:16 ``BlockTable``).
BlockTable = List[PhysicalTokenBlock]
