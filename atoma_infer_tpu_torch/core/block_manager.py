"""BlockSpaceManager — logical→physical KV block mapping.

Ref: backends/vllm/src/block_manager.rs. Responsibilities: allocate whole-prompt
block tables at admission (:195-237), append one slot per decode step with
copy-on-write when the last block is shared (:294-377), fork for beam/parallel
sampling (:408-446), whole-table swap between device HBM and host RAM
(:585-642, :720-776), sliding-window block reuse modulo window (:202-216,
:320-341), and computed-block tracking for prefix caching (:1045-1119).

Pure bookkeeping — actual KV data movement happens in the executor's
``CacheEngine`` (ref: worker.rs:486-598), driven by the (src, dst) pairs this
module emits.
"""

from __future__ import annotations

import enum
import logging
import time
from typing import Dict, List, Optional, Tuple

from ..sequence import Sequence, SequenceGroup, SequenceStatus
from .block import BlockDevice, BlockTable, PhysicalTokenBlock
from .block_allocator import BlockAllocator

logger = logging.getLogger(__name__)


class AllocationStatus(enum.Enum):
    """Result of a can_allocate / can_swap_in query
    (ref: block_manager.rs:100-121)."""

    OK = enum.auto()        # fits now
    LATER = enum.auto()     # could fit once other requests free blocks
    NEVER = enum.auto()     # larger than the whole pool — impossible
    NOTHING = enum.auto()   # nothing to allocate


class BlockSpaceManager:
    """Maps seq_id → block table over device + host allocators
    (ref: block_manager.rs:41-55)."""

    def __init__(
        self,
        block_size: int,
        num_device_blocks: int,
        num_host_blocks: int,
        watermark: float = 0.01,
        sliding_window: Optional[int] = None,
        enable_prefix_caching: bool = False,
    ):
        if watermark < 0:
            raise ValueError("watermark must be >= 0")
        self.block_size = block_size
        self.num_total_device_blocks = num_device_blocks
        self.num_total_host_blocks = num_host_blocks
        self.watermark_blocks = int(watermark * num_device_blocks)
        # Sliding-window mode: a sequence only ever occupies
        # ceil(window / block_size) physical blocks, reused modulo the window
        # (ref: block_manager.rs:61,202-216).
        self.block_sliding_window: Optional[int] = None
        if sliding_window is not None:
            if sliding_window % block_size != 0:
                raise ValueError(
                    "sliding_window must be a multiple of block_size"
                )
            self.block_sliding_window = sliding_window // block_size
        # Prefix caching is incompatible with sliding-window block reuse
        # (reused physical blocks hold rotating content, not a stable prefix).
        self.enable_prefix_caching = (
            enable_prefix_caching and self.block_sliding_window is None
        )
        if self.enable_prefix_caching:
            from .block_allocator import CachedBlockAllocator

            self.device_allocator = CachedBlockAllocator(
                BlockDevice.DEVICE, block_size, num_device_blocks
            )
        else:
            self.device_allocator = BlockAllocator(
                BlockDevice.DEVICE, block_size, num_device_blocks
            )
        self.host_allocator = BlockAllocator(
            BlockDevice.HOST, block_size, num_host_blocks
        )
        self.block_tables: Dict[int, BlockTable] = {}

    # ------------------------------------------------------------------ util
    def _num_required_blocks(self, seq: Sequence) -> int:
        num = seq.num_logical_blocks
        if self.block_sliding_window is not None:
            num = min(num, self.block_sliding_window)
        return num

    # ------------------------------------------------------- prompt allocation
    def can_allocate(self, seq_group: SequenceGroup) -> AllocationStatus:
        """Whether the group's prompt blocks fit (ref: block_manager.rs:123-145).

        All waiting sequences of a group share one prompt, so the requirement
        is one table's worth of blocks (shared via refcounts).
        """
        waiting = seq_group.get_seqs(SequenceStatus.WAITING)
        if not waiting:
            return AllocationStatus.NOTHING
        num_required = self._num_required_blocks(waiting[0])
        num_free = self.device_allocator.get_num_free_blocks()
        if self.num_total_device_blocks - num_required < self.watermark_blocks:
            return AllocationStatus.NEVER
        if num_free - num_required >= self.watermark_blocks:
            return AllocationStatus.OK
        return AllocationStatus.LATER

    def allocate(self, seq_group: SequenceGroup) -> None:
        """Allocate the prompt's blocks once, shared by every waiting sequence
        with ref_count = #waiting seqs (ref: block_manager.rs:195-237).

        With prefix caching enabled, full prompt blocks are allocated by
        content hash: a hit on an already-computed block makes its tokens
        skip prefill — ``num_computed_tokens`` is advanced to the cached
        prefix (capped so at least one prompt token is always recomputed to
        produce first-step logits)."""
        waiting = seq_group.get_seqs(SequenceStatus.WAITING)
        assert waiting, "allocate() on a group with no waiting sequences"
        seq = waiting[0]
        num_blocks = self._num_required_blocks(seq)
        caching = self.enable_prefix_caching
        num_hashable = seq.num_full_prompt_blocks if caching else 0
        table: BlockTable = []
        for logical_idx in range(num_blocks):
            if (
                self.block_sliding_window is not None
                and logical_idx >= self.block_sliding_window
            ):  # pragma: no cover - num_blocks already capped
                table.append(table[logical_idx % self.block_sliding_window])
                continue
            if caching and logical_idx < num_hashable:
                block = self.device_allocator.allocate(
                    seq.hash_of_block(logical_idx),
                    (logical_idx + 1) * self.block_size,
                )
            else:
                block = self.device_allocator.allocate()
            # allocate() returns the block with one reference (fresh or hit);
            # the group's remaining candidates share it.
            block.ref_count += len(waiting) - 1
            table.append(block)
        for s in waiting:
            self.block_tables[s.seq_id] = list(table)

        if caching:
            cached = 0
            for block in table[:num_hashable]:
                if not block.computed:
                    break
                cached += self.block_size
            # Leave ≥1 token to recompute (its idempotent rewrite into the
            # shared block stores identical content).
            cached = min(cached, seq.get_prompt_len() - 1)
            for s in waiting:
                delta = cached - s.sequence_data.get_num_computed_tokens()
                if delta > 0:
                    s.sequence_data.update_num_computed_tokens(delta)

    # ----------------------------------------------------------- decode append
    def can_append_slots(
        self, seq_group: SequenceGroup, num_lookahead_slots: int = 0
    ) -> bool:
        """Conservative check: worst case each running seq needs one new block
        per step (ref: block_manager.rs:254-283)."""
        num_free = self.device_allocator.get_num_free_blocks()
        num_running = seq_group.num_seqs(SequenceStatus.RUNNING)
        # Worst case per seq: one block for the normal append, plus the span
        # of the lookahead (speculative) slots, plus one CoW copy.
        blocks_per_seq = 1 + -(-num_lookahead_slots // self.block_size)
        if num_lookahead_slots:
            blocks_per_seq += 1
        return num_running * blocks_per_seq <= num_free

    def append_slots(
        self, seq: Sequence, num_lookahead_slots: int = 0
    ) -> List[Tuple[int, int]]:
        """Ensure physical slots exist for the sequence's next token plus
        ``num_lookahead_slots`` speculative tokens (engine/spec_decode.py
        drafts; the extra slots hold drafted tokens' KV during verification
        and are rewritten at the positions rejected drafts occupied).

        Returns copy-on-write (src_block, dst_block) pairs when a shared
        block the new tokens land in had to be copied
        (ref: block_manager.rs:294-377).
        """
        table = self.block_tables[seq.seq_id]
        num_logical = -(
            -(seq.get_len() + num_lookahead_slots) // self.block_size
        )
        if self.block_sliding_window is not None:
            num_logical = max(num_logical, len(table))

        # Copy-on-write any shared existing block the new tokens land in
        # (without lookahead this is exactly the reference's last-block
        # check; lookahead can span into the next block too).
        cows: List[Tuple[int, int]] = []
        first_write = (seq.get_len() - 1) // self.block_size
        if self.block_sliding_window is not None:
            first_write = min(first_write, len(table) - 1)
        for idx in range(first_write, min(num_logical, len(table))):
            block = table[idx]
            assert block.device is BlockDevice.DEVICE
            if block.ref_count == 1:
                continue
            new_block = self.device_allocator.allocate()
            table[idx] = new_block
            self.device_allocator.free(block)
            cows.append((block.block_number, new_block.block_number))

        while len(table) < num_logical:
            if (
                self.block_sliding_window is not None
                and len(table) >= self.block_sliding_window
            ):
                # Reuse a block modulo the window (ref: block_manager.rs:320-341).
                table.append(table[len(table) % self.block_sliding_window])
            else:
                table.append(self.device_allocator.allocate())
        return cows

    # ------------------------------------------------------------------- fork
    def fork(self, parent: Sequence, child: Sequence) -> None:
        """Child shares the parent's physical blocks (ref: block_manager.rs:408-446)."""
        src = self.block_tables[parent.seq_id]
        self.block_tables[child.seq_id] = list(src)
        seen = set()
        for block in src:
            if id(block) in seen:  # sliding-window tables repeat blocks
                continue
            seen.add(id(block))
            block.ref_count += 1

    # ------------------------------------------------------------------- swap
    def can_swap_in(
        self, seq_group: SequenceGroup, num_lookahead_slots: int = 0
    ) -> AllocationStatus:
        """Gate swap-in on free device blocks (ref: block_manager.rs:522-575)."""
        blocks_needed = 0
        num_swapped = 0
        seen = set()
        for seq in seq_group.get_seqs(SequenceStatus.SWAPPED):
            num_swapped += 1
            for block in self.block_tables[seq.seq_id]:
                if id(block) not in seen:
                    seen.add(id(block))
                    blocks_needed += 1
        if blocks_needed == 0:
            return AllocationStatus.NOTHING
        # One extra block per seq as decode headroom, like append_slots.
        num_required = blocks_needed + num_swapped * (1 + num_lookahead_slots)
        if num_required > self.num_total_device_blocks:
            return AllocationStatus.NEVER
        if self.device_allocator.get_num_free_blocks() - num_required >= (
            self.watermark_blocks
        ):
            return AllocationStatus.OK
        return AllocationStatus.LATER

    def swap_in(self, seq_group: SequenceGroup) -> List[Tuple[int, int]]:
        """Remap host→device; returns (host_block, device_block) pairs for the
        cache engine (ref: block_manager.rs:585-642)."""
        mapping: Dict[PhysicalTokenBlock, PhysicalTokenBlock] = {}
        for seq in seq_group.get_seqs(SequenceStatus.SWAPPED):
            new_table: BlockTable = []
            for host_block in self.block_tables[seq.seq_id]:
                dev_block = mapping.get(host_block)
                if dev_block is None:
                    dev_block = self.device_allocator.allocate()
                    mapping[host_block] = dev_block
                else:
                    dev_block.ref_count += 1
                new_table.append(dev_block)
                self.host_allocator.free(host_block)
            self.block_tables[seq.seq_id] = new_table
        return [
            (host.block_number, dev.block_number)
            for host, dev in mapping.items()
        ]

    def can_swap_out(self, seq_group: SequenceGroup) -> bool:
        """Whether the group's device blocks fit in host RAM
        (ref: block_manager.rs:667-700)."""
        seen = set()
        blocks_needed = 0
        for seq in seq_group.get_seqs(SequenceStatus.RUNNING):
            for block in self.block_tables[seq.seq_id]:
                if id(block) not in seen:
                    seen.add(id(block))
                    blocks_needed += 1
        return blocks_needed <= self.host_allocator.get_num_free_blocks()

    def swap_out(self, seq_group: SequenceGroup) -> List[Tuple[int, int]]:
        """Remap device→host; returns (device_block, host_block) pairs
        (ref: block_manager.rs:720-776)."""
        mapping: Dict[PhysicalTokenBlock, PhysicalTokenBlock] = {}
        for seq in seq_group.get_seqs(SequenceStatus.RUNNING):
            new_table: BlockTable = []
            for dev_block in self.block_tables[seq.seq_id]:
                host_block = mapping.get(dev_block)
                if host_block is None:
                    host_block = self.host_allocator.allocate()
                    mapping[dev_block] = host_block
                else:
                    host_block.ref_count += 1
                new_table.append(host_block)
                self.device_allocator.free(dev_block)
            self.block_tables[seq.seq_id] = new_table
        return [
            (dev.block_number, host.block_number)
            for dev, host in mapping.items()
        ]

    # ------------------------------------------------------------------- free
    def _free_table(self, table: BlockTable) -> None:
        seen = set()
        for block in table:
            if id(block) in seen:
                continue
            seen.add(id(block))
            if block.device is BlockDevice.DEVICE:
                self.device_allocator.free(block)
            else:
                self.host_allocator.free(block)

    def free(self, seq: Sequence) -> None:
        """Release a finished/preempted sequence's blocks
        (ref: block_manager.rs:870-905)."""
        table = self.block_tables.pop(seq.seq_id, None)
        if table is None:
            return  # already freed (e.g. abort after finish)
        self._free_table(table)

    def reset(self) -> None:
        """Free everything (ref: block_manager.rs:958)."""
        for table in self.block_tables.values():
            self._free_table(table)
        self.block_tables.clear()

    # ------------------------------------------------------------------- views
    def has_block_table(self, seq: Sequence) -> bool:
        return seq.seq_id in self.block_tables

    def get_block_table_ids(self, seq_id: int) -> List[int]:
        """Physical block numbers backing a sequence
        (ref: block_manager.rs:408 ``get_block_table_ids``)."""
        return [b.block_number for b in self.block_tables[seq_id]]

    def last_block_shared(self, seq_id: int) -> bool:
        """True if the sequence's last physical block is shared (forked) —
        the next mid-block append will copy-on-write, consuming one free
        block (scheduler decode fast-path demand precheck)."""
        table = self.block_tables.get(seq_id)
        return bool(table) and table[-1].ref_count > 1

    def get_num_free_device_blocks(self) -> int:
        return self.device_allocator.get_num_free_blocks()

    def get_num_free_host_blocks(self) -> int:
        return self.host_allocator.get_num_free_blocks()

    # ----------------------------------------- prefix-caching groundwork
    def access_all_blocks_in_sequence(self, seq: Sequence, now: float) -> None:
        """Touch access times for LRU (ref: block_manager.rs:1045-1070)."""
        for block in self.block_tables.get(seq.seq_id, ()):
            block.last_accessed = now

    def compute_full_blocks_in_sequence(self, seq: Sequence) -> None:
        """Mark fully-written blocks computed (ref: block_manager.rs:1072-1100)."""
        table = self.block_tables.get(seq.seq_id)
        if table is None:
            return
        num_full = seq.sequence_data.get_num_computed_tokens() // self.block_size
        for block in table[:num_full]:
            block.computed = True

    def get_all_computed_blocks(self, seq: Sequence) -> List[int]:
        """Longest computed prefix of the table (ref: block_manager.rs:1102-1119)."""
        table = self.block_tables.get(seq.seq_id)
        if table is None:
            return []
        out: List[int] = []
        for block in table:
            if not block.computed:
                break
            out.append(block.block_number)
        return out

    def mark_blocks_as_accessed(self, seq_group: SequenceGroup) -> None:
        now = time.monotonic()
        for seq in seq_group.get_seqs():
            self.access_all_blocks_in_sequence(seq, now)
