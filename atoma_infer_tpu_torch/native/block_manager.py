"""Native-backed BlockSpaceManager — drop-in for core.block_manager.

The port's copy of ``atoma_infer_tpu/native/block_manager.py`` (the same
code; its imports are relative), over the port's own bindings
(``native/__init__.py``).

Same API surface as the Python ``BlockSpaceManager`` (can_allocate/allocate/
append_slots/fork/swap/free/...), with the block bookkeeping state machine in
C++ (csrc/atoma_core.cpp). Selected via ``EngineConfig``/constructor when the
native core builds; equivalence is tested against the Python implementation.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..core.block_manager import AllocationStatus
from ..sequence import Sequence, SequenceGroup, SequenceStatus
from . import load

_STATUS = {
    0: AllocationStatus.OK,
    1: AllocationStatus.LATER,
    2: AllocationStatus.NEVER,
    3: AllocationStatus.NOTHING,
}


def _ids(seqs) -> "ctypes.Array":
    arr = (ctypes.c_int64 * len(seqs))(*[s.seq_id for s in seqs])
    return arr


class NativeBlockSpaceManager:
    """ctypes wrapper mirroring core.block_manager.BlockSpaceManager."""

    def __init__(
        self,
        block_size: int,
        num_device_blocks: int,
        num_host_blocks: int,
        watermark: float = 0.01,
        sliding_window: Optional[int] = None,
        enable_prefix_caching: bool = False,
    ):
        lib = load()
        if lib is None:
            raise RuntimeError("native core unavailable")
        if sliding_window is not None and sliding_window % block_size != 0:
            raise ValueError("sliding_window must be a multiple of block_size")
        self._lib = lib
        self.block_size = block_size
        self.num_total_device_blocks = num_device_blocks
        self.num_total_host_blocks = num_host_blocks
        # Prefix caching is incompatible with sliding-window block reuse
        # (same rule as the Python manager).
        self.enable_prefix_caching = (
            enable_prefix_caching and sliding_window is None
        )
        self._h = lib.abm_create(
            block_size,
            num_device_blocks,
            num_host_blocks,
            watermark,
            sliding_window or -1,
        )
        if self.enable_prefix_caching:
            lib.abm_enable_prefix_caching(self._h, 1)
        self._pair_buf = (ctypes.c_int32 * (2 * (num_device_blocks + 1)))()
        self._table_buf = (ctypes.c_int32 * (num_device_blocks + 1))()

    def __del__(self):  # pragma: no cover - interpreter shutdown order
        try:
            self._lib.abm_destroy(self._h)
        except Exception:
            pass

    # ---------------------------------------------------------------- prompt
    def can_allocate(self, seq_group: SequenceGroup) -> AllocationStatus:
        waiting = seq_group.get_seqs(SequenceStatus.WAITING)
        if not waiting:
            return AllocationStatus.NOTHING
        return _STATUS[
            self._lib.abm_can_allocate(self._h, waiting[0].num_logical_blocks)
        ]

    def allocate(self, seq_group: SequenceGroup) -> None:
        waiting = seq_group.get_seqs(SequenceStatus.WAITING)
        assert waiting
        seq = waiting[0]
        if not self.enable_prefix_caching:
            rc = self._lib.abm_allocate(
                self._h, _ids(waiting), len(waiting), seq.num_logical_blocks
            )
            if rc != 0:
                raise RuntimeError("native allocate failed: pool exhausted")
            return
        # Content-hashed allocation: the C core returns how many LEADING
        # hashable blocks were cache hits already computed — those tokens
        # skip prefill (core.block_manager.BlockSpaceManager.allocate).
        num_hashable = seq.num_full_prompt_blocks
        hashes = (ctypes.c_int64 * max(num_hashable, 1))(
            *[seq.hash_of_block(i) for i in range(num_hashable)]
        )
        rc = self._lib.abm_allocate_cached(
            self._h,
            _ids(waiting),
            len(waiting),
            seq.num_logical_blocks,
            hashes,
            num_hashable,
        )
        if rc < 0:
            raise RuntimeError("native allocate failed: pool exhausted")
        cached = min(rc * self.block_size, seq.get_prompt_len() - 1)
        for s in waiting:
            delta = cached - s.sequence_data.get_num_computed_tokens()
            if delta > 0:
                s.sequence_data.update_num_computed_tokens(delta)

    # ---------------------------------------------------------------- decode
    def can_append_slots(
        self, seq_group: SequenceGroup, num_lookahead_slots: int = 0
    ) -> bool:
        n = seq_group.num_seqs(SequenceStatus.RUNNING)
        return bool(
            self._lib.abm_can_append_slots(self._h, n, num_lookahead_slots)
        )

    def append_slots(
        self, seq: Sequence, num_lookahead_slots: int = 0
    ) -> List[Tuple[int, int]]:
        num_logical = max(
            seq.num_logical_blocks,
            -(-(seq.get_len() + num_lookahead_slots) // self.block_size),
        )
        # The C core appends one block (or CoWs a full table's last block)
        # per call; with lookahead we drive it to the target table length.
        # NOTE: lookahead spanning a SHARED landing block is only CoW-correct
        # in the Python manager — the service forces it whenever speculative
        # decoding is enabled (spec groups are single-sequence, so sharing
        # cannot arise, but the invariant is enforced centrally).
        cur = len(self.get_block_table_ids(seq.seq_id))
        cows: List[Tuple[int, int]] = []
        for _ in range(max(1, num_logical - cur)):
            pair = (ctypes.c_int32 * 2)()
            rc = self._lib.abm_append_slot(
                self._h, seq.seq_id, num_logical, pair
            )
            if rc < 0:
                raise RuntimeError("native append_slot failed")
            if rc == 1:
                cows.append((pair[0], pair[1]))
        return cows

    # ------------------------------------------------------------------ fork
    def fork(self, parent: Sequence, child: Sequence) -> None:
        if self._lib.abm_fork(self._h, parent.seq_id, child.seq_id) != 0:
            raise KeyError(parent.seq_id)

    # ------------------------------------------------------------------ swap
    def can_swap_in(
        self, seq_group: SequenceGroup, num_lookahead_slots: int = 0
    ) -> AllocationStatus:
        seqs = seq_group.get_seqs(SequenceStatus.SWAPPED)
        return _STATUS[
            self._lib.abm_can_swap_in(
                self._h, _ids(seqs), len(seqs), num_lookahead_slots
            )
        ]

    def swap_in(self, seq_group: SequenceGroup) -> List[Tuple[int, int]]:
        seqs = seq_group.get_seqs(SequenceStatus.SWAPPED)
        n = self._lib.abm_swap_in(
            self._h, _ids(seqs), len(seqs), self._pair_buf
        )
        if n < 0:
            raise RuntimeError("native swap_in failed")
        return [
            (self._pair_buf[2 * i], self._pair_buf[2 * i + 1])
            for i in range(n)
        ]

    def can_swap_out(self, seq_group: SequenceGroup) -> bool:
        seqs = seq_group.get_seqs(SequenceStatus.RUNNING)
        return bool(self._lib.abm_can_swap_out(self._h, _ids(seqs), len(seqs)))

    def swap_out(self, seq_group: SequenceGroup) -> List[Tuple[int, int]]:
        seqs = seq_group.get_seqs(SequenceStatus.RUNNING)
        n = self._lib.abm_swap_out(
            self._h, _ids(seqs), len(seqs), self._pair_buf
        )
        if n < 0:
            raise RuntimeError("native swap_out failed")
        return [
            (self._pair_buf[2 * i], self._pair_buf[2 * i + 1])
            for i in range(n)
        ]

    # ------------------------------------------------------------------ free
    def free(self, seq: Sequence) -> None:
        self._lib.abm_free_seq(self._h, seq.seq_id)

    def reset(self) -> None:
        self._lib.abm_reset(self._h)

    # ----------------------------------------------------------------- views
    def has_block_table(self, seq: Sequence) -> bool:
        return bool(self._lib.abm_has_table(self._h, seq.seq_id))

    def last_block_shared(self, seq_id: int) -> bool:
        """True if the sequence's last physical block is shared (forked) —
        the next mid-block append will copy-on-write, consuming one free
        block (scheduler decode fast-path demand precheck)."""
        return bool(self._lib.abm_last_block_shared(self._h, seq_id))

    def get_block_table_ids(self, seq_id: int) -> List[int]:
        n = self._lib.abm_get_table(
            self._h, seq_id, self._table_buf, len(self._table_buf)
        )
        if n < 0:
            raise KeyError(seq_id)
        return list(self._table_buf[:n])

    def get_num_free_device_blocks(self) -> int:
        return self._lib.abm_num_free_device(self._h)

    def get_num_free_host_blocks(self) -> int:
        return self._lib.abm_num_free_host(self._h)

    # ----------------------------------------------------- prefix caching
    def access_all_blocks_in_sequence(self, seq, now: float) -> None:
        self._lib.abm_touch(self._h, seq.seq_id, float(now))

    def compute_full_blocks_in_sequence(self, seq) -> None:
        num_full = (
            seq.sequence_data.get_num_computed_tokens() // self.block_size
        )
        self._lib.abm_mark_computed(self._h, seq.seq_id, num_full)

    def get_all_computed_blocks(self, seq) -> List[int]:
        n = self._lib.abm_computed_prefix(
            self._h, seq.seq_id, self._table_buf, len(self._table_buf)
        )
        return list(self._table_buf[:n])

    def mark_blocks_as_accessed(self, seq_group) -> None:
        import time

        now = time.monotonic()
        for seq in seq_group.get_seqs():
            self.access_all_blocks_in_sequence(seq, now)


def fill_slot_mapping_native(
    table: np.ndarray, block_size: int, start: int, end: int
) -> Optional[np.ndarray]:
    """Native slot-mapping fill; None if the core is unavailable."""
    lib = load()
    if lib is None:
        return None
    table32 = np.ascontiguousarray(table, dtype=np.int32)
    out = np.empty(end - start, dtype=np.int32)
    lib.fill_slot_mapping(
        table32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(table32),
        block_size,
        start,
        end,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
