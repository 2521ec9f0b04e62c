"""Core scheduling + paged-KV bookkeeping (ref: backends/vllm/src/)."""

from .block import BlockDevice, PhysicalTokenBlock
from .block_allocator import BlockAllocator, BlockAllocatorError
from .block_manager import AllocationStatus, BlockSpaceManager
from .policy import FcfsPolicy, Policy
from .scheduler import Scheduler, SchedulerOutputs, SchedulingBudget

__all__ = [
    "AllocationStatus",
    "BlockAllocator",
    "BlockAllocatorError",
    "BlockDevice",
    "BlockSpaceManager",
    "FcfsPolicy",
    "PhysicalTokenBlock",
    "Policy",
    "Scheduler",
    "SchedulerOutputs",
    "SchedulingBudget",
]
