"""Scheduling priority policies.

Ref: backends/vllm/src/policy.rs:13-61 — a priority trait with an FCFS
implementation (priority = waiting time), used to sort the running and swapped
queues before each scheduling pass.
"""

from __future__ import annotations

import abc
from collections import deque
from typing import Deque

from ..sequence import SequenceGroup


class Policy(abc.ABC):
    """Priority policy (ref: policy.rs Policy trait)."""

    @abc.abstractmethod
    def get_priority(self, now: float, seq_group: SequenceGroup) -> float:
        """Higher = scheduled first."""

    def sort_by_priority(
        self, now: float, seq_groups: Deque[SequenceGroup]
    ) -> Deque[SequenceGroup]:
        return deque(
            sorted(
                seq_groups,
                key=lambda g: self.get_priority(now, g),
                reverse=True,
            )
        )


class FcfsPolicy(Policy):
    """First-come-first-served: priority = time waited (ref: policy.rs:40-61)."""

    def get_priority(self, now: float, seq_group: SequenceGroup) -> float:
        return now - seq_group.metrics.arrival_time
