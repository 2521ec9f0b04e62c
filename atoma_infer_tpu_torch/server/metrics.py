"""Prometheus metrics — actually exported.

The reference declares 6 instruments but never installs an exporter
(SURVEY.md §5 observability gap); here a minimal dependency-free registry
serves the text exposition format at ``GET /metrics``. Instrument names match
the reference's (llm_service.rs:336-337, llm_engine.rs:314-318,
validation.rs:162,361 — the ``tgi_`` name normalized).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple


class Counter:
    def __init__(self, name: str, help_: str):
        self.name, self.help = name, help_
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n"
            f"# TYPE {self.name} counter\n"
            f"{self.name} {self.value}\n"
        )


class Gauge(Counter):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def expose(self) -> str:
        return (
            f"# HELP {self.name} {self.help}\n"
            f"# TYPE {self.name} gauge\n"
            f"{self.name} {self.value}\n"
        )


class Histogram:
    DEFAULT_BUCKETS = (
        0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
        60.0, 120.0,
    )

    def __init__(self, name: str, help_: str, buckets=None):
        self.name, self.help = name, help_
        self.buckets: Tuple[float, ...] = tuple(buckets or self.DEFAULT_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        cumulative = 0
        for b, c in zip(self.buckets, self.counts):
            cumulative += c
            lines.append(f'{self.name}_bucket{{le="{b}"}} {cumulative}')
        cumulative += self.counts[-1]
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {cumulative}')
        lines.append(f"{self.name}_sum {self.sum}")
        lines.append(f"{self.name}_count {self.total}")
        return "\n".join(lines) + "\n"


class Registry:
    def __init__(self):
        self._metrics: List = []

    def counter(self, name: str, help_: str) -> Counter:
        m = Counter(name, help_)
        self._metrics.append(m)
        return m

    def gauge(self, name: str, help_: str) -> Gauge:
        m = Gauge(name, help_)
        self._metrics.append(m)
        return m

    def histogram(self, name: str, help_: str, buckets=None) -> Histogram:
        m = Histogram(name, help_, buckets)
        self._metrics.append(m)
        return m

    def expose(self) -> str:
        return "".join(m.expose() for m in self._metrics)


REGISTRY = Registry()

# Reference-parity instruments (SURVEY.md §5):
REQUESTS_TOTAL = REGISTRY.counter(
    "llm_service_requests_total", "Total requests received"
)
VALIDATION_TIME = REGISTRY.histogram(
    "llm_service_request_validation_time_seconds", "Request validation time"
)
ARRIVAL_TO_FINISH = REGISTRY.histogram(
    "sequence_group_total_time_seconds",
    "Request arrival to completion",
)
TIME_TO_FIRST_TOKEN = REGISTRY.histogram(
    "sequence_group_time_to_first_token_seconds", "TTFT per request"
)
INPUT_LENGTH = REGISTRY.histogram(
    "request_input_length_tokens",
    "Prompt token counts",
    buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768),
)
MAX_NEW_TOKENS = REGISTRY.histogram(
    "request_max_new_tokens",
    "Requested generation budgets",
    buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
)
RUNNING_SEQS = REGISTRY.gauge(
    "engine_running_sequences", "Sequences in the running queue"
)
GENERATED_TOKENS = REGISTRY.counter(
    "engine_generated_tokens_total", "Total generated tokens"
)
ENGINE_STEPS = REGISTRY.counter(
    "engine_steps_total", "Engine scheduler/dispatch iterations"
)
SCHEDULED_TOKENS = REGISTRY.counter(
    "engine_scheduled_tokens_total",
    "Tokens scheduled into model steps (prefill chunks + decode)",
)
WAITING_SEQS = REGISTRY.gauge(
    "engine_waiting_sequences", "Sequence groups in the waiting queue"
)
PREEMPTIONS = REGISTRY.counter(
    "scheduler_preemptions_total",
    "Sequence groups preempted (recompute or swap) under memory pressure",
)
SPEC_PROPOSED = REGISTRY.counter(
    "engine_spec_tokens_proposed_total",
    "Speculative tokens drafted (engine/spec_decode.py)",
)
SPEC_ACCEPTED = REGISTRY.counter(
    "engine_spec_tokens_accepted_total",
    "Speculative tokens accepted by verification",
)
