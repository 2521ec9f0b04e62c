"""Sampling parameter types.

Mirrors the reference's next-token chooser / stopping-criteria contracts
(ref: backends/vllm/src/validation.rs:415-452) and the vLLM-style
``SamplingParams`` (ref: backends/vllm/src/sampling_params.rs).
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import List, Optional

# Default seed used when the client does not provide one
# (ref: backends/vllm/src/validation.rs:11).
DEFAULT_SEED = 42

# Sampling epsilon used for float comparisons.
_SAMPLING_EPS = 1e-5


class SamplingStrategy(str, Enum):
    """Which sampling transform applies for a request.

    Decided once at admission time, like the reference's per-request
    ``LogitsProcessor`` construction (ref: backends/vllm/src/llm_service.rs:346-372).
    """

    ARGMAX = "argmax"
    ALL = "all"          # pure temperature sampling over the full distribution
    TOP_P = "top_p"
    TOP_K = "top_k"
    TOP_K_THEN_TOP_P = "top_k_then_top_p"


class EarlyStopping(str, Enum):
    """Beam-search early-stopping mode (ref: sampling_params.rs)."""

    TRUE = "true"
    FALSE = "false"
    NEVER = "never"


@dataclasses.dataclass
class NextTokenChooserParameters:
    """Parameters controlling the choice of the next token.

    Ref: backends/vllm/src/validation.rs:415-440.
    """

    temperature: float = 1.0
    top_k: int = 0                 # 0 = disabled
    top_p: float = 1.0             # 1.0 = disabled
    typical_p: float = 1.0         # 1.0 = disabled (locally-typical filtering)
    do_sample: bool = False
    seed: int = DEFAULT_SEED
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    repeat_last_n: int = 64        # window for repetition penalty (ref: model_executor.rs:173-278)

    def strategy(self) -> SamplingStrategy:
        """Classify into the reference's five strategies (llm_service.rs:346-372)."""
        if not self.do_sample or self.temperature <= _SAMPLING_EPS:
            return SamplingStrategy.ARGMAX
        has_top_k = self.top_k > 0
        has_top_p = self.top_p < 1.0 - _SAMPLING_EPS
        if has_top_k and has_top_p:
            return SamplingStrategy.TOP_K_THEN_TOP_P
        if has_top_k:
            return SamplingStrategy.TOP_K
        if has_top_p:
            return SamplingStrategy.TOP_P
        return SamplingStrategy.ALL


@dataclasses.dataclass
class StoppingCriteriaParameters:
    """Stop conditions for generation (ref: validation.rs:444-452)."""

    max_new_tokens: int = 16
    stop_sequences: List[str] = dataclasses.field(default_factory=list)
    ignore_eos_token: bool = False


@dataclasses.dataclass
class SamplingParams:
    """Full vLLM-style sampling parameter bundle.

    The engine works off ``NextTokenChooserParameters`` +
    ``StoppingCriteriaParameters``; this aggregate exists for API parity with the
    reference's exported-but-richer type (ref: backends/vllm/src/sampling_params.rs)
    and is what the server layer constructs from an OpenAI request body.
    """

    n: int = 1
    best_of: Optional[int] = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    typical_p: float = 1.0
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    do_sample: bool = False
    seed: int = DEFAULT_SEED
    max_new_tokens: int = 16
    stop_sequences: List[str] = dataclasses.field(default_factory=list)
    ignore_eos_token: bool = False
    logprobs: bool = False
    top_n_tokens: int = 0
    early_stopping: EarlyStopping = EarlyStopping.FALSE

    @property
    def actual_best_of(self) -> int:
        return self.best_of if self.best_of is not None else self.n

    def next_token_chooser(self) -> NextTokenChooserParameters:
        return NextTokenChooserParameters(
            temperature=self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            typical_p=self.typical_p,
            do_sample=self.do_sample,
            seed=self.seed,
            repetition_penalty=self.repetition_penalty,
            frequency_penalty=self.frequency_penalty,
        )

    def stopping_criteria(self) -> StoppingCriteriaParameters:
        return StoppingCriteriaParameters(
            max_new_tokens=self.max_new_tokens,
            stop_sequences=list(self.stop_sequences),
            ignore_eos_token=self.ignore_eos_token,
        )
