"""Request validation: parameter range checks + tokenization + budgets.

Ref: backends/vllm/src/validation.rs — temperature > 0, 0 < top_p <= 1,
frequency_penalty ∈ [−2, 2], stop-sequence count, truncate, top_n_tokens,
best_of×sampling interplay (:187-377); tokenizes via the worker pool and
computes ``max_new_tokens`` default = max_total_tokens − input_len
(:133-137); emits ``ValidGenerateRequest`` (:342-376).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..config import ValidationConfig
from ..sampling_params import (
    DEFAULT_SEED,
    NextTokenChooserParameters,
    StoppingCriteriaParameters,
)
from ..types import GenerateParameters, GenerateRequest
from .tokenizer import TokenizerPool


class ValidationError(ValueError):
    """A request failed validation (maps to HTTP 422)."""


@dataclasses.dataclass
class ValidGenerateRequest:
    """Validated request ready for admission (ref: validation.rs:342-376)."""

    request_id: str
    inputs: str
    input_token_ids: List[int]
    parameters: NextTokenChooserParameters
    stopping_criteria: StoppingCriteriaParameters
    best_of: int
    logprobs: bool
    top_n_tokens: int
    n: int = 1


class Validation:
    """Validates and tokenizes incoming requests (ref: validation.rs:40-180)."""

    def __init__(self, config: ValidationConfig, tokenizer_pool: TokenizerPool):
        self.config = config
        self.tokenizers = tokenizer_pool

    def _check_params(self, p: GenerateParameters) -> None:
        # (ref: validation.rs:187-377)
        if p.temperature is not None and p.temperature <= 0.0:
            raise ValidationError("temperature must be strictly positive")
        if p.top_p is not None and not (0.0 < p.top_p <= 1.0):
            raise ValidationError("top_p must be in (0, 1]")
        if p.typical_p is not None and not (0.0 < p.typical_p <= 1.0):
            raise ValidationError("typical_p must be in (0, 1]")
        if p.top_k is not None and p.top_k < 0:
            raise ValidationError("top_k must be >= 0")
        if p.repetition_penalty is not None and p.repetition_penalty <= 0.0:
            raise ValidationError("repetition_penalty must be strictly positive")
        if p.frequency_penalty is not None and not (
            -2.0 <= p.frequency_penalty <= 2.0
        ):
            raise ValidationError("frequency_penalty must be in [-2, 2]")
        if len(p.stop) > self.config.max_stop_sequences:
            raise ValidationError(
                f"too many stop sequences (max {self.config.max_stop_sequences})"
            )
        if p.top_n_tokens is not None and p.top_n_tokens > self.config.max_top_n_tokens:
            raise ValidationError(
                f"top_n_tokens must be <= {self.config.max_top_n_tokens}"
            )
        if p.truncate is not None and p.truncate <= 0:
            raise ValidationError("truncate must be strictly positive")
        best_of = p.best_of or p.n or 1
        if best_of > self.config.best_of:
            raise ValidationError(f"best_of must be <= {self.config.best_of}")
        if best_of > 1 and not p.do_sample:
            # Sampling must be enabled for multiple candidates
            # (ref: validation.rs best_of×sampling interplay).
            raise ValidationError("best_of > 1 requires do_sample=true")
        if p.max_new_tokens is not None and p.max_new_tokens == 0:
            raise ValidationError("max_new_tokens must be strictly positive")

    async def validate(self, request: GenerateRequest) -> ValidGenerateRequest:
        p = request.parameters
        self._check_params(p)

        inputs, token_ids = await self.tokenizers.encode(
            request.inputs, p.truncate
        )
        input_len = len(token_ids)
        if input_len > self.config.max_input_tokens:
            raise ValidationError(
                f"input has {input_len} tokens, more than the "
                f"{self.config.max_input_tokens} maximum"
            )

        # Default budget: fill to max_total_tokens (ref: validation.rs:133-137).
        max_new = p.max_new_tokens
        if max_new is None:
            max_new = max(self.config.max_total_tokens - input_len, 1)
        if input_len + max_new > self.config.max_total_tokens:
            raise ValidationError(
                f"input ({input_len}) + max_new_tokens ({max_new}) exceeds "
                f"max_total_tokens ({self.config.max_total_tokens})"
            )

        params = NextTokenChooserParameters(
            temperature=p.temperature if p.temperature is not None else 1.0,
            top_k=p.top_k or 0,
            top_p=p.top_p if p.top_p is not None else 1.0,
            typical_p=p.typical_p if p.typical_p is not None else 1.0,
            do_sample=p.do_sample,
            seed=p.seed if p.seed is not None else DEFAULT_SEED,
            repetition_penalty=p.repetition_penalty or 1.0,
            frequency_penalty=p.frequency_penalty or 0.0,
        )
        stopping = StoppingCriteriaParameters(
            max_new_tokens=max_new,
            stop_sequences=list(p.stop),
            ignore_eos_token=False,
        )
        return ValidGenerateRequest(
            request_id=request.request_id,
            inputs=inputs,
            input_token_ids=token_ids,
            parameters=params,
            stopping_criteria=stopping,
            best_of=p.best_of or 1,
            logprobs=p.decoder_input_details,
            top_n_tokens=p.top_n_tokens or 0,
            n=p.n,
        )
