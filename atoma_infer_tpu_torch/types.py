"""Request types crossing the server → service boundary.

Ref: backends/vllm/src/types.rs:17-95 (``GenerateRequest`` / ``GenerateParameters``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class GenerateParameters:
    """User-facing generation parameters (ref: types.rs:24-80)."""

    best_of: Optional[int] = None
    temperature: Optional[float] = None
    repetition_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    typical_p: Optional[float] = None
    do_sample: bool = False
    max_new_tokens: Optional[int] = None
    return_full_text: Optional[bool] = None
    stop: List[str] = dataclasses.field(default_factory=list)
    truncate: Optional[int] = None
    decoder_input_details: bool = False
    seed: Optional[int] = None
    top_n_tokens: Optional[int] = None
    n: int = 1


@dataclasses.dataclass
class GenerateRequest:
    """A generation request as received by the service (ref: types.rs:82-95)."""

    request_id: str
    inputs: str
    parameters: GenerateParameters = dataclasses.field(
        default_factory=GenerateParameters
    )
