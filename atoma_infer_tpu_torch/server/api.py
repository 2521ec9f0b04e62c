"""OpenAI chat-completions API types + request↔engine mapping.

Ref: server/src/api/chat_completions.rs — ``RequestBody`` (:640-890), the
``RequestBody→GenerateRequest`` mapping (:891-933), and the
``ChatCompletionResponse``/``Chunk`` + ``Usage``/``FinishReason`` response
shapes (:936-1153).
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional

from ..types import GenerateParameters, GenerateRequest
from .chat_templates import render_prompt


class ApiError(ValueError):
    """Bad request body (HTTP 400/422)."""


# The reference hard-validates against this 20-model enum
# (ref: server/src/api/chat_completions.rs:28-129). Locally-served model
# names (paths, tiny-random) are additionally accepted via ``served_model``.
KNOWN_MODELS = frozenset(
    {
        "meta-llama/Meta-Llama-2-7b",
        "meta-llama/Llama-2-7b-chat-hf",
        "meta-llama/Llama-2-70b-hf",
        "meta-llama/Meta-Llama-3-8B",
        "meta-llama/Meta-Llama-3-8B-Instruct",
        "meta-llama/Meta-Llama-3-70B",
        "meta-llama/Meta-Llama-3-70B-Instruct",
        "meta-llama/Llama-3.1-8B",
        "meta-llama/Llama-3.1-8B-Instruct",
        "meta-llama/Llama-3.1-70B",
        "meta-llama/Llama-3.1-70B-Instruct",
        "meta-llama/Llama-3.1-405B",
        "meta-llama/Llama-3.1-405B-Instruct",
        "meta-llama/Llama-3.2-1B",
        "meta-llama/Llama-3.2-1B-Instruct",
        "meta-llama/Llama-3.2-3B",
        "meta-llama/Llama-3.2-3B-Instruct",
        "NousResearch/Hermes-3-Llama-3.1-8B",
        "NousResearch/Hermes-3-Llama-3.1-70B",
        "NousResearch/Hermes-3-Llama-3.1-405B",
        # Families served beyond the reference enum (models/registry.py).
        "mistralai/Mistral-7B-Instruct-v0.3",
        "microsoft/Phi-3-mini-4k-instruct",
        "Qwen/Qwen2.5-7B-Instruct",
        "google/gemma-2-9b",
        "google/gemma-2-9b-it",
        "google/gemma-2-27b",
        "google/gemma-2-27b-it",
    }
)


def parse_request_body(
    body: Dict[str, Any], served_model: Optional[str] = None
) -> Dict[str, Any]:
    """Light structural validation of a chat-completions body."""
    if not isinstance(body, dict):
        raise ApiError("request body must be a JSON object")
    if "model" not in body or not isinstance(body["model"], str):
        raise ApiError("'model' is required and must be a string")
    model = body["model"]
    if model not in KNOWN_MODELS and model != served_model:
        raise ApiError(
            f"unknown model {model!r}; serve it or use one of the supported "
            f"model ids (see /v1/models)"
        )
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ApiError("'messages' must be a non-empty array")
    for m in messages:
        if not isinstance(m, dict) or "role" not in m:
            raise ApiError("each message needs a 'role'")
    return body


def to_generate_request(body: Dict[str, Any]) -> GenerateRequest:
    """Chat request → engine request (ref: chat_completions.rs:891-933)."""
    prompt = render_prompt(
        body["model"], body["messages"], body.get("tools")
    )
    temperature = body.get("temperature")
    do_sample = temperature is None or temperature > 0
    if temperature == 0:
        do_sample = False
        temperature = None
    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    params = GenerateParameters(
        temperature=temperature,
        top_p=body.get("top_p"),
        frequency_penalty=body.get("frequency_penalty"),
        repetition_penalty=body.get("repetition_penalty"),
        top_k=body.get("top_k"),
        do_sample=do_sample,
        max_new_tokens=body.get("max_completion_tokens")
        or body.get("max_tokens"),
        stop=list(stop),
        seed=body.get("seed"),
        n=body.get("n") or 1,
        best_of=body.get("best_of"),
        decoder_input_details=bool(body.get("logprobs")),
        typical_p=body.get("typical_p"),
        top_n_tokens=(
            body.get("top_logprobs") if body.get("logprobs") else None
        ),
    )
    return GenerateRequest(
        request_id=f"chatcmpl-{uuid.uuid4().hex}",
        inputs=prompt,
        parameters=params,
    )


def _finish_reason(reason: Optional[str]) -> str:
    """Engine finish reason → OpenAI finish_reason (ref: FinishReason enum)."""
    return {
        "length_capped": "length",
        "stopped": "stop",
        "aborted": "abort",
        "ignored": "length",
        "eos_token": "stop",
        "stop_sequence": "stop",
        "length": "length",
        "model_length": "length",
    }.get(reason or "stop", "stop")


def completion_response(
    request_output, model: str, prompt_tokens: int
) -> Dict[str, Any]:
    """Final response (ref: ChatCompletionResponse, chat_completions.rs:936-1050)."""
    completion_tokens = sum(
        len(o.token_ids) for o in request_output.outputs
    )
    return {
        "id": request_output.request_id,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": i,
                "message": {"role": "assistant", "content": o.output_text},
                "logprobs": (
                    {
                        "content": [
                            {
                                "token": str(t),
                                "logprob": lp,
                                **(
                                    {
                                        "top_logprobs": [
                                            {"token": str(tt), "logprob": tlp}
                                            for tt, tlp in top
                                        ]
                                    }
                                    if top is not None
                                    else {}
                                ),
                            }
                            for t, lp, top in zip(
                                o.token_ids,
                                o.logprobs,
                                o.top_logprobs
                                or [None] * len(o.token_ids),
                            )
                        ]
                    }
                    if o.logprobs
                    else None
                ),
                "finish_reason": _finish_reason(o.finish_reason),
            }
            for i, o in enumerate(request_output.outputs)
        ],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }


def chunk_response(
    request_id: str, model: str, text: str, finish_reason: Optional[str]
) -> Dict[str, Any]:
    """One SSE chunk (ref: ChatCompletionChunk, chat_completions.rs:1052-1153)."""
    return {
        "id": request_id,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "delta": {"content": text} if text else {},
                "finish_reason": (
                    _finish_reason(finish_reason) if finish_reason else None
                ),
            }
        ],
    }
