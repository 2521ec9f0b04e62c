"""JSON-Schema (draft-7) validation of chat-completion request bodies.

Ref: server/src/api/validate_schema.rs:7-30 + the bundled
``request_schema.json`` (server.rs:313): the ``/v1/chat/completions/validate``
endpoint returns detailed per-path errors instead of rejecting outright.
"""

from __future__ import annotations

from typing import Any, Dict, List

import jsonschema

REQUEST_SCHEMA: Dict[str, Any] = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "title": "ChatCompletionRequest",
    "type": "object",
    "required": ["model", "messages"],
    "properties": {
        "model": {"type": "string"},
        "messages": {
            "type": "array",
            "minItems": 1,
            "items": {
                "type": "object",
                "required": ["role"],
                "properties": {
                    "role": {
                        "type": "string",
                        "enum": ["system", "user", "assistant", "tool"],
                    },
                    "content": {
                        "anyOf": [
                            {"type": "string"},
                            {"type": "array"},
                            {"type": "null"},
                        ]
                    },
                    "name": {"type": "string"},
                },
            },
        },
        "temperature": {"type": "number", "minimum": 0, "maximum": 2},
        "top_p": {"type": "number", "exclusiveMinimum": 0, "maximum": 1},
        "top_k": {"type": "integer", "minimum": 0},
        "n": {"type": "integer", "minimum": 1},
        "max_tokens": {"type": "integer", "minimum": 1},
        "max_completion_tokens": {"type": "integer", "minimum": 1},
        "frequency_penalty": {"type": "number", "minimum": -2, "maximum": 2},
        "presence_penalty": {"type": "number", "minimum": -2, "maximum": 2},
        "repetition_penalty": {"type": "number", "exclusiveMinimum": 0},
        "seed": {"type": "integer"},
        "stop": {
            "anyOf": [
                {"type": "string"},
                {"type": "array", "items": {"type": "string"}, "maxItems": 4},
            ]
        },
        "stream": {"type": "boolean"},
        "logprobs": {"type": "boolean"},
        "tools": {"type": "array"},
        "user": {"type": "string"},
    },
}

_VALIDATOR = jsonschema.Draft7Validator(REQUEST_SCHEMA)


def validate_with_schema(instance: Any) -> List[Dict[str, str]]:
    """Returns a list of {path, message} errors; empty = valid
    (ref: validate_schema.rs:7-30)."""
    errors = []
    for err in sorted(_VALIDATOR.iter_errors(instance), key=str):
        path = "/".join(str(p) for p in err.absolute_path) or "<root>"
        errors.append({"path": path, "message": err.message})
    return errors
