"""Chat-template rendering per model family.

Ref: server/src/api/chat_completions.rs — llama2 (:263), llama3 (:324) and
hermes3 (:393) prompt builders, tool-call formatting (:576), and the
model-id → family mapping implied by the hard-coded ``Model`` enum (:28-129).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def family_for_model(model_id: str) -> str:
    """Infer the prompt family from the model id (ref: Model enum :28-129;
    the non-llama families go beyond the reference enum)."""
    m = model_id.lower()
    if "hermes" in m:
        return "hermes3"
    if "llama-2" in m or "llama2" in m:
        return "llama2"
    if "gemma" in m:
        return "gemma"
    if "mistral" in m or "mixtral" in m:
        return "mistral"
    if "phi-3" in m or "phi3" in m:
        return "phi3"
    if "qwen" in m:
        return "chatml"
    # Llama 3.x and most derivatives.
    return "llama3"


def _function_call_string(family: str, tool_call: Dict[str, Any]) -> str:
    """Render one assistant tool call the way each model family expects
    (ref: ToolCall::function_call_string, chat_completions.rs:576-640).

    - llama3/llama2 families: ``name(k='str', n=1, b=true)`` — arguments may
      arrive as a JSON object or a serialized-JSON string; unparseable
      strings are passed through verbatim as ``name(raw)``.
    - hermes3: ``{"arguments": {...}, "name": "fn"}`` with the reference's
      space-after-colon quirk (compact JSON, then ``":"`` → ``": "``).
    """
    fn = tool_call.get("function", {}) or {}
    name = fn.get("name", "")
    args = fn.get("arguments")
    if isinstance(args, str):
        try:
            parsed = json.loads(args)
        except (ValueError, TypeError):
            parsed = None
        if isinstance(parsed, dict):
            args = parsed
        elif family == "hermes3":
            args = parsed if parsed is not None else args
        else:
            return f"{name}({args})"

    if family == "hermes3":
        formatted = json.dumps(
            args if args is not None else {}, separators=(",", ":")
        ).replace('":"', '": "')
        return f'{{"arguments": {formatted}, "name": "{name}"}}'

    if not isinstance(args, dict):
        return f"{name}()"

    def fmt(v: Any) -> str:
        if isinstance(v, str):
            return f"'{v}'"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return json.dumps(v)
        return json.dumps(v, separators=(",", ":"))

    params = ", ".join(f"{k}={fmt(v)}" for k, v in args.items())
    return f"{name}({params})"


def _tool_calls_str(family: str, msg: Dict[str, Any]) -> Optional[str]:
    """Joined function-call string for an assistant message, or None."""
    calls = msg.get("tool_calls") or []
    if not calls:
        return None
    return ", ".join(_function_call_string(family, tc) for tc in calls)


def _content_str(content: Any) -> str:
    """OpenAI content can be a string or a list of typed parts."""
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    parts = []
    for part in content:
        if isinstance(part, dict) and part.get("type") == "text":
            parts.append(part.get("text", ""))
    return "".join(parts)


def render_llama2(messages: List[Dict[str, Any]]) -> str:
    """``<s>[INST] <<SYS>>...<</SYS>> user [/INST] assistant </s>`` format
    (ref: chat_completions.rs:263-322)."""
    system = ""
    convo: List[Dict[str, str]] = []
    for msg in messages:
        role = msg.get("role")
        text = _content_str(msg.get("content"))
        if role == "system":
            system = text
        else:
            convo.append({"role": role, "content": text})

    out = []
    first_user = True
    for msg in convo:
        if msg["role"] == "user":
            if first_user and system:
                out.append(
                    f"<s>[INST] <<SYS>>\n{system}\n<</SYS>>\n\n"
                    f"{msg['content']} [/INST]"
                )
            else:
                out.append(f"<s>[INST] {msg['content']} [/INST]")
            first_user = False
        elif msg["role"] == "assistant":
            out.append(f" {msg['content']} </s>")
    return "".join(out)


def render_llama3(
    messages: List[Dict[str, Any]],
    tools: Optional[List[Dict[str, Any]]] = None,
) -> str:
    """``<|start_header_id|>role<|end_header_id|>`` format with optional
    tool-call preamble (ref: chat_completions.rs:324-391,576-640)."""
    out = ["<|begin_of_text|>"]
    tool_prompt = ""
    if tools:
        tool_prompt = (
            "\n\nYou have access to the following functions. To call a "
            "function, respond with JSON for a function call with its proper "
            "arguments:\n"
            + "\n".join(json.dumps(t, indent=2) for t in tools)
        )
    for i, msg in enumerate(messages):
        role = msg.get("role")
        text = _content_str(msg.get("content"))
        if role == "tool":
            role = "ipython"
        if i == 0 and role == "system" and tool_prompt:
            text += tool_prompt
        if role == "assistant":
            # Assistant tool calls render as a <|python_tag|> call list and
            # REPLACE the content (ref: chat_completions.rs:351-375).
            calls = _tool_calls_str("llama3", msg)
            if calls is not None:
                text = f"<|python_tag|>[{calls}]"
        out.append(
            f"<|start_header_id|>{role}<|end_header_id|>\n\n{text}<|eot_id|>"
        )
    if tool_prompt and not any(m.get("role") == "system" for m in messages):
        out.insert(
            1,
            "<|start_header_id|>system<|end_header_id|>\n\n"
            f"{tool_prompt.strip()}<|eot_id|>",
        )
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def render_hermes3(
    messages: List[Dict[str, Any]],
    tools: Optional[List[Dict[str, Any]]] = None,
) -> str:
    """ChatML ``<|im_start|>role ... <|im_end|>`` format with Hermes tool
    signatures (ref: chat_completions.rs:393-470)."""
    out = []
    if tools:
        sig = "\n".join(json.dumps(t) for t in tools)
        out.append(
            "<|im_start|>system\nYou are a function calling AI model. You are "
            "provided with function signatures within <tools></tools> XML "
            f"tags:\n<tools>\n{sig}\n</tools><|im_end|>\n"
        )
    for msg in messages:
        role = msg.get("role")
        text = _content_str(msg.get("content"))
        if role == "assistant":
            # Assistant tool calls wrap in <tool_call> tags and replace the
            # content (ref: chat_completions.rs:417-433).
            calls = _tool_calls_str("hermes3", msg)
            if calls is not None:
                text = f"<tool_call>{calls}</tool_call>"
        out.append(f"<|im_start|>{role}\n{text}<|im_end|>\n")
    out.append("<|im_start|>assistant\n")
    return "".join(out)


def render_gemma(messages: List[Dict[str, Any]]) -> str:
    """``<start_of_turn>user/model`` turns. Gemma has no system role — a
    system message folds into the first user turn, matching the HF
    tokenizer_config chat template's behavior for gemma-2 ``-it`` models."""
    system = ""
    out = ["<bos>"]
    for msg in messages:
        role = msg.get("role")
        text = _content_str(msg.get("content"))
        if role == "system":
            system = text
            continue
        if role == "user":
            body = f"{system}\n\n{text}" if system else text
            system = ""
            out.append(f"<start_of_turn>user\n{body}<end_of_turn>\n")
        elif role == "assistant":
            out.append(f"<start_of_turn>model\n{text}<end_of_turn>\n")
    out.append("<start_of_turn>model\n")
    return "".join(out)


def render_mistral(messages: List[Dict[str, Any]]) -> str:
    """``<s>[INST] ... [/INST] answer</s>`` without llama2's <<SYS>> block —
    the system message prepends the first user turn (Mistral convention)."""
    system = ""
    out = []
    first_user = True
    for msg in messages:
        role = msg.get("role")
        text = _content_str(msg.get("content"))
        if role == "system":
            system = text
        elif role == "user":
            body = f"{system}\n\n{text}" if (first_user and system) else text
            out.append(f"<s>[INST] {body} [/INST]")
            first_user = False
        elif role == "assistant":
            out.append(f" {text}</s>")
    return "".join(out)


def render_phi3(messages: List[Dict[str, Any]]) -> str:
    """``<|role|>\\n...<|end|>\\n`` turns ending with ``<|assistant|>``."""
    out = []
    for msg in messages:
        role = msg.get("role")
        text = _content_str(msg.get("content"))
        out.append(f"<|{role}|>\n{text}<|end|>\n")
    out.append("<|assistant|>\n")
    return "".join(out)


def render_prompt(
    model_id: str,
    messages: List[Dict[str, Any]],
    tools: Optional[List[Dict[str, Any]]] = None,
) -> str:
    """Request messages → prompt string (ref: RequestBody::to_generate_request,
    chat_completions.rs:891-933)."""
    family = family_for_model(model_id)
    if family == "llama2":
        return render_llama2(messages)
    if family == "hermes3" or family == "chatml":
        # Qwen2 uses plain ChatML; hermes adds tool signatures the same way.
        return render_hermes3(messages, tools)
    if family == "gemma":
        return render_gemma(messages)
    if family == "mistral":
        return render_mistral(messages)
    if family == "phi3":
        return render_phi3(messages)
    return render_llama3(messages, tools)
