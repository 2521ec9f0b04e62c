"""Model registry: HF ``model_type`` / architecture name → model class.

The port has Llama only. The JAX package's other families (mistral, qwen2,
phi3, gemma2, mixtral) raise here until their ROADMAP.md item (Queue 1,
"Model families") is done.
"""

from __future__ import annotations

_NOT_PORTED = {
    "mistral", "mixtral", "phi3", "qwen2", "gemma2",
    "MistralForCausalLM", "MixtralForCausalLM", "Phi3ForCausalLM",
    "Qwen2ForCausalLM", "Gemma2ForCausalLM",
}


def get_model_cls(model_type: str):
    from .llama import Llama

    if model_type in ("llama", "LlamaForCausalLM"):
        return Llama
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {model_type!r} is not ported to PyTorch yet "
            "(ROADMAP.md, Queue 1: model families)"
        )
    raise ValueError(f"unsupported model type {model_type!r}; known: ['llama']")

