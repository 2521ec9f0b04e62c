"""Model registry: HF ``model_type`` / architecture name → model class
(counterpart of ``atoma_infer_tpu/models/registry.py``): Llama, Mistral,
Mixtral, Phi-3, Qwen2 and Gemma-2."""

from __future__ import annotations


def get_model_cls(model_type: str):
    from .gemma import Gemma2
    from .llama import Llama
    from .mistral import Mistral
    from .mixtral import Mixtral
    from .phi3 import Phi3
    from .qwen2 import Qwen2

    registry = {
        "llama": Llama,
        "mistral": Mistral,
        "mixtral": Mixtral,
        "phi3": Phi3,
        "qwen2": Qwen2,
        "gemma2": Gemma2,
        "LlamaForCausalLM": Llama,
        "MistralForCausalLM": Mistral,
        "MixtralForCausalLM": Mixtral,
        "Phi3ForCausalLM": Phi3,
        "Qwen2ForCausalLM": Qwen2,
        "Gemma2ForCausalLM": Gemma2,
    }
    if model_type not in registry:
        raise ValueError(f"unsupported model type {model_type!r}; known: {sorted(registry)}")
    return registry[model_type]


def list_models():
    return ["llama", "mistral", "mixtral", "phi3", "qwen2", "gemma2"]
