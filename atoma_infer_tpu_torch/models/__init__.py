"""Model implementations over the flattened-batch + paged-KV forward contract
(ref: flash_attention.rs:156-174): Llama and the families built on its
forward (Mistral, Qwen2, Phi-3, Gemma-2, Mixtral)."""

from .registry import get_model_cls, list_models

__all__ = ["get_model_cls", "list_models"]
