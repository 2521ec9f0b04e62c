"""Model implementations over the flattened-batch + paged-KV forward contract
(ref: flash_attention.rs:156-174). Llama only in this port so far."""

from .registry import get_model_cls

__all__ = ["get_model_cls"]
