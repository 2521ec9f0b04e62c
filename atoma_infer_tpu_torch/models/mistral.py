"""Mistral in PyTorch (counterpart of ``atoma_infer_tpu/models/mistral.py``;
ref: models/src/mistral.rs).

Llama with a sliding window and untied embeddings: the forward is
:class:`~atoma_infer_tpu_torch.models.llama.Llama`'s, and only the config
parsing differs (the window reaches every layer's attention kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .llama import Llama, LlamaConfig


class MistralConfig(LlamaConfig):
    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> LlamaConfig:
        """A ``LlamaConfig`` with the checkpoint's window and no rope scaling,
        as the JAX package parses it."""
        return dataclasses.replace(
            LlamaConfig.from_hf_dict(d), sliding_window=d.get("sliding_window"),
            rope_scaling=None,
        )


class Mistral(Llama):
    """Llama's paged-KV forward; the window from the config (ref:
    mistral.rs:12,366)."""
