"""Qwen2 in PyTorch (counterpart of ``atoma_infer_tpu/models/qwen2.py``).

Llama with additive q/k/v biases (which the port's ``Llama`` already adds
when the parameters hold them) and, where ``use_sliding_window`` is set, a
sliding window.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .llama import Llama, LlamaConfig


class Qwen2Config(LlamaConfig):
    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> LlamaConfig:
        """A ``LlamaConfig`` with qkv biases (HF Qwen2 always has them; an
        explicit ``attention_bias`` wins), the window only under
        ``use_sliding_window``, and no rope scaling."""
        return dataclasses.replace(
            LlamaConfig.from_hf_dict(d),
            attention_bias=bool(d.get("attention_bias", True)),
            sliding_window=d.get("sliding_window") if d.get("use_sliding_window", False) else None,
            rope_scaling=None,
        )


class Qwen2(Llama):
    """Llama's paged-KV forward; qkv biases from the parameters."""
