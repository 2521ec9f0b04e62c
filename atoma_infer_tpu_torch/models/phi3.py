"""Phi-3 in PyTorch (counterpart of ``atoma_infer_tpu/models/phi3.py``; ref:
models/src/phi3.rs).

Llama-shaped, with fused ``qkv_proj`` and ``gate_up_proj`` tensors in the HF
checkpoint, which the loader splits (:func:`split_phi3_tensor`), and a
sliding window. Phi-3-mini's head dim is 96, which the attention kernels
take for bf16 queries over a bf16 cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from .llama import Llama, LlamaConfig


class Phi3Config(LlamaConfig):
    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> LlamaConfig:
        """A ``LlamaConfig`` with the checkpoint's window."""
        return dataclasses.replace(LlamaConfig.from_hf_dict(d), sliding_window=d.get("sliding_window"))


def split_phi3_tensor(name: str, arr, num_q: int, num_kv: int,
                      head_dim: int) -> Tuple[Tuple[str, Any], ...]:
    """Split Phi-3's fused checkpoint tensors (numpy arrays or tensors,
    ``[out, in]``) into Llama-format pieces: ``qkv_proj.weight``
    [(q + 2 kv)·d, hidden] → q, k, v projections; ``gate_up_proj.weight``
    [2·inter, hidden] → gate, up. Any other tensor passes through."""
    if name.endswith("self_attn.qkv_proj.weight"):
        q_rows, kv_rows = num_q * head_dim, num_kv * head_dim
        prefix = name[: -len("qkv_proj.weight")]
        return (
            (prefix + "q_proj.weight", arr[:q_rows]),
            (prefix + "k_proj.weight", arr[q_rows: q_rows + kv_rows]),
            (prefix + "v_proj.weight", arr[q_rows + kv_rows:]),
        )
    if name.endswith("mlp.gate_up_proj.weight"):
        inter = arr.shape[0] // 2
        prefix = name[: -len("gate_up_proj.weight")]
        return (
            (prefix + "gate_proj.weight", arr[:inter]),
            (prefix + "up_proj.weight", arr[inter:]),
        )
    return ((name, arr),)


class Phi3(Llama):
    """Llama's paged-KV forward (ref: phi3.rs:12,363)."""
