"""Weights: HF safetensors → the port's parameter dict, and JAX parameters →
the port's.

Counterpart of ``atoma_infer_tpu/models/weights.py`` for dense bf16/f32
Llama checkpoints: per-layer tensors are stacked on axis 0 and projections
transposed to ``[in, out]``, the JAX package's layout, so both packages hold
the same numbers in the same places. ``safetensors`` is imported only when a
checkpoint is loaded. Quantize-on-load waits for the quantization ROADMAP item.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .llama import LlamaConfig

logger = logging.getLogger(__name__)


def _weight_files(model_dir: str) -> List[str]:
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({os.path.join(model_dir, fn) for fn in weight_map.values()})
    single = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(f"no safetensors checkpoint found in {model_dir}")


def load_hf_config(model_dir: str) -> LlamaConfig:
    """Parse ``config.json`` (Llama family only in the port)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        d = json.load(f)
    model_type = d.get("model_type", "llama")
    if model_type != "llama":
        from .registry import get_model_cls

        get_model_cls(model_type)  # raises: family not ported
    return LlamaConfig.from_hf_dict(d)


# HF parameter name → (parameter key, transpose?) for per-layer tensors.
_LAYER_MAP = {
    "input_layernorm.weight": ("input_norm", False),
    "self_attn.q_proj.weight": ("q_proj", True),
    "self_attn.k_proj.weight": ("k_proj", True),
    "self_attn.v_proj.weight": ("v_proj", True),
    "self_attn.o_proj.weight": ("o_proj", True),
    "self_attn.q_proj.bias": ("q_bias", False),
    "self_attn.k_proj.bias": ("k_bias", False),
    "self_attn.v_proj.bias": ("v_bias", False),
    "post_attention_layernorm.weight": ("post_norm", False),
    "mlp.gate_proj.weight": ("gate_proj", True),
    "mlp.up_proj.weight": ("up_proj", True),
    "mlp.down_proj.weight": ("down_proj", True),
}
_OPTIONAL_KEYS = frozenset({"q_bias", "k_bias", "v_bias"})


def _to_tensor(arr: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """torch tensor, numpy array or array-like → torch tensor of ``dtype``
    on ``device``. bf16 numpy arrays (ml_dtypes) are widened to f32 first —
    exact — so no ml_dtypes is needed here."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=dtype).contiguous()
    arr = np.asarray(arr)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return torch.tensor(arr, dtype=dtype, device=device)  # always a copy


def load_llama_params(
    model_dir: str,
    config: LlamaConfig,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Dict[str, Any]:
    """Load and stack Llama weights from safetensors onto ``device``."""
    from safetensors import safe_open

    L = config.num_layers
    per_layer: Dict[str, List[Optional[torch.Tensor]]] = {
        key: [None] * L for key, _ in _LAYER_MAP.values()
    }
    top: Dict[str, torch.Tensor] = {}
    for path in _weight_files(model_dir):
        with safe_open(path, framework="pt") as f:
            for name in f.keys():
                arr = f.get_tensor(name)
                if name == "model.embed_tokens.weight":
                    top["embed"] = arr
                elif name == "model.norm.weight":
                    top["final_norm"] = arr
                elif name == "lm_head.weight":
                    top["lm_head"] = arr.T
                elif name.startswith("model.layers."):
                    idx_str, param = name[len("model.layers."):].split(".", 1)
                    mapped = _LAYER_MAP.get(param)
                    if mapped is None:
                        logger.warning("skipping unknown tensor %s", name)
                        continue
                    key, transpose = mapped
                    per_layer[key][int(idx_str)] = arr.T if transpose else arr
                else:
                    logger.warning("skipping unknown tensor %s", name)

    layers: Dict[str, torch.Tensor] = {}
    for key, tensors in per_layer.items():
        missing = [i for i, t in enumerate(tensors) if t is None]
        if key in _OPTIONAL_KEYS and len(missing) == len(tensors):
            continue
        if missing:
            raise ValueError(f"missing layer tensors for {key}: {missing}")
        layers[key] = _to_tensor(torch.stack(tensors), dtype, device)

    params: Dict[str, Any] = {
        "embed": _to_tensor(top["embed"], dtype, device),
        "layers": layers,
        "final_norm": _to_tensor(top["final_norm"], dtype, device),
    }
    if "lm_head" in top:
        params["lm_head"] = _to_tensor(top["lm_head"], dtype, device)
    elif not config.tie_word_embeddings:
        raise ValueError("checkpoint lacks lm_head but embeddings are not tied")
    return params


def params_from_numpy(
    params: Dict[str, Any], dtype: torch.dtype = torch.float32, device="cpu"
) -> Dict[str, Any]:
    """The JAX package's (dense) parameter pytree, as numpy arrays or
    anything ``np.asarray`` takes, with layers stacked on axis 0 → the
    port's parameter dict on ``device``. Same keys, same layout."""
    out: Dict[str, Any] = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out[key] = params_from_numpy(value, dtype, device)
        else:
            out[key] = _to_tensor(value, dtype, device)
    return out
