"""Weights: HF safetensors → the port's parameter dict, and JAX parameters →
the port's.

Counterpart of ``atoma_infer_tpu/models/weights.py`` for dense bf16/f32
checkpoints of every family the port serves: per-layer tensors are stacked
on axis 0 and projections transposed to ``[in, out]``, the JAX package's
layout, so both packages hold the same numbers in the same places. Phi-3's
fused ``qkv_proj`` and ``gate_up_proj`` are split on load, Gemma-2's
feed-forward norms and Qwen2's qkv biases are taken where present, and
Mixtral's router ``[L, H, E]`` and experts ``[L, E, in, out]`` replace the
dense MLP. ``safetensors`` is imported only when a checkpoint is loaded.
With ``quantization`` ("int8" or "int4") the seven projections are
quantized on load, layer by layer from f32, and an untied LM head to INT8
with one scale per column (JAX ``weights.py:184-248``); Mixtral's router
and experts stay in the model's dtype, as in the JAX package. Under tensor
parallelism (``group``) each layer's tensor is moved to the device,
quantized and cut to the rank's slice (``parallel/sharding.py``) before the
next, so a rank's device holds its shard plus one layer.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.quant import QuantizedTensor, quantize_weight
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
    """Parse ``config.json`` into its family's config (JAX
    ``weights.py:43-68``)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        return config_from_hf_dict(json.load(f))


def config_from_hf_dict(d: Dict[str, Any]) -> LlamaConfig:
    """An HF ``config.json`` dict → its family's config, by ``model_type``."""
    model_type = d.get("model_type", "llama")
    if model_type == "mistral":
        from .mistral import MistralConfig

        return MistralConfig.from_hf_dict(d)
    if model_type == "phi3":
        from .phi3 import Phi3Config

        return Phi3Config.from_hf_dict(d)
    if model_type == "qwen2":
        from .qwen2 import Qwen2Config

        return Qwen2Config.from_hf_dict(d)
    if model_type == "gemma2":
        from .gemma import GemmaConfig

        return GemmaConfig.from_hf_dict(d)
    if model_type == "mixtral":
        from .mixtral import MixtralConfig

        return MixtralConfig.from_hf_dict(d)
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
    # Gemma-2's feed-forward norms.
    "pre_feedforward_layernorm.weight": ("pre_ffw_norm", False),
    "post_feedforward_layernorm.weight": ("post_ffw_norm", False),
    "mlp.gate_proj.weight": ("gate_proj", True),
    "mlp.up_proj.weight": ("up_proj", True),
    "mlp.down_proj.weight": ("down_proj", True),
}
# Keys a family may lack altogether (Qwen2's biases, Gemma-2's norms).
_OPTIONAL_KEYS = frozenset({"q_bias", "k_bias", "v_bias", "pre_ffw_norm", "post_ffw_norm"})
# Mixtral replaces the dense MLP with these (``block_sparse_moe.*``).
_MOE_REPLACED = frozenset({"gate_proj", "up_proj", "down_proj"})
_EXPERT_WEIGHTS = ("w1", "w2", "w3")
_QUANTIZED_KEYS = frozenset(
    {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}
)
_BITS = {None: None, "int8": 8, "int4": 4}


def _quantize_layers(tensors, bits: int, device, cut=None) -> QuantizedTensor:
    """Quantize per-layer ``[in, out]`` weights one at a time from f32 on
    ``device`` (no f32 copy of the whole stack), each cut to a rank's slice
    by ``cut`` (a one-layer stack → its slice), then stack."""
    per_layer = []
    for t in tensors:
        q = quantize_weight(torch.as_tensor(t).to(device, torch.float32), bits)
        q = QuantizedTensor(qweight=q.qweight[None], scales=q.scales[None], bits=q.bits,
                            group_size=q.group_size)
        per_layer.append(q if cut is None else cut(q))
    return QuantizedTensor(
        qweight=torch.cat([q.qweight for q in per_layer]),
        scales=torch.cat([q.scales for q in per_layer]),
        bits=bits,
        group_size=per_layer[0].group_size,
    )


def _dense_layers(tensors, dtype, device, cut=None) -> torch.Tensor:
    """Per-layer tensors moved to ``device`` in ``dtype`` one at a time,
    each cut to a rank's slice by ``cut``, then stacked."""
    out = []
    for t in tensors:
        layer = _to_tensor(t, dtype, device)[None]
        out.append(layer if cut is None else cut(layer))
    return torch.cat(out)


def _quantize_lm_head(lm_head) -> QuantizedTensor:
    """INT8 with per-channel scales (one group = the whole contraction): the
    head is read whole every step."""
    lm = lm_head.float()
    return quantize_weight(lm, 8, group_size=lm.shape[0])


def quantize_params(params: Dict[str, Any], quantization: Optional[str]) -> Dict[str, Any]:
    """A dense parameter dict with its projections quantized layer by layer
    and an untied LM head quantized per channel, as the loader does (a
    Mixtral's router and experts stay dense). The dense input is left as it
    is."""
    bits = _BITS[quantization]
    if bits is None:
        return params
    layers = dict(params["layers"])
    for key in _QUANTIZED_KEYS & layers.keys():  # Mixtral: no dense MLP
        stacked = layers[key]
        layers[key] = _quantize_layers(list(stacked.unbind(0)), bits, stacked.device)
    out = dict(params, layers=layers)
    if "lm_head" in params:
        out["lm_head"] = _quantize_lm_head(params["lm_head"])
    return out


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
    quantization: Optional[str] = None,  # None | "int8" | "int4"
    group=None,
) -> Dict[str, Any]:
    """Load and stack a checkpoint's weights from safetensors onto
    ``device`` (any family of the registry); optionally quantize the
    linears on load. With a tensor-parallel ``group``, the rank's slices
    only (``parallel/sharding.py``), cut layer by layer."""
    from safetensors import safe_open

    from ..parallel.sharding import shard_layer, shard_lm_head
    from .phi3 import split_phi3_tensor

    bits = _BITS[quantization]
    tp, rank = (1, 0) if group is None else (group.tp, group.rank)

    def cut(key):
        if tp == 1:
            return None
        return lambda value: shard_layer(key, value, tp, rank, config.num_key_value_heads)

    L = config.num_layers
    per_layer: Dict[str, List[Optional[torch.Tensor]]] = {
        key: [None] * L for key, _ in _LAYER_MAP.values()
    }
    top: Dict[str, torch.Tensor] = {}
    # Mixtral: the router [L, H, E] and each expert's SwiGLU [L][E].
    E = int(getattr(config, "num_local_experts", 0) or 0)
    router: List[Optional[torch.Tensor]] = [None] * L
    experts = {w: [[None] * E for _ in range(L)] for w in _EXPERT_WEIGHTS}

    def take_moe(idx: int, param: str, arr: torch.Tensor) -> bool:
        """Route a ``block_sparse_moe.*`` tensor; True if it was one."""
        if not param.startswith("block_sparse_moe."):
            return False
        rest = param[len("block_sparse_moe."):]
        if rest == "gate.weight":
            router[idx] = arr.T  # [E, H] → [H, E]
        elif rest.startswith("experts."):
            e, wname = rest[len("experts."):].split(".", 1)
            wname = wname.removesuffix(".weight")
            if wname in experts:
                experts[wname][idx][int(e)] = arr.T  # [out, in] → [in, out]
            else:
                logger.warning("skipping unknown expert tensor %s", rest)
        else:
            logger.warning("skipping unknown moe tensor %s", rest)
        return True

    def tensors_from(f):
        """(name, tensor) pairs, Phi-3's fused tensors split."""
        for name in f.keys():
            arr = f.get_tensor(name)
            if name.endswith(("qkv_proj.weight", "gate_up_proj.weight")):
                yield from split_phi3_tensor(name, arr, config.num_attention_heads,
                                             config.num_key_value_heads, config.head_dim)
            else:
                yield name, arr

    for path in _weight_files(model_dir):
        with safe_open(path, framework="pt") as f:
            for name, arr in tensors_from(f):
                if name == "model.embed_tokens.weight":
                    top["embed"] = arr
                elif name == "model.norm.weight":
                    top["final_norm"] = arr
                elif name == "lm_head.weight":
                    top["lm_head"] = arr.T
                elif name.startswith("model.layers."):
                    idx_str, param = name[len("model.layers."):].split(".", 1)
                    if E and take_moe(int(idx_str), param, arr):
                        continue
                    mapped = _LAYER_MAP.get(param)
                    if mapped is None:
                        logger.warning("skipping unknown tensor %s", name)
                        continue
                    key, transpose = mapped
                    per_layer[key][int(idx_str)] = arr.T if transpose else arr
                else:
                    logger.warning("skipping unknown tensor %s", name)

    layers: Dict[str, Any] = {}
    for key, tensors in per_layer.items():
        missing = [i for i, t in enumerate(tensors) if t is None]
        absent_ok = key in _OPTIONAL_KEYS or (E and key in _MOE_REPLACED)
        if absent_ok and len(missing) == len(tensors):
            continue
        if missing:
            raise ValueError(f"missing layer tensors for {key}: {missing}")
        if bits and key in _QUANTIZED_KEYS:
            layers[key] = _quantize_layers(tensors, bits, device, cut(key))
        else:
            layers[key] = _dense_layers(tensors, dtype, device, cut(key))
    if E:
        missing = [i for i, t in enumerate(router) if t is None]
        if missing:
            raise ValueError(f"missing MoE router tensors: {missing}")
        layers["router"] = _to_tensor(torch.stack(router), dtype, device)
        for wname, per_layer_experts in experts.items():
            missing = [(i, j) for i, row in enumerate(per_layer_experts)
                       for j, t in enumerate(row) if t is None]
            if missing:
                raise ValueError(f"missing MoE expert tensors for {wname}: {missing}")
            layers[wname] = _dense_layers([torch.stack(row) for row in per_layer_experts],
                                          dtype, device, cut(wname))

    params: Dict[str, Any] = {
        "embed": _to_tensor(top["embed"], dtype, device),
        "layers": layers,
        "final_norm": _to_tensor(top["final_norm"], dtype, device),
    }
    if "lm_head" in top:
        if bits:
            lm_head = _quantize_lm_head(top["lm_head"].to(device))
        else:
            lm_head = _to_tensor(top["lm_head"], dtype, device)
        params["lm_head"] = shard_lm_head(lm_head, tp, rank)
    elif not config.tie_word_embeddings:
        raise ValueError("checkpoint lacks lm_head but embeddings are not tied")
    return params


def params_from_numpy(
    params: Dict[str, Any], dtype: torch.dtype = torch.float32, device="cpu"
) -> Dict[str, Any]:
    """The JAX package's parameter pytree, as numpy arrays or anything
    ``np.asarray`` takes, with layers stacked on axis 0 → the port's
    parameter dict on ``device``. Same keys, same layout. Dense arrays take
    ``dtype``; a quantized weight (any object with ``qweight``, ``scales``,
    ``bits`` and ``group_size``, such as the JAX ``QuantizedTensor``) keeps
    its int8 ``qweight`` and bf16 ``scales`` bytes unconverted."""
    out: Dict[str, Any] = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out[key] = params_from_numpy(value, dtype, device)
        elif all(hasattr(value, a) for a in ("qweight", "scales", "bits", "group_size")):
            out[key] = QuantizedTensor(
                qweight=_to_tensor(value.qweight, torch.int8, device),
                scales=_bf16_tensor(value.scales, device),
                bits=int(value.bits),
                group_size=int(value.group_size),
            )
        else:
            out[key] = _to_tensor(value, dtype, device)
    return out


def _bf16_tensor(arr: Any, device) -> torch.Tensor:
    """A bf16 array (numpy's ml_dtypes bfloat16, as JAX hands it over) → a
    bf16 tensor with the same bits."""
    arr = np.asarray(arr)
    if arr.dtype.name != "bfloat16":
        raise ValueError(f"scales must be bfloat16, not {arr.dtype}")
    bits = np.ascontiguousarray(arr).view(np.int16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)
