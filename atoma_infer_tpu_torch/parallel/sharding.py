"""Sharding rules: one rank's slices of the Llama-family parameters.

Counterpart of ``atoma_infer_tpu/parallel/sharding.py``, rule for rule
(``:36-124``). There the rules are ``NamedSharding`` specs that
``jax.device_put`` places over a mesh; here :func:`shard_params` cuts rank
``r``'s slices out explicitly (rank ``r`` holds what JAX's ``r``-th
addressable shard holds):

- q/k/v/gate/up projections and the q/k/v biases: column-parallel, the
  OUTPUT (last) dim split;
- o/down projections: row-parallel, the INPUT dim (dim 1) split; the model
  sums their outputs over the ranks (``TpGroup.all_reduce_sum``);
- a ``QuantizedTensor``'s ``qweight`` and ``scales`` sliced on the same dims.
  A row-parallel INT8 or INT4 slice must be whole groups of ``group_size``
  rows, so ``(K / group_size) % tp`` must be 0 (JAX would cut a group);
- the embedding, the norms and Mixtral's router: replicated;
- an untied ``lm_head``: split on the vocab dim (the model gathers the
  logits); a tied head is the replicated embedding;
- Mixtral's expert stacks ``w1``/``w3`` [L, E, H, I] and ``w2`` [L, E, I, H]:
  split over the expert axis when ``E % tp == 0`` (expert parallelism: each
  rank holds E/tp whole experts), else over the intermediate dim
  (``_spec_for_moe``, ``:66-86``).

When ``tp`` exceeds the kv-head count (``kv_repeat``, ``models/llama.py``
``:177-193``), JAX shards k/v by columns and XLA reshards the repeated
heads; here rank ``r``'s k/v columns are those of kv head
``r // (tp // Hk)``, cut explicitly.

Each slice is a contiguous copy, and the full tensor is dropped key by key
as it is sliced, so a rank holds its shard plus at most one stacked
parameter.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.quant import QuantizedTensor

COL_PARALLEL = frozenset({"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                          "q_bias", "k_bias", "v_bias"})
ROW_PARALLEL = frozenset({"o_proj", "down_proj"})
KV_KEYS = frozenset({"k_proj", "v_proj", "k_bias", "v_bias"})
EXPERT_KEYS = frozenset({"w1", "w2", "w3"})


def kv_repeat(tp: int, num_kv_heads: int) -> int:
    """Copies of each kv head across the ranks: ``tp // Hk`` when tp is
    wider than the kv heads, else 1 (JAX ``models/llama.py:177-193``)."""
    return max(1, tp // num_kv_heads)


def check_divisibility(num_q_heads: int, num_kv_heads: int, tp: int) -> None:
    """q heads must divide over tp, and kv heads over tp or tp over kv
    heads (JAX ``engine/llm_service.py:173-190``)."""
    if num_q_heads % tp or (num_kv_heads % tp and tp % num_kv_heads):
        raise ValueError(
            f"head counts (q={num_q_heads}, kv={num_kv_heads}) incompatible with "
            f"tensor_parallel_size {tp}"
        )


def _split(t: torch.Tensor, dim: int, tp: int, rank: int, what: str) -> torch.Tensor:
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} does not divide over tp={tp}")
    return t.narrow(dim, rank * (n // tp), n // tp).contiguous()


def _kv_cols(t: torch.Tensor, dim: int, tp: int, rank: int, num_kv_heads: int) -> torch.Tensor:
    """The columns of a k/v projection (or bias) that rank ``rank`` holds:
    its share of the kv heads, or, when tp is wider, the one head it copies."""
    rep = kv_repeat(tp, num_kv_heads)
    if rep == 1:
        return _split(t, dim, tp, rank, "k/v projection")
    width = t.shape[dim] // num_kv_heads
    return t.narrow(dim, (rank // rep) * width, width).contiguous()


def _linear_slice(key: str, value, tp: int, rank: int, num_kv_heads: int):
    """Rank ``rank``'s slice of one layer-stacked linear (dense [L, in, out],
    bias [L, out], or quantized)."""
    col = key in COL_PARALLEL
    if isinstance(value, QuantizedTensor):
        if col:
            dim = value.qweight.dim() - 1
            cut = ((lambda t: _kv_cols(t, dim, tp, rank, num_kv_heads)) if key in KV_KEYS
                   else (lambda t: _split(t, dim, tp, rank, key)))
            return QuantizedTensor(qweight=cut(value.qweight), scales=cut(value.scales),
                                   bits=value.bits, group_size=value.group_size)
        groups = value.scales.shape[1]
        if groups % tp:
            raise ValueError(
                f"{key}: {groups} quantization groups of {value.group_size} rows do not "
                f"divide over tp={tp}; a row-parallel slice must be whole groups")
        return QuantizedTensor(qweight=_split(value.qweight, 1, tp, rank, key),
                               scales=_split(value.scales, 1, tp, rank, key),
                               bits=value.bits, group_size=value.group_size)
    if col:
        dim = value.dim() - 1
        if key in KV_KEYS:
            return _kv_cols(value, dim, tp, rank, num_kv_heads)
        return _split(value, dim, tp, rank, key)
    return _split(value, 1, tp, rank, key)


def _expert_slice(key: str, value: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Expert parallelism when the expert axis divides, else the
    intermediate dim inside every expert (JAX ``_spec_for_moe``)."""
    if value.shape[1] % tp == 0:
        return _split(value, 1, tp, rank, key)
    return _split(value, 3 if key in ("w1", "w3") else 2, tp, rank, key)


def shard_layer(key: str, value, tp: int, rank: int, num_kv_heads: int):
    """Rank ``rank``'s slice of one entry of ``params["layers"]``."""
    if tp == 1:
        return value
    if key in COL_PARALLEL or key in ROW_PARALLEL:
        return _linear_slice(key, value, tp, rank, num_kv_heads)
    if key in EXPERT_KEYS:
        return _expert_slice(key, value, tp, rank)
    return value  # norms, the router: replicated


def shard_lm_head(value, tp: int, rank: int):
    """Rank ``rank``'s vocab columns of an untied LM head [H, V] (dense or
    quantized: ``qweight`` and ``scales`` on their last dim)."""
    if tp == 1:
        return value
    if isinstance(value, QuantizedTensor):
        return QuantizedTensor(qweight=_split(value.qweight, 1, tp, rank, "lm_head"),
                               scales=_split(value.scales, 1, tp, rank, "lm_head"),
                               bits=value.bits, group_size=value.group_size)
    return _split(value, 1, tp, rank, "lm_head")


def shard_params(params: Dict[str, Any], group, num_kv_heads: int) -> Dict[str, Any]:
    """Rank ``group.rank``'s parameters of a model with ``num_kv_heads`` kv
    heads, by the rules of the module docstring. The input dict's stacked
    tensors are released key by key as they are sliced (pass a dict the
    caller no longer needs whole)."""
    tp, rank = group.tp, group.rank
    if tp == 1:
        return params
    layers = params["layers"]
    out_layers: Dict[str, Any] = {}
    for key in list(layers):
        out_layers[key] = shard_layer(key, layers.pop(key), tp, rank, num_kv_heads)
    out = {key: value for key, value in params.items() if key not in ("layers", "lm_head")}
    out["layers"] = out_layers
    if "lm_head" in params:
        out["lm_head"] = shard_lm_head(params["lm_head"], tp, rank)
    return out
