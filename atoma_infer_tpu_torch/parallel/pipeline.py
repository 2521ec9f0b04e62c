"""Pipeline parallelism: the layer split, per-stage parameters and devices.

Counterpart of ``atoma_infer_tpu/parallel/pipeline.py``. The layers split
into ``pp`` contiguous stages; each stage holds its layers' parameters (the
first the embedding, the last the final norm and the LM head), its own KV
cache over its layers and its own device, and the engine keeps one step per
cohort of requests in flight so that the stages overlap
(``engine/pp_worker.py``, ``engine/llm_engine.py``).

JAX gives each stage a tp-mesh over consecutive device groups. Here a
rank's stage ``s`` sits on card ``s · local_ranks + local_rank`` of its
host when the host has a card for every (stage, rank) pair — the same
consecutive groups — and otherwise the stages share cards, as tensor-
parallel ranks already do (``group.local_device``): the card index modulo
the host's cards (:func:`stage_devices`). The layout is logged. Under
tensor parallelism each stage's parameters are the rank's shard of that
stage (``sharding.shard_params``, key by key, so a stage without an
``lm_head`` simply has none to shard).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..ops.quant import QuantizedTensor
from .sharding import shard_params

logger = logging.getLogger(__name__)


def stage_layer_bounds(num_layers: int, pp: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` layer ranges, one a stage; the earlier stages
    take the remainder (JAX ``stage_layer_bounds``)."""
    if not 1 <= pp <= num_layers:
        raise ValueError(f"pipeline_parallel_size {pp} must be in [1, num_layers {num_layers}]")
    base, rem = divmod(num_layers, pp)
    bounds, lo = [], 0
    for s in range(pp):
        hi = lo + base + (1 if s < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _layer_slice(value, lo: int, hi: int):
    """Layers ``[lo, hi)`` of one stacked parameter, as views (a
    ``QuantizedTensor``'s ``qweight`` and ``scales`` together)."""
    if isinstance(value, QuantizedTensor):
        return QuantizedTensor(qweight=value.qweight[lo:hi], scales=value.scales[lo:hi],
                               bits=value.bits, group_size=value.group_size)
    return value[lo:hi]


def split_params(params: Dict[str, Any], pp: int) -> List[Dict[str, Any]]:
    """The per-stage parameter dicts of a full model's (JAX
    ``split_params``): stage 0 carries ``embed``; the last stage carries
    ``final_norm`` and ``lm_head``, or ``embed`` again when the embeddings
    are tied (the LM head reads ``embed.T``). Layer tensors are views of the
    full ones."""
    num_layers = params["layers"]["input_norm"].shape[0]
    stages = []
    for s, (lo, hi) in enumerate(stage_layer_bounds(num_layers, pp)):
        stage: Dict[str, Any] = {
            "layers": {k: _layer_slice(v, lo, hi) for k, v in params["layers"].items()}
        }
        if s == 0:
            stage["embed"] = params["embed"]
        if s == pp - 1:
            stage["final_norm"] = params["final_norm"]
            if "lm_head" in params:
                stage["lm_head"] = params["lm_head"]
            elif "embed" not in stage:
                stage["embed"] = params["embed"]
        stages.append(stage)
    return stages


def stage_devices(pp: int, device: torch.device, local_ranks: int,
                  local_devices: int) -> List[torch.device]:
    """The device of each of one rank's ``pp`` stages, stage 0 on the
    rank's own ``device``: card ``(device + s · local_ranks) %
    local_devices``. A rank on card r of a host with ``pp · local_ranks``
    cards thus takes cards r, r + local_ranks, … (JAX's consecutive device
    groups, one a stage); with fewer cards the stages share them. The CPU
    for a CPU service."""
    if device.type == "cpu":
        return [device] * pp
    return [torch.device("cuda", (device.index + s * local_ranks) % local_devices)
            for s in range(pp)]


def log_layout(bounds: Sequence[Tuple[int, int]], devices: Sequence[torch.device],
               rank: int = 0) -> None:
    shared = len(set(devices)) < len(devices)
    logger.info("pipeline parallelism, rank %d: %s%s", rank,
                ", ".join(f"stage {s} layers [{lo}, {hi}) on {d}"
                          for s, ((lo, hi), d) in enumerate(zip(bounds, devices))),
                " (stages share a device: their KV pools share its memory)" if shared else "")


def _to_device(tree, device: torch.device, copy: bool):
    if isinstance(tree, dict):
        return {k: _to_device(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, qweight=tree.qweight.to(device, copy=copy),
                                   scales=tree.scales.to(device, copy=copy))
    return tree.to(device, copy=copy)


def place_stage_params(stage_params: List[Dict[str, Any]], groups: Sequence,
                       devices: Sequence[torch.device],
                       num_kv_heads: int) -> List[Dict[str, Any]]:
    """Each stage's parameters as this rank holds them (JAX
    ``shard_stage_params``): the rank's shard under its stage group
    (``groups[s]``; None for one rank), on the stage's device. When every
    stage shares one device the layers stay views of the whole tensors;
    when they spread over devices every stage gets copies, so that the
    whole tensors are freed."""
    spread = len(set(devices)) > 1
    out = []
    for params, group, device in zip(stage_params, groups, devices):
        if group is not None and group.tp > 1:
            params = shard_params(params, group, num_kv_heads)
        out.append(_to_device(params, device, spread))
    return out
