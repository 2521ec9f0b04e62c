"""Gemma-2 in PyTorch (counterpart of ``atoma_infer_tpu/models/gemma.py``).

Llama's paged-KV attention with Gemma-2's deltas:

- zero-centred RMSNorm, ``x̂ · (1 + w)`` in f32;
- four norms a layer (pre and post attention, pre and post feed-forward),
  the post-norms on the sublayer's OUTPUT before the residual add;
- a GeGLU MLP (tanh-approximate gelu gate);
- the embedding scaled by ``sqrt(hidden)``, the scale cast to the model's
  dtype first (as HF does); the attention scale ``query_pre_attn_scalar**-0.5``;
- a tanh soft cap on the attention scores (passed to the kernels) and on the
  final logits, after the tied LM head.

The sliding window alternates by layer (even layers local, odd global) and
is static per layer, so each layer's kernel calls carry their own window (a
CUDA graph records it at capture). The engine-level window stays None: the
global layers need every page, so the block manager must never trim pages.
Gemma-2's head dim is 256, which the attention kernels take for bf16
queries over a bf16 cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from ..ops.attention import AttentionMetadata
from .llama import Llama, LlamaConfig, _linear


@dataclasses.dataclass(frozen=True)
class GemmaConfig(LlamaConfig):
    """Gemma-2 hyperparameters (HF ``Gemma2Config`` fields)."""

    # tanh caps on the attention scores (before the mask) and final logits.
    attn_logit_softcapping: Optional[float] = 50.0
    final_logit_softcapping: Optional[float] = 30.0
    # The attention scale is query_pre_attn_scalar**-0.5, not head_dim**-0.5.
    query_pre_attn_scalar: float = 256.0
    # The local layers' window; every ``sliding_window_pattern``-th layer is
    # global (Gemma-2: pattern 2, even layers local).
    local_sliding_window: Optional[int] = 4096
    sliding_window_pattern: int = 2

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "GemmaConfig":
        base = LlamaConfig.from_hf_dict(d)
        base_kw = {f.name: getattr(base, f.name) for f in dataclasses.fields(LlamaConfig)}
        # Gemma ties its embeddings unless told otherwise; its engine-level
        # window stays None (see the module's docstring).
        base_kw["tie_word_embeddings"] = d.get("tie_word_embeddings", True)
        base_kw["sliding_window"] = None
        base_kw["bos_token_id"] = d.get("bos_token_id", 2)
        eos = d.get("eos_token_id", 1)
        base_kw["eos_token_ids"] = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
        return cls(
            **base_kw,
            attn_logit_softcapping=d.get("attn_logit_softcapping"),
            final_logit_softcapping=d.get("final_logit_softcapping"),
            query_pre_attn_scalar=float(d.get("query_pre_attn_scalar", 256)),
            local_sliding_window=d.get("sliding_window", 4096),
            sliding_window_pattern=int(d.get("sliding_window_pattern", 2)),
        )

    def layer_sliding_window(self, layer_idx: int) -> Optional[int]:
        """Layer ``layer_idx``'s window: local unless ``(i + 1) % pattern ==
        0`` (HF ``is_sliding``)."""
        if self.local_sliding_window is None:
            return None
        if (layer_idx + 1) % self.sliding_window_pattern == 0:
            return None
        return self.local_sliding_window


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Zero-centred RMSNorm in f32: ``x̂ · (1 + w)`` (HF Gemma2RMSNorm)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


class Gemma2(Llama):
    """Gemma-2's forward over Llama's paged-KV attention sublayer."""

    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        """Zero-centred norms (scale 1 + w: zeros), and each layer's pre and
        post feed-forward norms."""
        params = super().init_params(generator)
        cfg = self.config
        zeros = torch.zeros((cfg.num_layers, cfg.hidden_size), dtype=self.dtype,
                            device=self.device)
        for key in ("input_norm", "post_norm", "pre_ffw_norm", "post_ffw_norm"):
            params["layers"][key] = zeros.clone()
        params["final_norm"] = torch.zeros((cfg.hidden_size,), dtype=self.dtype,
                                           device=self.device)
        return params

    @property
    def attn_scale(self) -> float:
        return self.config.query_pre_attn_scalar**-0.5

    def embed_tokens(self, params: Dict[str, Any], token_ids: torch.Tensor) -> torch.Tensor:
        """The embedding scaled by sqrt(hidden), the scale cast to the
        model's dtype first (as HF does)."""
        normalizer = torch.tensor(self.config.hidden_size**0.5, dtype=self.dtype).item()
        return params["embed"][token_ids.long()].to(self.dtype) * normalizer

    def forward_hidden(
        self,
        params: Dict[str, Any],
        h: torch.Tensor,
        positions: torch.Tensor,
        kv_cache: Sequence[torch.Tensor],
        attn_meta: AttentionMetadata,
        kv_scales: Optional[Sequence[torch.Tensor]] = None,
        layer_offset: int = 0,
    ) -> torch.Tensor:
        """Each layer's window is that of its index in the whole model:
        ``layer_offset`` plus its index in ``params`` (a pipeline stage's
        first layer may be odd)."""
        cfg = self.config
        eps = cfg.rms_norm_eps
        for i, lp in enumerate(self._layers(params, kv_cache, kv_scales)):
            attn = self._attention(
                gemma_rms_norm(h, lp["input_norm"], eps), lp, positions, kv_cache[i], attn_meta,
                None if kv_scales is None else kv_scales[i],
                sliding_window=cfg.layer_sliding_window(layer_offset + i), soft_cap=cfg.attn_logit_softcapping)
            # The post-norms act on each sublayer's output, then the residual.
            h = h + gemma_rms_norm(attn, lp["post_norm"], eps)
            mlp = self._mlp_block(gemma_rms_norm(h, lp["pre_ffw_norm"], eps), lp)
            h = h + gemma_rms_norm(mlp, lp["post_ffw_norm"], eps)
        return h

    def _mlp_block(self, normed: torch.Tensor, lp: Dict[str, Any]) -> torch.Tensor:
        """GeGLU: the tanh-approximate gelu of the gate times up."""
        gate = _linear(normed, lp["gate_proj"])
        up = _linear(normed, lp["up_proj"])
        return self._sum_over_ranks(
            _linear(torch.nn.functional.gelu(gate, approximate="tanh") * up, lp["down_proj"]))

    def compute_logits(self, params: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
        """Final zero-centred norm, the (tied) LM head in f32, then the
        final-logit soft cap."""
        cfg = self.config
        normed = gemma_rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
        return _softcap(self._lm_head(params, normed), cfg.final_logit_softcapping)
