"""Llama-family model (Llama 2/3.x) in PyTorch over per-layer paged KV caches.

Counterpart of ``atoma_infer_tpu/models/llama.py`` (ref: models/src/llama.rs):
HF-config parsing incl. Llama-3 rope scaling, a rope cos/sin table to
``max_position_embeddings``, and a forward over a flattened ``[num_tokens]``
batch with one ragged paged-attention op per layer (prefill chunks and
decodes in one batch).

Parameters are a plain dict of tensors with the JAX package's pytree layout
(per-layer weights stacked on axis 0, projections stored ``[in, out]``), so
checkpoints and JAX parameters carry across one to one
(``weights.params_from_numpy``). The KV caches are a list of per-layer
``[num_pages, block_size, 2·Hk·D]`` tensors that the forward updates IN
PLACE (the JAX forward returns new caches instead). Tensor parallelism
(``kv_repeat``) and the TPU-only page-map prologue are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.attention import AttentionMetadata, alibi_slopes, paged_attention_layer
from ..ops.rope import RopeScalingConfig, apply_rope, compute_cos_sin_cache
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model hyperparameters (ref: llama.rs:22-124 LlamaConfig/Config)."""

    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScalingConfig] = None
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True
    eos_token_ids: Tuple[int, ...] = (128001, 128008, 128009)
    bos_token_id: int = 128000
    sliding_window: Optional[int] = None
    # ALiBi positional bias instead of rope.
    use_alibi: bool = False
    # Additive q/k/v projection biases (Qwen2-style; HF `attention_bias`).
    attention_bias: bool = False
    architecture: str = "llama"

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "LlamaConfig":
        """Build from an HF ``config.json`` dict (ref: llama.rs:22-83)."""
        scaling = None
        rs = d.get("rope_scaling")
        if rs and rs.get("rope_type", rs.get("type")) == "llama3":
            scaling = RopeScalingConfig(
                factor=rs.get("factor", 8.0),
                low_freq_factor=rs.get("low_freq_factor", 1.0),
                high_freq_factor=rs.get("high_freq_factor", 4.0),
                original_max_position_embeddings=rs.get(
                    "original_max_position_embeddings", 8192
                ),
            )
        eos = d.get("eos_token_id", 2)
        eos_ids = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
        n_heads = d["num_attention_heads"]
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=n_heads,
            num_key_value_heads=d.get("num_key_value_heads", n_heads),
            head_dim=d.get("head_dim", d["hidden_size"] // n_heads),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=scaling,
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            eos_token_ids=eos_ids,
            bos_token_id=d.get("bos_token_id", 1),
            use_alibi=bool(d.get("alibi", d.get("use_alibi", False))),
            attention_bias=bool(d.get("attention_bias", False)),
            architecture=d.get("model_type", "llama"),
        )

    @property
    def num_layers(self) -> int:
        return self.num_hidden_layers

    @property
    def num_kv_heads(self) -> int:
        return self.num_key_value_heads


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to ``x``'s dtype (ref: llama.rs:402-405)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an f32 result, the JAX ``preferred_element_type=f32``
    dot: bf16 operands on the card accumulate and return in f32 (no bf16
    rounding of the logits)."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())


class Llama:
    """Llama forward pass over the paged KV cache (ref: llama.rs:456-478)."""

    def __init__(
        self,
        config: LlamaConfig,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        """``device`` defaults to the current CUDA device and raises when
        there is none; tests pass ``device="cpu"``."""
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.rope_cos, self.rope_sin = compute_cos_sin_cache(
            config.head_dim,
            config.max_position_embeddings,
            config.rope_theta,
            config.rope_scaling,
            device=self.device,
        )
        self.alibi = (
            alibi_slopes(config.num_attention_heads, device=self.device)
            if config.use_alibi
            else None
        )

    # -- parameter construction -------------------------------------------------
    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random-init parameters (tests, the chip smoke and random-weight
        serving); ``generator`` lives on the model's device."""
        cfg = self.config
        h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        hq, hk, L = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.num_layers
        dev = self.device

        def init(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            return (w * fan_in**-0.5).to(self.dtype)

        def ones(shape):
            return torch.ones(shape, dtype=self.dtype, device=dev)

        params = {
            "embed": init((cfg.vocab_size, h), h),
            "layers": {
                "input_norm": ones((L, h)),
                "q_proj": init((L, h, hq * d), h),
                "k_proj": init((L, h, hk * d), h),
                "v_proj": init((L, h, hk * d), h),
                "o_proj": init((L, hq * d, h), hq * d),
                "post_norm": ones((L, h)),
                "gate_proj": init((L, h, i), h),
                "up_proj": init((L, h, i), h),
                "down_proj": init((L, i, h), i),
            },
            "final_norm": ones((h,)),
        }
        if cfg.attention_bias:
            params["layers"]["q_bias"] = init((L, hq * d), h)
            params["layers"]["k_bias"] = init((L, hk * d), h)
            params["layers"]["v_bias"] = init((L, hk * d), h)
        if not cfg.tie_word_embeddings:
            params["lm_head"] = init((h, cfg.vocab_size), h)
        return params

    # -- forward ------------------------------------------------------------------
    def embed_tokens(self, params: Dict[str, Any], token_ids: torch.Tensor) -> torch.Tensor:
        return params["embed"][token_ids.long()].to(self.dtype)

    def forward(
        self,
        params: Dict[str, Any],
        token_ids: torch.Tensor,   # [T] int flattened batch
        positions: torch.Tensor,   # [T] int per-token positions
        kv_cache: Sequence[torch.Tensor],  # L × [num_pages, bs, 2·Hk·D]
        attn_meta: AttentionMetadata,
    ) -> torch.Tensor:
        """Hidden states [T, H]; this step's K/V are written into
        ``kv_cache`` in place."""
        h = self.embed_tokens(params, token_ids)
        return self.forward_hidden(params, h, positions, kv_cache, attn_meta)

    def forward_hidden(
        self,
        params: Dict[str, Any],
        h: torch.Tensor,           # [T, H] hidden states (post-embed)
        positions: torch.Tensor,
        kv_cache: Sequence[torch.Tensor],
        attn_meta: AttentionMetadata,
    ) -> torch.Tensor:
        """Transformer layers over the hidden states, one paged cache per
        layer, updated in place."""
        cfg = self.config
        scale = cfg.head_dim**-0.5
        layers = params["layers"]
        num_layers = layers["input_norm"].shape[0]
        if len(kv_cache) != num_layers:
            raise ValueError(f"{len(kv_cache)} caches for {num_layers} layers")
        for i in range(num_layers):
            lp = {key: value[i] for key, value in layers.items()}
            # Attention block (ref: llama.rs:218-320).
            normed = rms_norm(h, lp["input_norm"], cfg.rms_norm_eps)
            q = normed @ lp["q_proj"]
            kk = normed @ lp["k_proj"]
            vv = normed @ lp["v_proj"]
            if "q_bias" in lp:
                q = q + lp["q_bias"].to(q.dtype)
                kk = kk + lp["k_bias"].to(kk.dtype)
                vv = vv + lp["v_bias"].to(vv.dtype)
            q = q.reshape(-1, cfg.num_attention_heads, cfg.head_dim)
            kk = kk.reshape(-1, cfg.num_key_value_heads, cfg.head_dim)
            vv = vv.reshape(-1, cfg.num_key_value_heads, cfg.head_dim)
            if self.alibi is None:
                q = apply_rope(q, positions, self.rope_cos, self.rope_sin)
                kk = apply_rope(kk, positions, self.rope_cos, self.rope_sin)
            # Write new KV into the paged cache, then attend over it
            # (ref: flash_attention.rs:360-361 order).
            attn = paged_attention_layer(
                q,
                kv_cache[i],
                kk,
                vv,
                attn_meta,
                scale=scale,
                sliding_window=cfg.sliding_window,
                alibi_slopes=self.alibi,
            )
            attn = attn.reshape(-1, cfg.num_attention_heads * cfg.head_dim)
            h = h + attn @ lp["o_proj"]
            # SwiGLU MLP block (ref: llama.rs:362-366).
            normed = rms_norm(h, lp["post_norm"], cfg.rms_norm_eps)
            gate = normed @ lp["gate_proj"]
            up = normed @ lp["up_proj"]
            h = h + (torch.nn.functional.silu(gate) * up) @ lp["down_proj"]
        return h

    def compute_logits(
        self,
        params: Dict[str, Any],
        hidden: torch.Tensor,  # [S, H] — already gathered at last-token rows
    ) -> torch.Tensor:
        """Final norm + LM head on the selected rows only, logits in f32
        (ref: llama.rs:474-477)."""
        cfg = self.config
        hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
        if cfg.tie_word_embeddings and "lm_head" not in params:
            return matmul_f32_out(hidden, params["embed"].t())
        return matmul_f32_out(hidden, params["lm_head"])

    # -- cache shape contract ---------------------------------------------------
    def kv_cache_shape(self, num_blocks: int, block_size: int) -> Tuple[int, int, int, int]:
        """Page-major fused K/V cache shape [L, pages, bs, 2·Hk·D] (one
        [pages, bs, 2·Hk·D] tensor per layer)."""
        cfg = self.config
        return (cfg.num_layers, num_blocks, block_size, 2 * cfg.num_kv_heads * cfg.head_dim)

    def alloc_kv_cache(self, num_blocks: int, block_size: int) -> List[torch.Tensor]:
        """Zeroed per-layer caches on the model's device."""
        L, *shape = self.kv_cache_shape(num_blocks, block_size)
        return [
            torch.zeros(shape, dtype=self.dtype, device=self.device) for _ in range(L)
        ]
