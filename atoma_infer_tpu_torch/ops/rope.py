"""Rotary position embeddings with Llama-3 frequency scaling.

Counterpart of ``atoma_infer_tpu/ops/rope.py`` (ref: models/src/llama.rs:141-200):
a cos/sin table precomputed to ``max_position_embeddings`` with llama3
low/high-frequency smoothing, applied by gathering rows at flat token
positions over the ``[num_tokens, heads, head_dim]`` batch layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RopeScalingConfig:
    """Llama-3 rope scaling parameters (ref: llama.rs:22-83 config deser)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    rope_type: str = "llama3"


def compute_inv_freq(
    head_dim: int,
    rope_theta: float,
    scaling: Optional[RopeScalingConfig] = None,
    device=None,
) -> torch.Tensor:
    """Base inverse frequencies [head_dim//2] f32, optionally llama3-smoothed
    (ref: llama.rs:155-187)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (rope_theta**exponent)
    if scaling is None or scaling.rope_type != "llama3":
        return inv_freq
    low_freq_wavelen = scaling.original_max_position_embeddings / scaling.low_freq_factor
    high_freq_wavelen = scaling.original_max_position_embeddings / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    # Low-frequency bands are divided by the factor; high-frequency bands are
    # kept; the middle is smoothly interpolated (llama3 smoothing).
    smooth = (
        scaling.original_max_position_embeddings / wavelen - scaling.low_freq_factor
    ) / (scaling.high_freq_factor - scaling.low_freq_factor)
    smoothed = (1.0 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
    return torch.where(
        wavelen > low_freq_wavelen,
        inv_freq / scaling.factor,
        torch.where(wavelen < high_freq_wavelen, inv_freq, smoothed),
    )


def compute_cos_sin_cache(
    head_dim: int,
    max_positions: int,
    rope_theta: float,
    scaling: Optional[RopeScalingConfig] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[max_positions, head_dim//2]`` cos/sin tables in f32
    (ref: llama.rs:141-200)."""
    inv_freq = compute_inv_freq(head_dim, rope_theta, scaling, device=device)
    t = torch.arange(max_positions, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor,          # [num_tokens, num_heads, head_dim]
    positions: torch.Tensor,  # [num_tokens] int
    cos_cache: torch.Tensor,
    sin_cache: torch.Tensor,
) -> torch.Tensor:
    """Rotate ``x`` by per-token positions, HF Llama "rotate_half"
    convention: halves (x1, x2) → (x1·cos − x2·sin, x2·cos + x1·sin), in f32,
    cast back to ``x``'s dtype (ref: llama.rs:218-251)."""
    pos = positions.long()
    cos = cos_cache[pos][:, None, :]  # [T, 1, D/2]
    sin = sin_cache[pos][:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
