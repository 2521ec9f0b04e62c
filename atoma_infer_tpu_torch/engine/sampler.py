"""On-device batched sampling.

Counterpart of ``atoma_infer_tpu/engine/sampler.py`` (ref:
backends/vllm/src/model_executor.rs:144-282): penalties over the recent-token
window, temperature, top-k / top-p / typical masks, greedy or Gumbel-max
sampling and top-n alternatives for the whole batch at once, on the logits'
device; only the chosen tokens and logprobs go back to the host.

Greedy choice, logprobs and masks compute what the JAX sampler computes. The
random stream differs by design: JAX draws its Gumbel noise from threefry
keyed by ``fold_in(fold_in(0, seed), step)``, which PyTorch cannot
reproduce. The port keeps the contract instead — one ``torch.Generator`` per
sampled row, seeded from (seed, per-sequence step), so a draw is
deterministic per (seed, step) and replays identically after preemption.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..sampling_params import NextTokenChooserParameters

# Repetition/frequency penalties look back over this many tokens
# (ref: model_executor.rs repeat_last_n handling).
PENALTY_WINDOW = 64


@dataclasses.dataclass
class SamplingTensors:
    """Per-sequence sampling parameters as host arrays (bucketed to S)."""

    temperature: np.ndarray     # [S] f32
    top_k: np.ndarray           # [S] i32 (0 = disabled)
    top_p: np.ndarray           # [S] f32 (1.0 = disabled)
    typical_p: np.ndarray       # [S] f32 (1.0 = disabled)
    do_sample: np.ndarray       # [S] bool
    seeds: np.ndarray           # [S] u32
    repetition_penalty: np.ndarray  # [S] f32 (1.0 = disabled)
    frequency_penalty: np.ndarray   # [S] f32 (0.0 = disabled)
    recent_tokens: np.ndarray   # [S, PENALTY_WINDOW] i32 (-1 pad)
    needs_sampling: bool        # any do_sample → run the stochastic path
    needs_penalties: bool
    needs_typical: bool
    top_n: int                  # max top_n_tokens requested (0 = off)

    @classmethod
    def build(
        cls,
        params_list: List[NextTokenChooserParameters],
        recent_token_lists: List[List[int]],
        num_slots: int,
        top_n_list: Optional[List[int]] = None,
    ) -> "SamplingTensors":
        S = num_slots
        t = np.ones(S, dtype=np.float32)
        tk = np.zeros(S, dtype=np.int32)
        tp = np.ones(S, dtype=np.float32)
        typ = np.ones(S, dtype=np.float32)
        ds = np.zeros(S, dtype=bool)
        sd = np.zeros(S, dtype=np.uint32)
        rp = np.ones(S, dtype=np.float32)
        fp = np.zeros(S, dtype=np.float32)
        recent = np.full((S, PENALTY_WINDOW), -1, dtype=np.int32)
        for i, p in enumerate(params_list):
            t[i] = max(p.temperature, 1e-5)
            tk[i] = max(p.top_k, 0)
            tp[i] = p.top_p
            typ[i] = getattr(p, "typical_p", 1.0)
            ds[i] = p.do_sample and p.temperature > 1e-5
            sd[i] = np.uint32(p.seed & 0xFFFFFFFF)
            rp[i] = p.repetition_penalty
            fp[i] = p.frequency_penalty
            toks = recent_token_lists[i][-PENALTY_WINDOW:]
            if toks:
                recent[i, : len(toks)] = toks
        needs_penalties = any(
            p.repetition_penalty != 1.0 or p.frequency_penalty != 0.0
            for p in params_list
        )
        return cls(
            temperature=t,
            top_k=tk,
            top_p=tp,
            typical_p=typ,
            do_sample=ds,
            seeds=sd,
            repetition_penalty=rp,
            frequency_penalty=fp,
            recent_tokens=recent,
            needs_sampling=bool(ds.any()),
            needs_penalties=needs_penalties,
            needs_typical=bool((typ < 1.0).any()),
            top_n=max(top_n_list) if top_n_list else 0,
        )

    def to_device(self, device, sample_mask: np.ndarray) -> dict:
        """The per-row parameters as tensors on ``device`` (one transfer
        each; the worker caches them while the batch is unchanged)."""

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return {
            "temperature": put(self.temperature),
            "top_k": put(self.top_k),
            "top_p": put(self.top_p),
            "typical_p": put(self.typical_p),
            "do_sample": put(self.do_sample & sample_mask),
            "repetition_penalty": put(self.repetition_penalty),
            "frequency_penalty": put(self.frequency_penalty),
            "recent_tokens": put(self.recent_tokens),
        }


def apply_penalties(
    logits: torch.Tensor,              # [S, V] f32
    recent_tokens: torch.Tensor,       # [S, W] int, -1 pad
    repetition_penalty: torch.Tensor,  # [S]
    frequency_penalty: torch.Tensor,   # [S]
) -> torch.Tensor:
    """Repetition (divide/multiply) + frequency (count-scaled subtract)
    penalties over the recent-token window (ref: model_executor.rs:173-278)."""
    S, V = logits.shape
    idx = torch.where(recent_tokens < 0, V, recent_tokens).long()  # pad → spare column
    counts = torch.zeros((S, V + 1), dtype=logits.dtype, device=logits.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=logits.dtype))
    counts = counts[:, :V]
    seen = counts > 0
    rp = repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen, penalized, logits)
    return logits - frequency_penalty[:, None] * counts


def _top_k_mask(logits: torch.Tensor, top_k: torch.Tensor, max_k: int) -> torch.Tensor:
    """Mask all but each row's top-k entries (k=0 disables)."""
    max_k = min(max_k, logits.shape[-1])
    kth_vals = torch.topk(logits, max_k, dim=-1).values  # [S, max_k] descending
    k = top_k.long().clamp(1, max_k)
    thresh = torch.gather(kth_vals, 1, (k - 1)[:, None])  # [S, 1]
    keep = (logits >= thresh) | (top_k[:, None] <= 0)
    return torch.where(keep, logits, -torch.inf)


def _top_p_mask(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose probability
    mass reaches top_p (exact, via a full descending sort)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep entries whose *exclusive* cumulative mass is < top_p (always keeps
    # the argmax).
    keep_sorted = (cum - probs) < top_p[:, None]
    thresh = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    keep = (logits >= thresh) | (top_p[:, None] >= 1.0)
    return torch.where(keep, logits, -torch.inf)


def _typical_p_mask(logits: torch.Tensor, typical_p: torch.Tensor) -> torch.Tensor:
    """Locally-typical filtering (Meister et al., 2022): keep the tokens
    whose surprisal is closest to the distribution's entropy, accumulating
    probability mass to typical_p."""
    lp = torch.log_softmax(logits, dim=-1)
    p = lp.exp()
    ent = -(p * torch.where(p > 0, lp, 0.0)).sum(dim=-1, keepdim=True)
    dev = (-lp - ent).abs()
    order = torch.argsort(dev, dim=-1, stable=True)   # ascending deviation
    p_sorted = torch.gather(p, 1, order)
    cum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (cum - p_sorted) < typical_p[:, None]  # ≥1 token kept
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    keep |= typical_p[:, None] >= 1.0
    return torch.where(keep, logits, -torch.inf)


def gumbel_noise(
    seeds: np.ndarray,   # [S] u32 per-row seeds
    steps: np.ndarray,   # [S] per-sequence generated-token counts
    rows: np.ndarray,    # row indices that sample (others get zeros)
    vocab_size: int,
    device,
) -> torch.Tensor:
    """[S, V] f32 Gumbel(0, 1) noise; row r's draw depends only on
    (seeds[r], steps[r]) — replay-stable across preemption and swap."""
    noise = torch.zeros((len(seeds), vocab_size), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    tiny = torch.finfo(torch.float32).tiny
    for r in rows:
        gen.manual_seed((int(seeds[r]) << 32) | (int(steps[r]) & 0xFFFFFFFF))
        u = torch.rand(vocab_size, generator=gen, device=device).clamp_(min=tiny)
        noise[r] = -torch.log(-torch.log(u))
    return noise


def sample(
    logits: torch.Tensor,       # [S, V] f32 (last-token logits per sequence)
    *,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
    do_sample: torch.Tensor,
    repetition_penalty: torch.Tensor,
    frequency_penalty: torch.Tensor,
    recent_tokens: torch.Tensor,
    gumbel: Optional[torch.Tensor],  # [S, V] from gumbel_noise, when sampling
    needs_penalties: bool,
    typical_p: Optional[torch.Tensor] = None,
    needs_typical: bool = False,
    top_n: int = 0,
    max_top_k: int = 128,
):
    """Returns (token ids [S] i32, logprobs [S] f32, top-n (ids, logprobs) or
    None). ``gumbel`` None means a greedy-only batch."""
    if needs_penalties:
        logits = apply_penalties(
            logits, recent_tokens, repetition_penalty, frequency_penalty
        )
    # Logprob of the chosen token from the post-penalty distribution
    # (ref: model_executor.rs logprob extraction).
    logprobs_full = torch.log_softmax(logits, dim=-1)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)

    if gumbel is None:
        chosen = greedy
    else:
        scaled = logits / temperature[:, None]
        scaled = _top_k_mask(scaled, top_k, max_top_k)
        scaled = _top_p_mask(scaled, top_p)
        if needs_typical and typical_p is not None:
            scaled = _typical_p_mask(scaled, typical_p)
        sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
        chosen = torch.where(do_sample, sampled, greedy)

    logprob = torch.gather(logprobs_full, 1, chosen.long()[:, None])[:, 0]
    if top_n > 0:
        # Top-n alternative tokens per row (TGI-style top_n_tokens).
        top_lps, top_ids = torch.topk(logprobs_full, top_n, dim=-1)
        return chosen, logprob, (top_ids.to(torch.int32), top_lps)
    return chosen, logprob, None
