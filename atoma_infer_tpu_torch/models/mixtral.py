"""Mixtral (sparse mixture of experts) in PyTorch (counterpart of
``atoma_infer_tpu/models/mixtral.py``).

Mistral's attention with a top-k MoE feed-forward (HF
``MixtralSparseMoeBlock``): a router picks ``k`` of ``E`` experts a token,
each expert a SwiGLU MLP, their outputs mixed by the router's softmax
renormalized over the chosen k. As in the JAX package, every expert runs on
every token as dense products over the stacked expert weights ``[E, H, I]``
and the mix applies the (mostly zero) ``[T, E]`` weights: decode reads each
expert's weights once a step either way, and the products are plain matrix
products outside any kernel.

Expert parallelism (``parallel/sharding.py``): under tensor parallelism with
``E % tp == 0`` each rank holds E/tp whole experts and mixes their outputs by
its columns of the replicated router's weights; otherwise each rank holds a
slice of every expert's intermediate dim. Either way the ranks' partial
mixes are summed (``TpGroup.all_reduce_sum``), as the JAX mesh's psum over
the sharded axis does (``atoma_infer_tpu/models/mixtral.py:85-110``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .llama import Llama, LlamaConfig


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    """Mistral's config and the MoE fields (HF ``MixtralConfig``)."""

    num_local_experts: int = 8
    num_experts_per_tok: int = 2

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "MixtralConfig":
        base = LlamaConfig.from_hf_dict(d)
        base_kw = {f.name: getattr(base, f.name) for f in dataclasses.fields(LlamaConfig)}
        base_kw["sliding_window"] = d.get("sliding_window")
        base_kw["rope_scaling"] = None
        return cls(
            **base_kw,
            num_local_experts=int(d.get("num_local_experts", 8)),
            num_experts_per_tok=int(d.get("num_experts_per_tok", 2)),
        )


class Mixtral(Llama):
    """Llama's paged-KV attention; the sparse-MoE feed-forward."""

    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        """Llama's parameters with the dense MLP replaced by a router [L, H,
        E] and stacked experts w1, w3 [L, E, H, I] and w2 [L, E, I, H]."""
        params = super().init_params(generator)
        cfg = self.config
        L, h, inter, E = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                          cfg.num_local_experts)

        def init(shape, fan_in):
            # Layer by layer, so that no f32 copy of a whole stack is made.
            return torch.stack([
                (torch.randn(shape[1:], generator=generator, device=self.device)
                 * fan_in**-0.5).to(self.dtype) for _ in range(shape[0])])

        layers = params["layers"]
        for key in ("gate_proj", "up_proj", "down_proj"):
            del layers[key]
        layers["router"] = init((L, h, E), h)
        layers["w1"] = init((L, E, h, inter), h)
        layers["w3"] = init((L, E, h, inter), h)
        layers["w2"] = init((L, E, inter, h), inter)
        return params

    def _mlp_block(self, normed: torch.Tensor, lp: Dict[str, Any]) -> torch.Tensor:
        cfg = self.config
        # Router: softmax in f32, top-k, renormalized over the chosen k.
        probs = torch.softmax((normed @ lp["router"]).float(), dim=-1)       # [T, E]
        topv, topi = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)      # [T, k]
        topv = topv / topv.sum(dim=-1, keepdim=True)
        one_hot = torch.nn.functional.one_hot(topi, cfg.num_local_experts).float()
        mix = (topv[..., None] * one_hot).sum(dim=1)                          # [T, E]
        experts = lp["w1"].shape[0]  # this rank's: E/tp under expert parallelism
        if experts != cfg.num_local_experts:
            mix = mix.chunk(self.tp, dim=1)[self.group.rank]
        # The JAX package's einsums as batched products over the experts,
        # which read the stacks [E, H, I] where they lie: torch.einsum of
        # "th,ehi->tei" copies a stack into another layout first (0.94 GB
        # a layer at Mixtral-8x7B's widths).
        x = normed.unsqueeze(0).expand(experts, -1, -1)                       # [E, T, H]
        g = torch.bmm(x, lp["w1"])                                           # [E, T, I]
        u = torch.bmm(x, lp["w3"])
        y = torch.bmm(torch.nn.functional.silu(g) * u, lp["w2"])             # [E, T, H]
        out = torch.einsum("te,eth->th", mix.to(y.dtype), y)
        return self._sum_over_ranks(out).to(normed.dtype)
