"""The teacher-forced decode loop shared by the quantization gates.

The JAX tools (``tools/w8a8_gate.py``, ``tools/kv_quant_gate.py``,
``tools/quality_ladder.py``) each decode S sequences for N steps over a
paged cache whose pages are a random permutation from
``numpy.random.default_rng(0)``: once as the reference, then once per
variant fed the reference's tokens, so that the drift of the logprob of
the reference's chosen token isolates quantization numerics. This module
holds what the three share: their model configurations, the page tables,
one decode step's metadata, and a step that returns the greedy tokens and
the logprobs of the tokens asked for (gathered on the device, so the full
``[S, V]`` logprobs never cross to the host).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.llama import Llama, LlamaConfig
from ..ops import quant_kernels
from ..ops.attention import AttentionMetadata


def gate_config(on_card: bool, tie_word_embeddings: bool) -> Tuple[LlamaConfig, int]:
    """(config, block size) of the random-weight gates: the Llama-3.2-1B
    widths with 16 layers and blocks of 32 on the card, a tiny 2-layer model
    with blocks of 16 on the CPU (``w8a8_gate.py:54-70``,
    ``kv_quant_gate.py:54-71``)."""
    if on_card:
        cfg = LlamaConfig(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192,
            num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
            head_dim=64, max_position_embeddings=4096,
            tie_word_embeddings=tie_word_embeddings,
        )
        return cfg, 32
    cfg = LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=4, head_dim=32,
        max_position_embeddings=1024, tie_word_embeddings=tie_word_embeddings,
    )
    return cfg, 16


# The JAX tools' ``--cpu`` sizes (seqs, ctx, steps), which they force.
CPU_SIZES = (4, 64, 8)


def page_tables(rng: np.random.Generator, seqs: int, pages_per_seq: int) -> Tuple[int, np.ndarray]:
    """(number of pages, [seqs, pages_per_seq] tables): distinct random pages
    from 1 up, 8 pages to spare, as the JAX tools draw them."""
    num_blocks = seqs * pages_per_seq + 8
    perm = rng.permutation(num_blocks - 1)[: seqs * pages_per_seq] + 1
    return num_blocks, perm.reshape(seqs, pages_per_seq).astype(np.int32)


def ints(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def decode_step_inputs(tables: np.ndarray, kv_len: int, block_size: int, device
                       ) -> Tuple[torch.Tensor, AttentionMetadata]:
    """(positions, metadata) of a pure-decode step in which every sequence
    writes its token at position ``kv_len``."""
    seqs = tables.shape[0]
    page = tables[np.arange(seqs), kv_len // block_size]
    meta = AttentionMetadata(
        slot_mapping=ints(page * block_size + kv_len % block_size, device),
        block_tables=ints(tables, device),
        seq_lens=ints(np.full(seqs, kv_len + 1), device),
        query_start_loc=ints(np.arange(seqs + 1), device),
        num_seqs=ints([seqs], device),
        block_size=block_size,
        decode_only=True,
        max_q_len=1,
    )
    return ints(np.full(seqs, kv_len), device), meta


def logprob_step(
    model: Llama,
    params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    kv_cache: Sequence[torch.Tensor],
    meta: AttentionMetadata,
    kv_scales: Optional[Sequence[torch.Tensor]] = None,
    rows: Optional[torch.Tensor] = None,
    chosen: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward step (the caches updated in place). Takes the hidden
    states at ``rows`` (default: all), and returns (greedy tokens, the f32
    logprob of ``chosen``, default the greedy tokens themselves)."""
    hidden = model.forward(params, tokens, positions, kv_cache, meta, kv_scales=kv_scales)
    if rows is not None:
        hidden = hidden[rows]
    logits = model.compute_logits(params, hidden).float()
    logprobs = torch.log_softmax(logits, dim=-1)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    pick = toks if chosen is None else chosen
    return toks, logprobs.gather(1, pick.long()[:, None])[:, 0]


@contextlib.contextmanager
def w8a8(enabled: bool):
    """Flip the process-wide W8A8 switch (``quant_kernels._W8A8``) for a
    run, and restore it after."""
    saved = quant_kernels._W8A8
    quant_kernels._W8A8 = enabled
    try:
        yield
    finally:
        quant_kernels._W8A8 = saved


def device_name(device: torch.device) -> str:
    """The ``backend`` the tools report: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
