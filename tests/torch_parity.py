"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made once with numpy from a seed and handed to both packages: to
the JAX package as ``jnp`` arrays, to the port as CPU tensors.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from atoma_infer_tpu_torch.ops.attention import AttentionMetadata as TorchMeta


def ragged_case(
    rng,
    seq_specs,          # list of (q_len, kv_len)
    *,
    num_q_heads=4,
    num_kv_heads=2,
    head_dim=32,
    block_size=16,
    num_blocks=48,
    pad_tokens_to=8,
    pad_seqs_to=None,
):
    """A ragged batch over a random-filled page-major cache, every sequence
    on randomly permuted disjoint pages, plus decode-style slot mapping for
    each sequence's query tokens. Returns a dict of numpy arrays."""
    S = pad_seqs_to or len(seq_specs)
    total_q = sum(q for q, _ in seq_specs)
    T = -(-total_q // pad_tokens_to) * pad_tokens_to
    P = max(max(-(-kv // block_size) for _, kv in seq_specs), 2)
    perm = rng.permutation(num_blocks)
    tables = np.zeros((S, P), dtype=np.int32)
    seq_lens = np.zeros(S, dtype=np.int32)
    qsl = np.zeros(S + 1, dtype=np.int32)
    slots = np.full(T, -1, dtype=np.int32)
    used = 0
    for s, (q_len, kv_len) in enumerate(seq_specs):
        n = -(-kv_len // block_size)
        tables[s, :n] = perm[used: used + n]
        used += n
        assert used <= num_blocks
        seq_lens[s] = kv_len
        qsl[s + 1] = qsl[s] + q_len
        for i in range(q_len):
            pos = kv_len - q_len + i
            slots[qsl[s] + i] = tables[s, pos // block_size] * block_size + pos % block_size
    qsl[len(seq_specs) + 1:] = qsl[len(seq_specs)]
    row = 2 * num_kv_heads * head_dim
    return dict(
        q=rng.standard_normal((T, num_q_heads, head_dim)).astype(np.float32),
        kv_cache=rng.standard_normal((num_blocks, block_size, row)).astype(np.float32),
        k_new=rng.standard_normal((T, num_kv_heads, head_dim)).astype(np.float32),
        v_new=rng.standard_normal((T, num_kv_heads, head_dim)).astype(np.float32),
        block_tables=tables,
        seq_lens=seq_lens,
        query_start_loc=qsl,
        slot_mapping=slots,
        num_seqs=len(seq_specs),
        block_size=block_size,
        max_q_len=max(q for q, _ in seq_specs),
        decode_only=all(q == 1 for q, _ in seq_specs),
    )


def jax_meta(case):
    import jax.numpy as jnp

    from atoma_infer_tpu.ops.attention import AttentionMetadata

    return AttentionMetadata(
        slot_mapping=jnp.asarray(case["slot_mapping"]),
        block_tables=jnp.asarray(case["block_tables"]),
        seq_lens=jnp.asarray(case["seq_lens"]),
        query_start_loc=jnp.asarray(case["query_start_loc"]),
        num_seqs=jnp.asarray(case["num_seqs"], jnp.int32),
        block_size=case["block_size"],
        decode_only=case["decode_only"],
    )


def torch_meta(case, device="cpu"):
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return TorchMeta(
        slot_mapping=t(case["slot_mapping"]),
        block_tables=t(case["block_tables"]),
        seq_lens=t(case["seq_lens"]),
        query_start_loc=t(case["query_start_loc"]),
        num_seqs=t([case["num_seqs"]]),
        block_size=case["block_size"],
        decode_only=case["decode_only"],
        max_q_len=case["max_q_len"],
    )


def valid_rows(case) -> int:
    """Token rows holding real queries (later rows are padding)."""
    return int(case["query_start_loc"][case["num_seqs"]])


FIXTURE_TINY_TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_trained")
