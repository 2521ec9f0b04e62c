"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made once with numpy from a seed and handed to both packages: to
the JAX package as ``jnp`` arrays, to the port as CPU tensors.
"""

from __future__ import annotations

import os

import ml_dtypes
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


def model_step(seq_lens, q_lens, tables, stream, bs=16):
    """One model step over sequences on the pages ``tables``: each of
    ``q_lens`` new tokens of ``stream`` per sequence, ending at
    ``seq_lens``. Returns (case dict, positions, token ids)."""
    S = len(seq_lens)
    T = -(-sum(q_lens) // 8) * 8
    bt = np.zeros((S, max(len(t) for t in tables)), np.int32)
    qsl = np.zeros(S + 1, np.int32)
    slots = np.full(T, -1, np.int32)
    positions = np.zeros(T, np.int32)
    toks = np.zeros(T, np.int32)
    for s, (kv, q, t) in enumerate(zip(seq_lens, q_lens, tables)):
        bt[s, : len(t)] = t
        qsl[s + 1] = qsl[s] + q
        for i in range(q):
            pos = kv - q + i
            slots[qsl[s] + i] = t[pos // bs] * bs + pos % bs
            positions[qsl[s] + i] = pos
            toks[qsl[s] + i] = stream[s][pos]
    case = dict(
        block_tables=bt, seq_lens=np.asarray(seq_lens, np.int32), query_start_loc=qsl,
        slot_mapping=slots, num_seqs=S, block_size=bs, max_q_len=max(q_lens),
        decode_only=all(q == 1 for q in q_lens),
    )
    return case, positions, toks


def valid_rows(case) -> int:
    """Token rows holding real queries (later rows are padding)."""
    return int(case["query_start_loc"][case["num_seqs"]])


FIXTURE_TINY_TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_trained")

# numpy dtypes (ml_dtypes for the 16- and 8-bit floats) ↔ torch dtypes, and
# the integer type of the same width each is viewed as to cross over.
_BIT_VIEWS = {
    np.dtype(ml_dtypes.bfloat16): (torch.bfloat16, np.int16, torch.int16),
    np.dtype(ml_dtypes.float8_e4m3fn): (torch.float8_e4m3fn, np.uint8, torch.uint8),
}


def to_torch(a) -> torch.Tensor:
    """A numpy or JAX array → a CPU tensor with the same bytes (bfloat16
    and float8_e4m3fn included)."""
    a = np.asarray(a)
    if a.dtype in _BIT_VIEWS:
        dtype, np_int, _ = _BIT_VIEWS[a.dtype]
        return torch.from_numpy(np.ascontiguousarray(a).view(np_int)).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(a))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor → numpy with the same bytes (ml_dtypes for bfloat16 and
    float8_e4m3fn)."""
    for np_dtype, (dtype, np_int, torch_int) in _BIT_VIEWS.items():
        if t.dtype == dtype:
            return t.contiguous().view(torch_int).numpy().view(np_dtype)
    return t.numpy()


def quantized_case(rng, seq_specs, kv_dtype, **kw):
    """``ragged_case`` over a 1-byte cache. ``"fp8"``: the random cache
    clipped to ±448 and rounded to e4m3. ``"int8"``: each slot's K and V
    halves quantized with their own absmax scale, rounded through bf16
    (``kv_scales`` [pages, bs, 2], K then V, as ml_dtypes bfloat16)."""
    case = ragged_case(rng, seq_specs, **kw)
    cache = case["kv_cache"]
    if kv_dtype == "fp8":
        case["kv_cache"] = np.clip(cache, -448, 448).astype(ml_dtypes.float8_e4m3fn)
        return case
    assert kv_dtype == "int8"
    D = case["q"].shape[2]
    nb, bs, row = cache.shape
    flat = cache.reshape(nb * bs, row)
    lanes_k = (np.arange(row) // D) % 2 == 0
    scales = np.stack(
        [np.abs(flat[:, lanes_k]).max(axis=1), np.abs(flat[:, ~lanes_k]).max(axis=1)], axis=1
    )
    scales = np.maximum(scales / np.float32(127), np.float32(1e-8))
    scales = scales.astype(ml_dtypes.bfloat16).astype(np.float32)
    sc_row = np.where(lanes_k[None, :], scales[:, :1], scales[:, 1:])
    quant = np.clip(np.round(flat * (np.float32(1) / sc_row)), -127, 127).astype(np.int8)
    case["kv_cache"] = quant.reshape(nb, bs, row)
    case["kv_scales"] = scales.astype(ml_dtypes.bfloat16).reshape(nb, bs, 2)
    return case


def jax_scale_pages(kv_scales) -> np.ndarray:
    """Port-layout scales [pages, bs, 2] → the JAX package's 128-lane bf16
    scale pages (K in lane 0, V in lane 1, zeros elsewhere)."""
    from atoma_infer_tpu.ops.kv_cache import SCALE_LANES

    s = np.asarray(kv_scales).astype(ml_dtypes.bfloat16)
    pages = np.zeros(s.shape[:2] + (SCALE_LANES,), ml_dtypes.bfloat16)
    pages[..., :2] = s
    return pages
