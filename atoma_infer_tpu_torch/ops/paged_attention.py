"""Ragged paged attention: the CUDA kernels and their plain versions.

Replaces the TPU kernel ``atoma_infer_tpu/ops/paged_attention.py:_kernel``:

* **A** ``ragged_paged_attention`` ← ``ragged_paged_attention_pallas`` (:1058,
  ``fuse_write=False``): one block per (query tile, sequence, kv head) stages
  one page of the head's K and V in shared memory and reuses it for every
  query of the tile and all G query heads of the group; f32 online softmax;
  writes the token-major ``[T, Hq, D]`` output directly (the TPU kernel's
  entry-major windows and their reassembly have no counterpart).
* **B** ``fused_decode_attention`` ← ``ragged_paged_attention_fused`` (:1093,
  ``fuse_write=True``): one block per (sequence, kv head) for a pure-decode
  batch; it writes its head's slice of the new K/V row into the slot, then
  attends with position ``seq_len−1`` taken from ``k_new``/``v_new``; its 4
  warps split the keys and merge their softmax states at the end, and each
  warp keeps 8 V-row loads in flight in its P·V loop.

Both are bound by the K/V bytes they must read (at 3.35 TB/s), far below the
card's flops-per-byte balance point; the designs spend their effort on
reading each page once per (tile, kv head). Sources and notes:
``csrc/paged_attention.cu``.

Dispatch: CUDA tensors launch the kernels (or raise); the plain versions
below are what CPU tensors take, and what the kernels are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .cuda_lib import FLOAT, INT, LONG, PTR
from .kv_cache import kv_cache_view
from .kv_write import write_kv_cache_plain
from .reference import ragged_paged_attention_plain

_SOURCE = "paged_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_BLOCK_SIZES = (8, 16, 32)
_GROUPS = (1, 2, 4, 8)

RAGGED_ATTENTION = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="ragged_paged_attention",
        source=_SOURCE,
        symbol="atoma_ragged_paged_attention",
        argtypes=[INT] + [PTR] * 8 + [INT] * 7 + [FLOAT, INT, FLOAT, PTR],
        replaces=(
            "atoma_infer_tpu/ops/paged_attention.py:1058 "
            "(ragged_paged_attention_pallas -> _kernel :139, fuse_write=False)"
        ),
    )
)
FUSED_DECODE = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="fused_decode_attention",
        source=_SOURCE,
        symbol="atoma_fused_decode_attention",
        argtypes=[INT] + [PTR] * 11 + [INT] * 6 + [LONG, FLOAT, INT, FLOAT, PTR],
        replaces=(
            "atoma_infer_tpu/ops/paged_attention.py:1093 "
            "(ragged_paged_attention_fused -> _kernel :139, fuse_write=True)"
        ),
    )
)


# ------------------------------------------------------------ plain versions
def ragged_paged_attention_paged_plain(
    q, kv_cache, meta, *, scale, sliding_window=None, soft_cap=None,
    alibi_slopes=None,
) -> torch.Tensor:
    """Plain version of kernel A over the page-major cache."""
    D = q.shape[2]
    k_view, v_view = kv_cache_view(kv_cache, kv_cache.shape[2] // (2 * D), D)
    return ragged_paged_attention_plain(
        q, k_view, v_view, meta.block_tables, meta.seq_lens,
        meta.query_start_loc, scale=scale, block_size=meta.block_size,
        sliding_window=sliding_window, soft_cap=soft_cap,
        alibi_slopes=alibi_slopes,
    )


def fused_decode_attention_plain(
    q, kv_cache, k_new, v_new, meta, *, scale, sliding_window=None,
    soft_cap=None, alibi_slopes=None,
) -> torch.Tensor:
    """Plain version of kernel B: the KV write, then attention (in place)."""
    write_kv_cache_plain(kv_cache, k_new, v_new, meta.slot_mapping)
    return ragged_paged_attention_paged_plain(
        q, kv_cache, meta, scale=scale, sliding_window=sliding_window,
        soft_cap=soft_cap, alibi_slopes=alibi_slopes,
    )


# ------------------------------------------------------------------ wrappers
def _check(q, kv_cache, meta, alibi_slopes, extra=()) -> tuple:
    """Validate what both kernels take; return (Hk, D, S, P)."""
    T, Hq, D = q.shape
    num_pages, bs, row = kv_cache.shape
    if q.dtype not in _DTYPES or kv_cache.dtype != q.dtype:
        raise ValueError(
            f"paged attention: q {q.dtype} / cache {kv_cache.dtype} must both "
            "be bfloat16 or float32"
        )
    if D not in _HEAD_DIMS or row % (2 * D) or Hq % (row // (2 * D)):
        raise ValueError(
            f"paged attention: unsupported head_dim {D} / cache row {row} / "
            f"{Hq} q heads"
        )
    if bs != meta.block_size:
        raise ValueError("paged attention: cache block size != meta.block_size")
    S, P = meta.block_tables.shape
    ints = (meta.block_tables, meta.seq_lens, meta.query_start_loc, meta.num_seqs)
    if any(t.dtype != torch.int32 for t in ints + (meta.slot_mapping,)):
        raise ValueError("paged attention: metadata must be int32")
    if meta.seq_lens.shape != (S,) or meta.query_start_loc.shape != (S + 1,):
        raise ValueError("paged attention: seq_lens [S] / query_start_loc [S+1]")
    if meta.num_seqs.numel() != 1:
        raise ValueError("paged attention: num_seqs must hold one value")
    tensors = (q, kv_cache) + ints + tuple(extra)
    if alibi_slopes is not None:
        if alibi_slopes.dtype != torch.float32 or alibi_slopes.shape != (Hq,):
            raise ValueError("paged attention: alibi_slopes must be f32 [Hq]")
        tensors += (alibi_slopes,)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged attention: every tensor must be on q's CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, kv_cache) + tuple(extra)):
        raise ValueError("paged attention: q/cache/k/v must be 16-byte aligned")
    return row // (2 * D), D, S, P


def _window(sliding_window: Optional[int]) -> int:
    return 0 if sliding_window is None else int(sliding_window)


def _cap(soft_cap: Optional[float]) -> float:
    return 0.0 if soft_cap is None else float(soft_cap)


def ragged_paged_attention_cuda(
    q: torch.Tensor,         # [T, Hq, D]
    kv_cache: torch.Tensor,  # [num_pages, bs, 2·Hk·D], holds this step's K/V
    meta,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel A → [T, Hq, D]. Rows past ``query_start_loc[num_seqs]`` are
    padding and left unwritten."""
    Hk, D, S, P = _check(q, kv_cache, meta, alibi_slopes)
    if meta.block_size not in _BLOCK_SIZES:
        raise ValueError(f"ragged_paged_attention: block_size {meta.block_size} unsupported")
    out = torch.empty_like(q)
    RAGGED_ATTENTION(
        _DTYPES[q.dtype],
        q.data_ptr(), kv_cache.data_ptr(), meta.block_tables.data_ptr(),
        meta.seq_lens.data_ptr(), meta.query_start_loc.data_ptr(),
        meta.num_seqs.data_ptr(),
        None if alibi_slopes is None else alibi_slopes.data_ptr(),
        out.data_ptr(),
        S, q.shape[1], Hk, D, P, meta.block_size, int(meta.max_q_len),
        float(scale), _window(sliding_window), _cap(soft_cap),
        cuda_lib.current_stream_handle(q.device),
    )
    return out


def ragged_paged_attention_fused_cuda(
    q: torch.Tensor,         # [T, Hq, D]
    kv_cache: torch.Tensor,  # WITHOUT this step's K/V; written in place
    k_new: torch.Tensor,     # [T, Hk, D]
    v_new: torch.Tensor,
    meta,
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    soft_cap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B (pure-decode batch: one query token per active sequence) →
    [T, Hq, D]; the new K/V rows land in the cache as ``reshape_and_cache``
    would write them."""
    Hk, D, S, P = _check(q, kv_cache, meta, alibi_slopes, extra=(k_new, v_new))
    T, Hq, _ = q.shape
    if not meta.decode_only:
        raise ValueError("fused_decode_attention: meta.decode_only must be set")
    if Hq // Hk not in _GROUPS:
        raise ValueError(f"fused_decode_attention: {Hq // Hk} q heads per kv head unsupported")
    if k_new.shape != (T, Hk, D) or v_new.shape != (T, Hk, D):
        raise ValueError("fused_decode_attention: k_new/v_new must be [T, Hk, D]")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("fused_decode_attention: k_new/v_new must have q's dtype")
    if meta.slot_mapping.shape != (T,) or not meta.slot_mapping.is_cuda:
        raise ValueError("fused_decode_attention: slot_mapping must be int32 [T] on the device")
    num_pages, bs, _ = kv_cache.shape
    out = torch.empty_like(q)
    FUSED_DECODE(
        _DTYPES[q.dtype],
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kv_cache.data_ptr(),
        meta.slot_mapping.data_ptr(), meta.block_tables.data_ptr(),
        meta.seq_lens.data_ptr(), meta.query_start_loc.data_ptr(),
        meta.num_seqs.data_ptr(),
        None if alibi_slopes is None else alibi_slopes.data_ptr(),
        out.data_ptr(),
        S, Hq, Hk, D, P, bs, num_pages * bs,
        float(scale), _window(sliding_window), _cap(soft_cap),
        cuda_lib.current_stream_handle(q.device),
    )
    return out
