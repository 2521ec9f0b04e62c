"""Ragged paged attention: the CUDA kernels and their plain versions.

Replaces the TPU kernel ``atoma_infer_tpu/ops/paged_attention.py:_kernel``:

* **A** ``ragged_paged_attention`` ← ``ragged_paged_attention_pallas`` (:1058,
  ``fuse_write=False``): one block per (query tile, sequence, kv head) stages
  the head's K and V in shared memory, gcd(block_size, 32) slots of a page at
  a time (so any block size that is a multiple of 8 runs), and reuses them
  for every query of the tile and all G query heads of the group; f32 online
  softmax;
  writes the token-major ``[T, Hq, D]`` output directly (the TPU kernel's
  entry-major windows and their reassembly have no counterpart).
* **B** ``fused_decode_attention`` ← ``ragged_paged_attention_fused`` (:1093,
  ``fuse_write=True``): one block per (sequence, kv head) for a pure-decode
  batch; it writes its head's slice of the new K/V row into the slot, then
  attends over the cache, the new position read back from it; its 4 warps
  split the keys and merge their softmax states at the end, and each warp
  keeps 8 V-row loads in flight in its P·V loop. It is instantiated for 1
  to 8 query heads per kv head.
* **D** ``*_int8``: A and B over an INT8 cache with one bf16 scale per
  (slot, K/V) (``quant=True``: ``ragged_paged_attention_pallas(kv_scales=…)``
  and ``ragged_paged_attention_fused_quant`` :1132). The fused kernel
  quantizes the new row itself: every block reads its token's whole K and V
  rows (the scale is an absmax over all kv heads; max is exact in any
  order, so every block gets the same scale) and block 0 stores the pair.
* **E** ``*_fp8``: A and B over an e4m3 cache (``fp8=True``, ``_e4m3_decode``
  :66-85), widened by the card's own e4m3 conversion.

All are bound by the K/V bytes they must read (at 3.35 TB/s), far below the
card's flops-per-byte balance point; the designs spend their effort on
reading each page once per (tile, kv head), and a 1-byte cache halves the
bytes. Sources and notes: ``csrc/paged_attention.cuh``, instantiated by
``paged_attention{,_int8,_fp8}.cu``.

Dispatch: CUDA tensors launch the kernels of their cache's dtype (or raise:
an int8 or e4m3 cache never takes a bf16 kernel or a plain version); the
plain versions below are what CPU tensors take, and what the kernels are
held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .cuda_lib import FLOAT, INT, LONG, PTR
from .kv_cache import kv_cache_view, scales_flat
from .kv_write import write_kv_cache_plain, write_kv_cache_quant_plain
from .reference import ragged_paged_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
MAX_FUSED_GROUP = 8  # fused_decode_kernel is instantiated for G = 1..8
_RAGGED_ARGS = [INT] + [PTR] * 9 + [INT] * 7 + [FLOAT, INT, FLOAT, PTR]
_FUSED_ARGS = [INT] + [PTR] * 12 + [INT] * 6 + [LONG, FLOAT, INT, FLOAT, PTR]
_A = "atoma_infer_tpu/ops/paged_attention.py:1058 (ragged_paged_attention_pallas"
_B = "atoma_infer_tpu/ops/paged_attention.py:1093 (ragged_paged_attention_fused"


def _register(name, source, symbol, argtypes, replaces):
    return cuda_lib.register(cuda_lib.CudaKernel(
        name=name, source=source, symbol=symbol, argtypes=argtypes, replaces=replaces,
    ))


# Kernels by cache kind: None = the model's dtype, then int8 and e4m3.
RAGGED_ATTENTION = {
    None: _register(
        "ragged_paged_attention", "paged_attention.cu", "atoma_ragged_paged_attention",
        _RAGGED_ARGS, f"{_A} -> _kernel :139, fuse_write=False)"),
    torch.int8: _register(
        "ragged_paged_attention_int8", "paged_attention_int8.cu",
        "atoma_ragged_paged_attention_int8", _RAGGED_ARGS,
        f"{_A}(kv_scales=...) -> _kernel :139, quant=True; scale_rows :409, "
        "attend_chunk :510-591)"),
    torch.float8_e4m3fn: _register(
        "ragged_paged_attention_fp8", "paged_attention_fp8.cu",
        "atoma_ragged_paged_attention_fp8", _RAGGED_ARGS,
        f"{_A} on e4m3 -> _kernel :139, fp8=True; _e4m3_decode :66-85)"),
}
FUSED_DECODE = {
    None: _register(
        "fused_decode_attention", "paged_attention.cu", "atoma_fused_decode_attention",
        _FUSED_ARGS, f"{_B} -> _kernel :139, fuse_write=True)"),
    torch.int8: _register(
        "fused_decode_attention_int8", "paged_attention_int8.cu",
        "atoma_fused_decode_attention_int8", _FUSED_ARGS,
        "atoma_infer_tpu/ops/paged_attention.py:1132 (ragged_paged_attention_fused_quant "
        "-> _kernel :139, quant=True; attend_chunk_fused :435-508)"),
    torch.float8_e4m3fn: _register(
        "fused_decode_attention_fp8", "paged_attention_fp8.cu",
        "atoma_fused_decode_attention_fp8", _FUSED_ARGS,
        f"{_B} on e4m3 -> _kernel :139, fuse_write=True, fp8=True)"),
}


# ------------------------------------------------------------ plain versions
def ragged_paged_attention_paged_plain(
    q, kv_cache, meta, *, scale, sliding_window=None, soft_cap=None,
    alibi_slopes=None, kv_scales=None,
) -> torch.Tensor:
    """Plain version of kernels A, D and E over the page-major cache (an
    INT8 cache with its ``kv_scales``)."""
    D = q.shape[2]
    k_view, v_view = kv_cache_view(kv_cache, kv_cache.shape[2] // (2 * D), D)
    k_scale, v_scale = scales_flat(kv_scales) if kv_scales is not None else (None, None)
    return ragged_paged_attention_plain(
        q, k_view, v_view, meta.block_tables, meta.seq_lens,
        meta.query_start_loc, scale=scale, block_size=meta.block_size,
        sliding_window=sliding_window, soft_cap=soft_cap,
        alibi_slopes=alibi_slopes, k_scale=k_scale, v_scale=v_scale,
    )


def fused_decode_attention_plain(
    q, kv_cache, k_new, v_new, meta, *, scale, sliding_window=None,
    soft_cap=None, alibi_slopes=None, kv_scales=None,
) -> torch.Tensor:
    """Plain version of kernel B (and of D's and E's fused variants): the
    KV write, then attention (in place)."""
    if kv_scales is not None:
        write_kv_cache_quant_plain(kv_cache, kv_scales, k_new, v_new, meta.slot_mapping)
    else:
        write_kv_cache_plain(kv_cache, k_new, v_new, meta.slot_mapping)
    return ragged_paged_attention_paged_plain(
        q, kv_cache, meta, scale=scale, sliding_window=sliding_window,
        soft_cap=soft_cap, alibi_slopes=alibi_slopes, kv_scales=kv_scales,
    )


# ------------------------------------------------------------------ wrappers
def check_kernel_shape(*, group: int, block_size: int, fused: bool) -> None:
    """Raise ``ValueError`` for a block size or GQA group the kernels do not
    take: the ragged kernel (A, D, E) takes any block size that is a
    multiple of 8, as the configuration does; the fused decode kernel (B and
    D's and E's fused variants) also takes 1 to ``MAX_FUSED_GROUP`` query
    heads per kv head."""
    if block_size <= 0 or block_size % 8:
        raise ValueError(f"paged attention: block_size {block_size} is not a positive "
                         "multiple of 8")
    if fused and not 1 <= group <= MAX_FUSED_GROUP:
        raise ValueError(
            f"fused_decode_attention: {group} q heads per kv head unsupported (1 to "
            f"{MAX_FUSED_GROUP}; larger groups wait for ROADMAP.md, Queue 1: model families)"
        )


def _check(q, kv_cache, meta, alibi_slopes, kv_scales, extra=()) -> tuple:
    """Validate what the kernels take; return (Hk, D, S, P, cache kind)."""
    T, Hq, D = q.shape
    num_pages, bs, row = kv_cache.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged attention: q {q.dtype} must be bfloat16 or float32")
    if kv_cache.dtype == q.dtype:
        kind = None
    elif kv_cache.dtype in (torch.int8, torch.float8_e4m3fn):
        kind = kv_cache.dtype
    else:
        raise ValueError(
            f"paged attention: cache {kv_cache.dtype} must have q's dtype {q.dtype}, "
            "or be int8 (with kv_scales) or float8_e4m3fn"
        )
    if (kind == torch.int8) != (kv_scales is not None):
        raise ValueError("paged attention: kv_scales come with an int8 cache, and only with one")
    if kv_scales is not None:
        if kv_scales.dtype != torch.bfloat16 or kv_scales.shape != (num_pages, bs, 2):
            raise ValueError("paged attention: kv_scales must be bfloat16 [pages, block_size, 2]")
        extra = tuple(extra) + (kv_scales,)
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
        raise ValueError("paged attention: q/cache/k/v/scales must be 16-byte aligned")
    return row // (2 * D), D, S, P, kind


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
    kv_scales: Optional[torch.Tensor] = None,  # [num_pages, bs, 2] bf16 (int8 cache)
) -> torch.Tensor:
    """Kernel A (D on an int8 cache, E on an e4m3 one) → [T, Hq, D]. Rows
    past ``query_start_loc[num_seqs]`` are padding and left unwritten."""
    Hk, D, S, P, kind = _check(q, kv_cache, meta, alibi_slopes, kv_scales)
    check_kernel_shape(group=q.shape[1] // Hk, block_size=meta.block_size, fused=False)
    out = torch.empty_like(q)
    RAGGED_ATTENTION[kind](
        _DTYPES[q.dtype],
        q.data_ptr(), kv_cache.data_ptr(),
        None if kv_scales is None else kv_scales.data_ptr(),
        meta.block_tables.data_ptr(),
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
    kv_scales: Optional[torch.Tensor] = None,  # [num_pages, bs, 2] bf16 (int8 cache)
) -> torch.Tensor:
    """Kernel B (D's fused variant on an int8 cache, E's on an e4m3 one;
    pure-decode batch: one query token per active sequence) → [T, Hq, D];
    the new K/V rows (and an int8 cache's scales) land in the cache as the
    matching ``reshape_and_cache`` kernel would write them."""
    Hk, D, S, P, kind = _check(q, kv_cache, meta, alibi_slopes, kv_scales, extra=(k_new, v_new))
    T, Hq, _ = q.shape
    if not meta.decode_only:
        raise ValueError("fused_decode_attention: meta.decode_only must be set")
    check_kernel_shape(group=Hq // Hk, block_size=meta.block_size, fused=True)
    if k_new.shape != (T, Hk, D) or v_new.shape != (T, Hk, D):
        raise ValueError("fused_decode_attention: k_new/v_new must be [T, Hk, D]")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("fused_decode_attention: k_new/v_new must have q's dtype")
    if meta.slot_mapping.shape != (T,) or not meta.slot_mapping.is_cuda:
        raise ValueError("fused_decode_attention: slot_mapping must be int32 [T] on the device")
    num_pages, bs, _ = kv_cache.shape
    out = torch.empty_like(q)
    FUSED_DECODE[kind](
        _DTYPES[q.dtype],
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kv_cache.data_ptr(),
        None if kv_scales is None else kv_scales.data_ptr(),
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
