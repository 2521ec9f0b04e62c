"""Ragged paged attention: the CUDA kernels and their plain versions.

Replaces the TPU kernel ``atoma_infer_tpu/ops/paged_attention.py:_kernel``:

* **A** ``ragged_paged_attention`` ← ``ragged_paged_attention_pallas`` (:1058,
  ``fuse_write=False``), two routes by the queries' dtype:
  - bf16 and fp16 queries: the tensor cores (``*_mma``, ``csrc/paged_attention_mma.cuh``):
    ``mma.sync`` bf16 Q·Kᵀ and P·V with f32 sums, query tiles of 64 or 128
    (token, q head) rows laid end to end over the batch, 64-key tiles
    gathered across pages through a 3-stage ``cp.async`` ring, KV split
    across blocks for long rows (:func:`rpa_mma_plan`, from shapes alone)
    and merged by log-sum-exp;
  - f32 queries: the CUDA cores (``rpa_kernel``, ``csrc/paged_attention.cuh``),
    f32 FMAs on K/V staged gcd(block_size, 32) slots at a time: a bf16
    ``mma`` would round f32 queries;
  writes the token-major ``[T, Hq, D]`` output directly (the TPU kernel's
  entry-major windows and their reassembly have no counterpart).
* **B** ``fused_decode_attention`` ← ``ragged_paged_attention_fused`` (:1093,
  ``fuse_write=True``) for a pure-decode batch: each row writes its head's
  slice of the new K/V row into the slot, then attends over the cache, the
  new position read back from it. Two routes by the queries' dtype, each
  instantiated for 1 to 8 query heads per kv head one by one and for 9 to
  16 in one instantiation that takes the group at run time
  (Mistral-Large-2's 12, Llama-3.1-405B's 16):
  - bf16 and fp16 queries (``*_split``, ``csrc/fused_decode_split.cuh``): blocks of
    (kv head, sequence, KV split), the splits from shapes alone
    (:func:`fused_split_plan`), only the split holding the new key writing
    it; K through a ``cp.async`` ring, Q·Kᵀ and P·V on ``mma.sync``
    (groups of 9 to 16 in both halves of its m16 tile); split rows merged
    by ``paged_attention_split_combine`` (the ragged kernel's log-sum-exp
    merge, its own launch);
  - f32 queries (``fused_decode_kernel``, ``csrc/paged_attention.cuh``): one
    block per (sequence, kv head), its 4 warps splitting the keys.
* **D** ``*_int8``: A and B over an INT8 cache with one bf16 scale per
  (slot, K/V) (``quant=True``: ``ragged_paged_attention_pallas(kv_scales=…)``
  and ``ragged_paged_attention_fused_quant`` :1132). The fused kernel
  quantizes the new row itself: every block reads its token's whole K and V
  rows (the scale is an absmax over all kv heads; max is exact in any
  order, so every block gets the same scale) and block 0 stores the pair.
  Under tensor parallelism the caller passes the scales instead
  (``scales_new`` [T, 2] f32, taken over every rank's kv heads; JAX
  ``ops/paged_attention.py:1143,1157``), and the split kernel and the INT8
  write store those.
* **E** ``*_fp8``: A and B over an e4m3 cache (``fp8=True``, ``_e4m3_decode``
  :66-85), widened by the card's own e4m3 conversion.

What bounds them: a decode row does about 2 flops per cache byte, so the
fused kernels and a decode-heavy ragged batch are bound by the K/V bytes
(at 3.35 TB/s; a 1-byte cache halves them); a prefill chunk reuses each key
for a whole query tile and is bound by the tensor cores' operations, which
the ``*_mma`` kernels run on. Sources and notes: ``csrc/paged_attention.cuh``
and ``csrc/paged_attention_mma.cuh``, instantiated by
``paged_attention{,_int8,_fp8}.cu`` (the CUDA-core fused kernels by
``paged_attention{,_int8,_fp8}_fused.cu``) and
``paged_attention{,_int8,_fp8}_mma.cu``.

Every route takes any head dim from 1 up, as JAX takes the head dim from
the config: each kernel is instantiated at the widths 32, 64, 96, 128, 256
and 512 (``INSTANCE_DIMS``) and runs a head dim on the smallest that holds
it, past 512 on the width 512 (:func:`instance_dim`), the head dim passed at
run time. A head dim below its width takes a padded instantiation of its
own (one a width: the tensor-core ragged kernel at 8 warps, the split fused
kernel at both halves of its tile, the CUDA-core kernels at key tiles of 8
and at the run-time group), its padded columns staged as zeros and never
stored (h2o-danube-1.8b's 80 runs at 96, OpenLLaMA-3B's 100 and
h2o-danube3-4b's 120 at 128); odd head dims there are read and written a half of a pair at a
time (ALiBi models: RoPE takes even ones), an odd head of a 1-byte cache
copied byte by byte. The widths' own head dims run the code they ran before.
The 1-byte caches' tensor-core kernels and the f32 queries' CUDA-core
kernels at the widths 96 and 256 are instantiations of their own
(``*_wide``, in ``paged_attention{,_int8,_fp8}_wide*.cu`` and
``fused_decode_split{_int8,_fp8}_wide*.cu``), so that the sources build in
parallel. The width 512 (head dims past 256) has only its padded
instantiation, of every kernel, in sources of its own
(``paged_attention{,_int8,_fp8}_w512{,_f16}.cu``): on the tensor cores one
kernel for A, D, E and the fused B, D, E (``csrc/paged_attention_w512.cuh``:
one 16-row tile a block, its 4 warps splitting O's columns, Q's fragments
from shared memory, 32-key ring stages; :func:`rpa_mma_plan` with
``split_cols``), on the CUDA cores ``rpa_kernel`` and ``fused_decode_kernel``
at the width 512. Past 512 every width-512 kernel cuts the head's columns
into :func:`column_slices` of 512, a block each (one more grid index): a
block computes each key's whole Q·Kᵀ over the head dim and owns 512 of the
output's columns, whose V it alone reads; the slices compute the same
scores in the same order, so nothing crosses them, at the cost of K read
once a slice (the plans count their blocks). The fused kernels' slices
store their own columns of the new K and V; the new key's K comes from
``k_new``, encoded and decoded as the cache holds it. The ragged kernels
take any group: the tensor-core kernel cuts a token's group past 128 q heads
per kv head (past 16 at the width 512) into slices, a block each
(:func:`rpa_mma_plan`), as the CUDA-core kernel cuts a wide group over
blocks.

Dispatch: CUDA tensors launch the kernels of their cache's dtype and their
queries' route (or raise: an int8 or e4m3 cache never takes a bf16 kernel
or a plain version); the plain versions below are what CPU tensors take,
and what the kernels are held against.

fp16 queries (``dtype = "float16"``) launch the tensor-core kernels'
fp16 instantiations (``*_f16``: the same kernels on ``mma.sync``'s f16
form, ``paged_attention{,_int8,_fp8}_f16.cu`` and
``fused_decode_split{,_int8,_fp8}_f16.cu``). JAX
serves fp16 attention through XLA, not Pallas (``ops/attention.py:100-119``
admits bf16, f32, int8 and e4m3 caches only): the oracle of these kernels
is its XLA branch and ``ops/reference.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from . import cuda_lib
from .cuda_lib import FLOAT, INT, LONG, PTR
from .kv_cache import kv_cache_view, scales_flat
from .kv_write import (
    check_scales_new,
    write_kv_cache_plain,
    write_kv_cache_quant_cuda,
    write_kv_cache_quant_plain,
)
from .reference import ragged_paged_attention_plain

# dtype codes of the CUDA-core kernels (f32 queries; bf16 has a code there
# too, though bf16 queries take the tensor cores).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The queries' dtypes the kernels take, and those of the tensor-core route.
Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
TC_DTYPES = (torch.bfloat16, torch.float16)
# The widths every route's kernels are instantiated at; the wide ones are
# Phi-3-mini's and Gemma-2's head dims, and those of their own sources; the
# width 512 has sources of its own for every kernel (W512). A head dim runs
# at the smallest width that holds it, past 512 at 512 in column slices
# (instance_dim, column_slices). No head dim is too large: a slice's shared
# memory and registers are those of 512, and its grid index counts the
# slices.
INSTANCE_DIMS = (32, 64, 96, 128, 256, 512)
WIDE_HEAD_DIMS = (96, 256)
W512 = 512
MIN_HEAD_DIM = 1
# The fused decode kernels take up to 16 q heads per kv head: one m16 tile
# of Q·Kᵀ a kv head.
MAX_FUSED_GROUP = 16
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
# The CUDA-core fused kernels are built from sources of their own
# (``*_fused.cu``), apart from the ragged ones', so that the two halves of
# the slowest sources build in parallel.
FUSED_DECODE = {
    None: _register(
        "fused_decode_attention", "paged_attention_fused.cu", "atoma_fused_decode_attention",
        _FUSED_ARGS, f"{_B} -> _kernel :139, fuse_write=True)"),
    torch.int8: _register(
        "fused_decode_attention_int8", "paged_attention_int8_fused.cu",
        "atoma_fused_decode_attention_int8", _FUSED_ARGS,
        "atoma_infer_tpu/ops/paged_attention.py:1132 (ragged_paged_attention_fused_quant "
        "-> _kernel :139, quant=True; attend_chunk_fused :435-508)"),
    torch.float8_e4m3fn: _register(
        "fused_decode_attention_fp8", "paged_attention_fp8_fused.cu",
        "atoma_fused_decode_attention_fp8", _FUSED_ARGS,
        f"{_B} on e4m3 -> _kernel :139, fuse_write=True, fp8=True)"),
}

_KIND_SUFFIXES = ((None, ""), (torch.int8, "_int8"), (torch.float8_e4m3fn, "_fp8"))
# The CUDA-core kernels (f32 queries) at WIDE_HEAD_DIMS, by cache kind.
RAGGED_ATTENTION_WIDE = {
    kind: _register(
        f"{RAGGED_ATTENTION[kind].name}_wide", f"paged_attention{suffix}_wide.cu",
        f"{RAGGED_ATTENTION[kind].symbol}_wide", _RAGGED_ARGS, RAGGED_ATTENTION[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}
FUSED_DECODE_WIDE = {
    kind: _register(
        f"{FUSED_DECODE[kind].name}_wide", f"paged_attention{suffix}_wide_fused.cu",
        f"{FUSED_DECODE[kind].symbol}_wide", _FUSED_ARGS, FUSED_DECODE[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}
# The tensor-core ragged kernel, by cache kind: bf16 queries
# (``paged_attention{,_int8,_fp8}_mma.cu``, apart from the CUDA-core
# kernels' sources so that they build in parallel), and their fp16
# instantiations (``*_f16``, each its own source).
_MMA_ARGS = [PTR] * 11 + [INT] * 10 + [FLOAT, INT, FLOAT, PTR]
RAGGED_ATTENTION_MMA = {
    kind: _register(
        f"{RAGGED_ATTENTION[kind].name}_mma", f"paged_attention{suffix}_mma.cu",
        f"atoma_ragged_paged_attention_mma{suffix}", _MMA_ARGS,
        RAGGED_ATTENTION[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}
RAGGED_ATTENTION_MMA_F16 = {
    kind: _register(
        f"{RAGGED_ATTENTION[kind].name}_mma_f16", f"paged_attention{suffix}_f16.cu",
        f"atoma_ragged_paged_attention_mma{suffix}_f16", _MMA_ARGS,
        RAGGED_ATTENTION[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}

# The fused decode kernel for bf16 queries, split across blocks
# (csrc/fused_decode_split.cuh), by cache kind; and for fp16 queries.
_SPLIT_ARGS = [PTR] * 15 + [INT] * 7 + [LONG, INT, INT, FLOAT, INT, FLOAT, PTR]
FUSED_DECODE_SPLIT = {
    kind: _register(
        f"{FUSED_DECODE[kind].name}_split", f"fused_decode_split{suffix}.cu",
        f"atoma_fused_decode_attention_split{suffix}", _SPLIT_ARGS, FUSED_DECODE[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}
FUSED_DECODE_SPLIT_F16 = {
    kind: _register(
        f"{FUSED_DECODE[kind].name}_split_f16", f"fused_decode_split{suffix}_f16.cu",
        f"atoma_fused_decode_attention_split{suffix}_f16", _SPLIT_ARGS,
        FUSED_DECODE[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}
# The 1-byte caches' tensor-core kernels at WIDE_HEAD_DIMS, by cache kind
# and queries' dtype: the same kernels, instantiated in sources of their own
# (``*_wide``) so that they build in parallel with the narrow dims' (the
# 2-byte caches' wide instantiations build fast enough beside the narrow
# ones).
_WIDE_SUFFIXES = _KIND_SUFFIXES[1:]
RAGGED_ATTENTION_MMA_WIDE = {
    kind: _register(
        f"{RAGGED_ATTENTION[kind].name}_mma_wide", f"paged_attention{suffix}_wide.cu",
        f"atoma_ragged_paged_attention_mma{suffix}_wide", _MMA_ARGS,
        RAGGED_ATTENTION[kind].replaces)
    for kind, suffix in _WIDE_SUFFIXES
}
RAGGED_ATTENTION_MMA_WIDE_F16 = {
    kind: _register(
        f"{RAGGED_ATTENTION[kind].name}_mma_wide_f16", f"paged_attention{suffix}_wide_f16.cu",
        f"atoma_ragged_paged_attention_mma{suffix}_wide_f16", _MMA_ARGS,
        RAGGED_ATTENTION[kind].replaces)
    for kind, suffix in _WIDE_SUFFIXES
}
FUSED_DECODE_SPLIT_WIDE = {
    kind: _register(
        f"{FUSED_DECODE[kind].name}_split_wide", f"fused_decode_split{suffix}_wide.cu",
        f"atoma_fused_decode_attention_split{suffix}_wide", _SPLIT_ARGS,
        FUSED_DECODE[kind].replaces)
    for kind, suffix in _WIDE_SUFFIXES
}
FUSED_DECODE_SPLIT_WIDE_F16 = {
    kind: _register(
        f"{FUSED_DECODE[kind].name}_split_wide_f16", f"fused_decode_split{suffix}_wide_f16.cu",
        f"atoma_fused_decode_attention_split{suffix}_wide_f16", _SPLIT_ARGS,
        FUSED_DECODE[kind].replaces)
    for kind, suffix in _WIDE_SUFFIXES
}
# Every kernel at the width 512, by cache kind (and for the tensor cores by
# queries' dtype): one source a (cache kind, queries' dtype), the f32
# queries' CUDA-core kernels in the bf16 queries' source
# (``paged_attention{,_int8,_fp8}_w512.cu``, ``..._w512_f16.cu``). The
# tensor-core ragged and fused entries are one kernel's
# (``csrc/paged_attention_w512.cuh``), with the narrower widths' signatures.
RAGGED_ATTENTION_W512 = {
    kind: _register(
        f"{RAGGED_ATTENTION[kind].name}_w512", f"paged_attention{suffix}_w512.cu",
        f"{RAGGED_ATTENTION[kind].symbol}_w512", _RAGGED_ARGS, RAGGED_ATTENTION[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}
FUSED_DECODE_W512 = {
    kind: _register(
        f"{FUSED_DECODE[kind].name}_w512", f"paged_attention{suffix}_w512.cu",
        f"{FUSED_DECODE[kind].symbol}_w512", _FUSED_ARGS, FUSED_DECODE[kind].replaces)
    for kind, suffix in _KIND_SUFFIXES
}
RAGGED_ATTENTION_MMA_W512, RAGGED_ATTENTION_MMA_W512_F16 = (
    {kind: _register(
        f"{RAGGED_ATTENTION[kind].name}_mma_w512{q}", f"paged_attention{suffix}_w512{q}.cu",
        f"atoma_ragged_paged_attention_mma{suffix}_w512{q}", _MMA_ARGS,
        RAGGED_ATTENTION[kind].replaces)
     for kind, suffix in _KIND_SUFFIXES}
    for q in ("", "_f16"))
FUSED_DECODE_SPLIT_W512, FUSED_DECODE_SPLIT_W512_F16 = (
    {kind: _register(
        f"{FUSED_DECODE[kind].name}_split_w512{q}", f"paged_attention{suffix}_w512{q}.cu",
        f"atoma_fused_decode_attention_split{suffix}_w512{q}", _SPLIT_ARGS,
        FUSED_DECODE[kind].replaces)
     for kind, suffix in _KIND_SUFFIXES}
    for q in ("", "_f16"))
# The tensor-core tables by (queries' dtype, tier): see _tc_kernel.
_RAGGED_TC = {(torch.bfloat16, "narrow"): RAGGED_ATTENTION_MMA,
              (torch.float16, "narrow"): RAGGED_ATTENTION_MMA_F16,
              (torch.bfloat16, "wide"): RAGGED_ATTENTION_MMA_WIDE,
              (torch.float16, "wide"): RAGGED_ATTENTION_MMA_WIDE_F16,
              (torch.bfloat16, "w512"): RAGGED_ATTENTION_MMA_W512,
              (torch.float16, "w512"): RAGGED_ATTENTION_MMA_W512_F16}
_FUSED_TC = {(torch.bfloat16, "narrow"): FUSED_DECODE_SPLIT,
             (torch.float16, "narrow"): FUSED_DECODE_SPLIT_F16,
             (torch.bfloat16, "wide"): FUSED_DECODE_SPLIT_WIDE,
             (torch.float16, "wide"): FUSED_DECODE_SPLIT_WIDE_F16,
             (torch.bfloat16, "w512"): FUSED_DECODE_SPLIT_W512,
             (torch.float16, "w512"): FUSED_DECODE_SPLIT_W512_F16}


def instance_dim(head_dim: int) -> int:
    """The width a head dim runs at: the smallest of ``INSTANCE_DIMS`` that
    holds it, 512 past it (the kernels' ``instance_dim``,
    ``csrc/paged_attention.cuh``). ``head_dim`` is at least 1
    (:func:`check_kernel_shape`)."""
    return next((d for d in INSTANCE_DIMS if d >= head_dim), W512)


def column_slices(head_dim: int) -> int:
    """The column slices a width-512 kernel cuts a head dim into, a block
    each (the kernels' ``column_slices``): ceil(head_dim / 512), one up to
    512."""
    return max(1, -(-head_dim // W512))


def _tier(kind, head_dim) -> str:
    """Which sources hold a cache of ``kind``'s kernels at ``head_dim``:
    ``"w512"`` at the width 512 and past it (every cache kind), ``"wide"``
    for a 1-byte cache at the widths 96 and 256, else ``"narrow"``."""
    width = instance_dim(head_dim)
    if width == W512:
        return "w512"
    return "wide" if kind is not None and width in WIDE_HEAD_DIMS else "narrow"


def _tc_kernel(tables, dtype, kind, head_dim) -> cuda_lib.CudaKernel:
    """The tensor-core kernel of ``tables`` for queries of ``dtype`` (bf16
    or fp16) over a cache of ``kind`` at ``head_dim`` (:func:`_tier`)."""
    return tables[(dtype, _tier(kind, head_dim))][kind]


# The merge of split rows (rpa_combine_kernel), after a split ragged or
# fused launch: the online softmax's merge, across blocks; by the output's
# dtype.
_COMBINE_ARGS = [PTR] * 6 + [INT] * 8 + [PTR]
_COMBINE_REPLACES = ("atoma_infer_tpu/ops/paged_attention.py:139 (_kernel: the online softmax "
                     "over a row's key blocks, merged across the blocks of a KV split)")
SPLIT_COMBINE = _register(
    "paged_attention_split_combine", "paged_attention_mma.cu",
    "atoma_paged_attention_split_combine", _COMBINE_ARGS, _COMBINE_REPLACES)
SPLIT_COMBINE_F16 = _register(
    "paged_attention_split_combine_f16", "paged_attention_f16.cu",
    "atoma_paged_attention_split_combine_f16", _COMBINE_ARGS, _COMBINE_REPLACES)

# The tensor-core kernel's geometry, mirrored from csrc/paged_attention_mma.cuh:
# keys a tile (kRpaKT) and the rows of a warp's m16 tile.
RPA_KEY_TILE = 64
RPA_WARP_ROWS = 16
# A split takes at least this many key tiles, and a call at most this many
# splits (the reference FA2's num_splits_heuristic caps at 128; 16 keeps the
# f32 workspace of a 256-token step small).
RPA_MIN_TILES = 2
RPA_MAX_SPLITS = 16
# The split fused decode kernel's splits take at least this many key tiles
# (512 keys): below that the merge's launch costs more than the split saves
# (a decode step of 8 rows of 50-330 keys on an H100: 1.5-2.5 µs more with
# any split; tools/rpa_ablation.py --mode fused).
FUSED_MIN_TILES = 8


def num_splits_heuristic(blocks: int, slots: int, n_blocks: int, max_splits: int) -> int:
    """The reference FA2's ``num_splits_heuristic`` (SURVEY.md §2.4): no
    split when the grid already fills 80% of ``slots``; else the fewest
    splits whose waves are within 85% of the best efficiency, counting only
    split counts that change the blocks a split takes."""
    if blocks >= 0.8 * slots:
        return 1
    max_splits = min(max_splits, slots, n_blocks)
    eligible = [1] + [n for n in range(2, max_splits + 1)
                      if -(-n_blocks // n) != -(-n_blocks // (n - 1))]

    def efficiency(n):
        waves = blocks * n / slots
        return waves / math.ceil(waves)

    best = max(efficiency(n) for n in eligible)
    return next(n for n in eligible if efficiency(n) >= 0.85 * best)


@dataclasses.dataclass(frozen=True)
class RpaPlan:
    """How one tensor-core ragged call launches: warps a block (4 or 8, 16
    rows each; at the width 512 4 warps over one 16-row tile, each a
    quarter of the columns), query tokens a tile, the most KV splits a row
    takes, and the slices a token's group is cut into (past the tile's rows;
    the kernel's ``rpa_group_slices``), each a block of its own (past 512
    each column slice too, :func:`column_slices`: the kernel's grid is (T /
    tokens + S, Hk · slices, splits · column slices))."""

    warps: int
    tokens: int
    splits: int
    slices: int = 1


# Up to this many sequence slots (the engine's smallest bucket), a step
# with a long chunk is mostly that chunk's tiles.
RPA_FEW_SEQS = 8


def rpa_warps(group: int, max_q_len: int, num_seq_slots: int, padded: bool = False) -> int:
    """Warps a block: 8 (128 rows) when a GQA group needs them (past 64 q
    heads per kv head; past 128 a token's group is cut into slices of at
    most 128 rows), or when a query chunk fills several such tiles in a step
    of few sequences, or at a ``padded`` head dim (one below its width,
    whose instantiation is built at 8 warps only); else 4 (64 rows). With
    many sequences most tiles hold one decode row, which a 128-row tile
    leaves 7 of 8 warps idle over (measured on an H100:
    ``tools/rpa_ablation.py``, PERF.md)."""
    long_chunk = max_q_len * group >= 4 * 8 * RPA_WARP_ROWS
    wide = group > 4 * RPA_WARP_ROWS or (long_chunk and num_seq_slots <= RPA_FEW_SEQS)
    return 8 if wide or padded else 4


def rpa_group_slices(group: int, warps: int) -> int:
    """The slices a token's group is cut into in a tile of ``warps`` warps
    (the kernel's ``rpa_group_slices``): one while the group fits the
    tile's rows, else ceil(group / rows), each of ceil(group / slices) q
    heads."""
    return -(-group // (warps * RPA_WARP_ROWS))


# The width-512 kernel's block: 4 warps sharing one 16-row tile.
W512_WARPS = 4


def rpa_mma_plan(*, num_seq_slots: int, num_tokens: int, max_q_len: int, max_keys: int,
                 group: int, num_kv_heads: int, slots: int, padded: bool = False,
                 split_cols: bool = False, columns: int = 1) -> RpaPlan:
    """The launch plan from what the host knows: S sequence slots, T query
    rows, the longest chunk, the block table's width in keys (P × block
    size), the GQA group and kv heads, and ``slots``, the blocks of this
    instantiation the card holds at once (:func:`_rpa_slots`). Never the
    device's ``seq_lens``. The query tiles that hold a token number about
    max(ceil(T / tokens), min(S, T)): the tokens packed, or one tile a
    sequence (one token a tile past 128 q heads per kv head, its group cut
    into slices); with one block per (tile, kv head, slice, column slice)
    that is the grid FA2's heuristic sizes against the card, with the key
    tiles counted in whole splits of ``RPA_MIN_TILES``. ``padded``: the head
    dim is below its width (:func:`rpa_warps`); ``split_cols``: its width is
    512, whose kernel's 4 warps share one 16-row tile (``W512_WARPS``);
    ``columns``: its column slices past 512 (:func:`column_slices`)."""
    warps = W512_WARPS if split_cols else rpa_warps(group, max_q_len, num_seq_slots, padded)
    row_tiles = 1 if split_cols else warps
    slices = rpa_group_slices(group, row_tiles)
    tokens = row_tiles * RPA_WARP_ROWS // -(-group // slices)
    tiles = max(-(-num_tokens // tokens), min(num_seq_slots, num_tokens))
    key_tiles = -(-max_keys // RPA_KEY_TILE)
    splits = num_splits_heuristic(tiles * num_kv_heads * slices * columns, slots,
                                  -(-key_tiles // RPA_MIN_TILES), RPA_MAX_SPLITS)
    return RpaPlan(warps, tokens, splits, slices)


@functools.lru_cache(maxsize=None)
def _rpa_slots(kind, head_dim: int, warps: int, device: int) -> int:
    """The blocks of one tensor-core instantiation the card holds at once:
    the occupancy calculator's blocks an SM times the card's SMs, for the
    instantiation that runs ``head_dim`` (its width's, or below the width
    its padded one's). The bf16 instantiation's answer serves the fp16 one
    too, the same code on another ``mma`` form with the same shared memory
    (``chip_smoke.py`` checks that the card gives both the same)."""
    kernel = _tc_kernel(_RAGGED_TC, torch.bfloat16, kind, head_dim)
    suffix = kernel.symbol[len("atoma_ragged_paged_attention_mma"):]
    fn = getattr(cuda_lib.load(kernel.source), f"atoma_rpa_mma_blocks_per_sm{suffix}")
    fn.argtypes, fn.restype = [INT, INT], INT
    per_sm = fn(head_dim, warps)
    if per_sm < 1:
        raise RuntimeError(f"ragged_paged_attention: no occupancy for D={head_dim}, "
                           f"{warps} warps")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def rpa_plan_for(q: torch.Tensor, meta, num_kv_heads: int, kind) -> RpaPlan:
    """The plan a bf16 or fp16 call of :func:`ragged_paged_attention_cuda` launches
    with: :func:`rpa_mma_plan` on the call's shapes and this card's
    occupancy."""
    T, Hq, D = q.shape
    S, P = meta.block_tables.shape
    group = Hq // num_kv_heads
    max_q_len = int(meta.max_q_len)
    padded, split_cols = instance_dim(D) != D, instance_dim(D) == W512
    warps = W512_WARPS if split_cols else rpa_warps(group, max_q_len, S, padded)
    return rpa_mma_plan(
        num_seq_slots=S, num_tokens=T, max_q_len=max_q_len, max_keys=P * meta.block_size,
        group=group, num_kv_heads=num_kv_heads, padded=padded, split_cols=split_cols,
        columns=column_slices(D), slots=_rpa_slots(kind, D, warps, q.device.index or 0))


def split_key_ranges(pos: int, window: Optional[int], splits: int, min_tiles: int):
    """The key ranges [lo, hi) the splits of one decode row (its query at
    ``pos``) take, as the kernels cut them (``rpa_tile_keys`` and
    ``rpa_split_count``): whole 64-key tiles from the window's first key to
    ``pos``, at most ``splits`` ranges of at least ``min_tiles`` tiles (the
    split fused kernel's: ``FUSED_MIN_TILES``)."""
    lo = max(0, pos - window + 1) if window else 0
    t_lo = lo // RPA_KEY_TILE
    n_tiles = pos // RPA_KEY_TILE + 1 - t_lo
    nsplit = max(1, min(splits, -(-n_tiles // min_tiles)))
    return [(max(lo, (t_lo + n_tiles * i // nsplit) * RPA_KEY_TILE),
             min(pos + 1, (t_lo + n_tiles * (i + 1) // nsplit) * RPA_KEY_TILE))
            for i in range(nsplit)]


@functools.lru_cache(maxsize=None)
def fused_split_plan(*, num_seq_slots: int, max_keys: int, num_kv_heads: int,
                     slots: int, columns: int = 1) -> int:
    """The most KV splits a decode row of the split fused kernel takes,
    from shapes alone: FA2's heuristic on the grid of (kv head, sequence
    slot, column slice past 512) blocks against ``slots``, the blocks the
    card holds at once (:func:`_fused_slots`), counting the block table's
    width (P × block size) in splits of ``FUSED_MIN_TILES`` key tiles. Never
    ``seq_lens``."""
    key_tiles = -(-max_keys // RPA_KEY_TILE)
    return num_splits_heuristic(num_seq_slots * num_kv_heads * columns, slots,
                                -(-key_tiles // FUSED_MIN_TILES), RPA_MAX_SPLITS)


@functools.lru_cache(maxsize=None)
def _fused_slots(kind, head_dim: int, group: int, device: int) -> int:
    """The blocks of one split fused instantiation the card holds at once
    (the bf16 one's, for fp16 too; at a head dim below its width the padded
    instantiation's: see :func:`_rpa_slots`)."""
    kernel = _tc_kernel(_FUSED_TC, torch.bfloat16, kind, head_dim)
    suffix = kernel.symbol[len("atoma_fused_decode_attention_split"):]
    fn = getattr(cuda_lib.load(kernel.source), f"atoma_fused_split_blocks_per_sm{suffix}")
    fn.argtypes, fn.restype = [INT, INT], INT
    per_sm = fn(head_dim, group)
    if per_sm < 1:
        raise RuntimeError(f"fused_decode_attention: no occupancy for D={head_dim}, G={group}")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def fused_splits_for(q: torch.Tensor, meta, num_kv_heads: int, kind) -> int:
    """The splits a bf16 or fp16 call of :func:`ragged_paged_attention_fused_cuda`
    launches with: :func:`fused_split_plan` on the call's shapes and this
    card's occupancy."""
    T, Hq, D = q.shape
    S, P = meta.block_tables.shape
    return fused_split_plan(
        num_seq_slots=S, max_keys=P * meta.block_size, num_kv_heads=num_kv_heads,
        columns=column_slices(D),
        slots=_fused_slots(kind, D, Hq // num_kv_heads, q.device.index or 0))


def _f32_kernel(tables, kind, head_dim) -> cuda_lib.CudaKernel:
    """The CUDA-core kernel of ``tables`` (narrow, wide, width 512) for f32
    queries over a cache of ``kind`` at ``head_dim``."""
    width = instance_dim(head_dim)
    return tables[2 if width == W512 else 1 if width in WIDE_HEAD_DIMS else 0][kind]


def fused_route(q: torch.Tensor, kind) -> cuda_lib.CudaKernel:
    """The fused decode kernel a CUDA call takes: bf16 queries the split
    kernel (``*_split``) over every cache kind, fp16 queries its fp16
    instantiation (``*_split_f16``), a 1-byte cache at a wide width
    (:func:`instance_dim`) their ``*_wide`` instantiations, every cache at
    the width 512 the ``*_w512`` ones; f32 queries ``fused_decode_kernel``
    (at a wide width its ``*_wide`` instantiation, at 512 its ``*_w512``
    one), the f32 test-size services' traffic."""
    if q.dtype in TC_DTYPES:
        return _tc_kernel(_FUSED_TC, q.dtype, kind, q.shape[2])
    return _f32_kernel((FUSED_DECODE, FUSED_DECODE_WIDE, FUSED_DECODE_W512), kind, q.shape[2])


def ragged_route(q: torch.Tensor, kind) -> cuda_lib.CudaKernel:
    """The ragged kernel a CUDA call takes: bf16 queries the tensor cores
    (``*_mma``) over every cache kind, fp16 queries their fp16
    instantiation (``*_mma_f16``), a 1-byte cache at a wide width
    (:func:`instance_dim`) their ``*_wide`` instantiations, every cache at
    the width 512 the ``*_w512`` ones; f32 queries the CUDA cores
    (``rpa_kernel``, at a wide width its ``*_wide`` instantiation, at 512
    its ``*_w512`` one), whose f32 sums a 16-bit ``mma`` would round."""
    if q.dtype in TC_DTYPES:
        return _tc_kernel(_RAGGED_TC, q.dtype, kind, q.shape[2])
    return _f32_kernel((RAGGED_ATTENTION, RAGGED_ATTENTION_WIDE, RAGGED_ATTENTION_W512), kind,
                       q.shape[2])


def combine_route(out: torch.Tensor) -> cuda_lib.CudaKernel:
    """The merge of split rows for an output of ``out``'s dtype."""
    return SPLIT_COMBINE_F16 if out.dtype == torch.float16 else SPLIT_COMBINE


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
    soft_cap=None, alibi_slopes=None, kv_scales=None, scales_new=None,
) -> torch.Tensor:
    """Plain version of kernel B (and of D's and E's fused variants): the
    KV write (an INT8 cache's scales from ``scales_new`` where given), then
    attention (in place)."""
    if kv_scales is not None:
        write_kv_cache_quant_plain(kv_cache, kv_scales, k_new, v_new, meta.slot_mapping,
                                   scales_new=scales_new)
    else:
        write_kv_cache_plain(kv_cache, k_new, v_new, meta.slot_mapping)
    return ragged_paged_attention_paged_plain(
        q, kv_cache, meta, scale=scale, sliding_window=sliding_window,
        soft_cap=soft_cap, alibi_slopes=alibi_slopes, kv_scales=kv_scales,
    )


def split_combine_plain(ws_o, ws_ml, out, meta, *, bq, splits, min_tiles,
                        window=None) -> torch.Tensor:
    """Plain version of the split merge (``rpa_combine_kernel``): each
    token row whose query tile took several splits becomes the log-sum-exp
    merge of its splits' unnormalized (O, m, l), summed in split order; the
    other rows are left as they are. ``out`` is written in place."""
    qsl = meta.query_start_loc.tolist()
    seq_lens = meta.seq_lens.tolist()
    for s in range(int(meta.num_seqs.reshape(-1)[0])):
        q_start, q_len = qsl[s], qsl[s + 1] - qsl[s]
        for tok0 in range(0, q_len, bq):
            first = seq_lens[s] - q_len + tok0
            last = first + min(bq, q_len - tok0) - 1
            lo = max(0, first - window + 1) if window else 0
            n_tiles = last // RPA_KEY_TILE + 1 - lo // RPA_KEY_TILE
            nsplit = max(1, min(splits, -(-n_tiles // min_tiles)))
            if nsplit == 1:
                continue
            rows = slice(q_start + tok0, q_start + min(q_len, tok0 + bq))
            m, l = ws_ml[:nsplit, rows, :, 0], ws_ml[:nsplit, rows, :, 1]
            w = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - m.amax(0)))
            acc = (w[..., None] * ws_o[:nsplit, rows]).sum(0)
            total = (w * l).sum(0)[..., None]
            out[rows] = torch.where(total > 0, acc / total, torch.zeros_like(acc)).to(out.dtype)
    return out


# ------------------------------------------------------------------ wrappers
def decode_route(num_q_heads: int, num_kv_heads: int) -> str:
    """How a pure-decode step attends on the card, from a rank's heads:
    ``"fused"`` (B, or D's and E's fused variants: write and attend in one
    launch) up to ``MAX_FUSED_GROUP`` q heads per kv head; past it
    ``"ragged"``, the write (C, the INT8 or the e4m3 write) and then the
    ragged kernel (A, D or E, and its merge when the plan splits), as JAX
    serves a decode step its fused kernel does not take
    (``atoma_infer_tpu/ops/attention.py`` ``_fused_supported``)."""
    return "fused" if num_q_heads // num_kv_heads <= MAX_FUSED_GROUP else "ragged"


def _check_head_dim(head_dim: int, dtype: torch.dtype, kind) -> None:
    if head_dim < MIN_HEAD_DIM:
        raise ValueError(
            f"paged attention: unsupported head_dim {head_dim} for {dtype} queries over a "
            f"{kind or dtype} cache (head dims from {MIN_HEAD_DIM})")


def check_kernel_shape(*, head_dim: int, dtype: torch.dtype, kind, group: int,
                       block_size: int, fused: bool) -> None:
    """Raise ``ValueError`` for a shape no kernel takes: ``head_dim`` for
    queries of ``dtype`` (bf16, fp16 or f32) over a cache of ``kind`` (None:
    the queries' own dtype; or int8, float8_e4m3fn) must be at least
    ``MIN_HEAD_DIM``, on every route, with no upper cap (past 512 the
    width-512 kernels take column slices); the ragged kernel (A, D, E)
    takes any block size that is a multiple of 8, as the configuration
    does, and any number of query heads per kv head; the fused decode kernel
    (B and D's and E's fused variants) 1 to ``MAX_FUSED_GROUP``, its
    refusal naming the item. The wrappers and ``LlmService.start`` call
    it."""
    if dtype not in Q_DTYPES:
        raise ValueError(f"paged attention: q {dtype} must be bfloat16, float16 or float32")
    _check_head_dim(head_dim, dtype, kind)
    if block_size <= 0 or block_size % 8:
        raise ValueError(f"paged attention: block_size {block_size} is not a positive "
                         "multiple of 8")
    if group < 1:
        raise ValueError(f"paged attention: {group} q heads per kv head unsupported")
    if fused and group > MAX_FUSED_GROUP:
        raise ValueError(
            f"fused_decode_attention: {group} q heads per kv head unsupported (1 to "
            f"{MAX_FUSED_GROUP}; larger groups wait for ROADMAP.md, Queue 1: fused decode at "
            "more than 16 q heads per kv head, two m16 tiles a kv head)"
        )


def _check(q, kv_cache, meta, alibi_slopes, kv_scales, *, fused, extra=()) -> tuple:
    """Validate what the kernels take (the fused decode kernel's when
    ``fused``); return (Hk, D, S, P, cache kind)."""
    T, Hq, D = q.shape
    num_pages, bs, row = kv_cache.shape
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"paged attention: q {q.dtype} must be bfloat16, float16 or float32")
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
    _check_head_dim(D, q.dtype, kind)  # before the cache row is divided by it
    if row % (2 * D) or Hq % (row // (2 * D)):
        raise ValueError(
            f"paged attention: cache row {row} holds no whole number of kv heads of "
            f"head_dim {D} dividing {Hq} q heads"
        )
    if bs != meta.block_size:
        raise ValueError("paged attention: cache block size != meta.block_size")
    check_kernel_shape(head_dim=D, dtype=q.dtype, kind=kind, group=Hq // (row // (2 * D)),
                       block_size=bs, fused=fused)
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
    """Kernel A (D on an int8 cache, E on an e4m3 one) → [T, Hq, D]: bf16
    and fp16 queries on the tensor cores, f32 on the CUDA cores
    (:func:`ragged_route`).
    Rows past ``query_start_loc[num_seqs]`` are padding and left
    unwritten."""
    Hk, D, S, P, kind = _check(q, kv_cache, meta, alibi_slopes, kv_scales, fused=False)
    out = torch.empty_like(q)
    if q.dtype in TC_DTYPES:
        return ragged_paged_attention_mma_launch(
            q, kv_cache, meta, rpa_plan_for(q, meta, Hk, kind), out, kind=kind, scale=scale,
            sliding_window=sliding_window, soft_cap=soft_cap, alibi_slopes=alibi_slopes,
            kv_scales=kv_scales)
    dev = cuda_lib.launch_device(q, kv_cache, kv_scales, meta.block_tables, meta.seq_lens,
                                 meta.query_start_loc, meta.num_seqs, alibi_slopes, out)
    ragged_route(q, kind)(
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
        cuda_lib.current_stream_handle(dev), device=dev, columns=column_slices(D),
    )
    return out


def split_workspace_shapes(splits: int, num_tokens: int, num_q_heads: int, head_dim: int):
    """The f32 workspace of a launch cut into ``splits`` (> 1): each
    split's unnormalized output, strided by the head dim the kernels write
    (``[splits, T, Hq, head_dim]``, not the instantiation width), and its
    (m, l) pair (``[splits, T, Hq, 2]``)."""
    return (splits, num_tokens, num_q_heads, head_dim), (splits, num_tokens, num_q_heads, 2)


def _split_workspace(splits: int, q: torch.Tensor):
    if splits <= 1:
        return None, None
    o_shape, ml_shape = split_workspace_shapes(splits, *q.shape)
    return (torch.empty(o_shape, dtype=torch.float32, device=q.device),
            torch.empty(ml_shape, dtype=torch.float32, device=q.device))


def ragged_paged_attention_mma_launch(
    q, kv_cache, meta, plan: RpaPlan, out, *, kind, scale, sliding_window=None,
    soft_cap=None, alibi_slopes=None, kv_scales=None,
) -> torch.Tensor:
    """Launch the tensor-core ragged kernel of ``kind`` and of q's dtype
    (bf16 or fp16) with ``plan`` (inputs already checked): the f32 split
    workspace comes from PyTorch's caching
    allocator per call, so the launch needs no host sync and is
    CUDA-graph capturable."""
    T, Hq, D = q.shape
    S, P = meta.block_tables.shape
    Hk = kv_cache.shape[2] // (2 * D)
    ws_o, ws_ml = _split_workspace(plan.splits, q)
    dev = cuda_lib.launch_device(q, kv_cache, kv_scales, meta.block_tables, meta.seq_lens,
                                 meta.query_start_loc, meta.num_seqs, alibi_slopes, out, ws_o,
                                 ws_ml)
    ragged_route(q, kind)(
        q.data_ptr(), kv_cache.data_ptr(),
        None if kv_scales is None else kv_scales.data_ptr(),
        meta.block_tables.data_ptr(), meta.seq_lens.data_ptr(),
        meta.query_start_loc.data_ptr(), meta.num_seqs.data_ptr(),
        None if alibi_slopes is None else alibi_slopes.data_ptr(),
        out.data_ptr(),
        None if ws_o is None else ws_o.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(),
        T, S, Hq, Hk, D, P, meta.block_size, plan.warps, plan.splits, RPA_MIN_TILES,
        float(scale), _window(sliding_window), _cap(soft_cap),
        cuda_lib.current_stream_handle(dev), device=dev, columns=column_slices(D),
    )
    if plan.splits > 1:
        split_combine(ws_o, ws_ml, out, meta, num_kv_heads=Hk, bq=plan.tokens,
                      splits=plan.splits, min_tiles=RPA_MIN_TILES, window=sliding_window)
    return out


def split_combine(ws_o, ws_ml, out, meta, *, num_kv_heads, bq, splits, min_tiles,
                  window=None) -> None:
    """Launch the merge of a split attention launch's rows (inputs, split
    count and minimum split from that launch) into ``out``."""
    T, Hq, D = out.shape
    dev = cuda_lib.launch_device(ws_o, ws_ml, out, meta.seq_lens, meta.query_start_loc,
                                 meta.num_seqs)
    combine_route(out)(
        ws_o.data_ptr(), ws_ml.data_ptr(), out.data_ptr(), meta.seq_lens.data_ptr(),
        meta.query_start_loc.data_ptr(), meta.num_seqs.data_ptr(),
        T, Hq, num_kv_heads, D, bq, splits, min_tiles, _window(window),
        cuda_lib.current_stream_handle(dev), device=dev,
    )


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
    scales_new: Optional[torch.Tensor] = None,  # [T, 2] f32 (int8 cache under TP)
) -> torch.Tensor:
    """Kernel B (D's fused variant on an int8 cache, E's on an e4m3 one;
    pure-decode batch: one query token per active sequence) → [T, Hq, D];
    the new K/V rows (and an int8 cache's scales) land in the cache as the
    matching ``reshape_and_cache`` kernel would write them. bf16 and fp16
    queries take the split kernel (:func:`fused_route`,
    :func:`fused_splits_for`), f32 queries ``fused_decode_kernel``. ``scales_new`` (an int8 cache
    only) gives the new tokens' scales: the split kernel stores them; f32
    queries, whose unsplit kernel takes the rows' own absmax, run the INT8
    write with them and then the ragged kernel (D) instead."""
    extra = (k_new, v_new) if scales_new is None else (k_new, v_new, scales_new)
    Hk, D, S, P, kind = _check(q, kv_cache, meta, alibi_slopes, kv_scales, fused=True,
                               extra=extra)
    T, Hq, _ = q.shape
    check_scales_new(scales_new, T, "fused_decode_attention")
    if scales_new is not None and kind != torch.int8:
        raise ValueError("fused_decode_attention: scales_new come with an int8 cache only")
    if not meta.decode_only:
        raise ValueError("fused_decode_attention: meta.decode_only must be set")
    if k_new.shape != (T, Hk, D) or v_new.shape != (T, Hk, D):
        raise ValueError("fused_decode_attention: k_new/v_new must be [T, Hk, D]")
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("fused_decode_attention: k_new/v_new must have q's dtype")
    if meta.slot_mapping.shape != (T,) or not meta.slot_mapping.is_cuda:
        raise ValueError("fused_decode_attention: slot_mapping must be int32 [T] on the device")
    num_pages, bs, _ = kv_cache.shape
    out = torch.empty_like(q)
    if q.dtype in TC_DTYPES:
        return fused_split_launch(
            q, kv_cache, k_new, v_new, meta, fused_splits_for(q, meta, Hk, kind), out,
            kind=kind, scale=scale, sliding_window=sliding_window, soft_cap=soft_cap,
            alibi_slopes=alibi_slopes, kv_scales=kv_scales, scales_new=scales_new)
    if scales_new is not None:
        write_kv_cache_quant_cuda(kv_cache, kv_scales, k_new, v_new, meta.slot_mapping,
                                  scales_new=scales_new)
        return ragged_paged_attention_cuda(
            q, kv_cache, meta, scale=scale, sliding_window=sliding_window, soft_cap=soft_cap,
            alibi_slopes=alibi_slopes, kv_scales=kv_scales)
    dev = cuda_lib.launch_device(q, k_new, v_new, kv_cache, kv_scales, meta.slot_mapping,
                                 meta.block_tables, meta.seq_lens, meta.query_start_loc,
                                 meta.num_seqs, alibi_slopes, out)
    fused_route(q, kind)(
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
        cuda_lib.current_stream_handle(dev), device=dev, columns=column_slices(D),
    )
    return out


def fused_split_launch(
    q, kv_cache, k_new, v_new, meta, splits: int, out, *, kind, scale, sliding_window=None,
    soft_cap=None, alibi_slopes=None, kv_scales=None, min_tiles: int = FUSED_MIN_TILES,
    scales_new=None,
) -> torch.Tensor:
    """Launch the split fused kernel of ``kind`` and of q's dtype (bf16 or
    fp16) with at most ``splits``
    splits a row of at least ``min_tiles`` key tiles each (inputs already
    checked), then the merge of split rows: the f32 workspace comes from
    PyTorch's caching allocator per call, so the launch needs no host sync
    and is CUDA-graph capturable."""
    T, Hq, D = q.shape
    S, P = meta.block_tables.shape
    num_pages, bs, row = kv_cache.shape
    Hk = row // (2 * D)
    ws_o, ws_ml = _split_workspace(splits, q)
    dev = cuda_lib.launch_device(q, k_new, v_new, kv_cache, kv_scales, scales_new,
                                 meta.slot_mapping, meta.block_tables, meta.seq_lens,
                                 meta.query_start_loc, meta.num_seqs, alibi_slopes, out, ws_o,
                                 ws_ml)
    fused_route(q, kind)(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kv_cache.data_ptr(),
        None if kv_scales is None else kv_scales.data_ptr(),
        None if scales_new is None else scales_new.data_ptr(),
        meta.slot_mapping.data_ptr(), meta.block_tables.data_ptr(),
        meta.seq_lens.data_ptr(), meta.query_start_loc.data_ptr(), meta.num_seqs.data_ptr(),
        None if alibi_slopes is None else alibi_slopes.data_ptr(),
        out.data_ptr(),
        None if ws_o is None else ws_o.data_ptr(),
        None if ws_ml is None else ws_ml.data_ptr(),
        T, S, Hq, Hk, D, P, bs, num_pages * bs, splits, min_tiles,
        float(scale), _window(sliding_window), _cap(soft_cap),
        cuda_lib.current_stream_handle(dev), device=dev, columns=column_slices(D),
    )
    if splits > 1:
        split_combine(ws_o, ws_ml, out, meta, num_kv_heads=Hk, bq=1, splits=splits,
                      min_tiles=min_tiles, window=sliding_window)
    return out
