"""Grouped dequantize-matmuls: CUDA kernels F, G and H and their plain versions.

Replace the TPU kernels of ``atoma_infer_tpu/ops/quant_kernels.py``
(``quantized_matmul_pallas``): F is ``_kernel_i8`` (INT8 weights), G is
``_kernel_i4`` (INT4 weights, two per byte), H is the ``ATOMA_W8A8`` branch
(int8 activations against either). All compute
``y[M,N] = Σ_g (x[:, g] @ q[g, :]) · s[g, :]`` with each group's dot
accumulated on its own (f32, or exact int32 for H) and scaled before the
sum over groups. Layout and design notes: ``csrc/quant_matmul.cu``.

F and G have two routes, each a hand-written kernel with its own launch
counter: the tensor cores (``quantized_matmul_int8_mma``,
``quantized_matmul_int4_mma``) for bf16 activations at the shapes
:func:`mma_route_takes` admits, and the CUDA cores
(``quantized_matmul_int8``, ``quantized_matmul_int4``) for the rest.

Dispatch: CUDA tensors launch the kernels (or raise); CPU tensors take the
plain versions, which follow the XLA branch of
``atoma_infer_tpu/ops/quant.py:quantized_matmul`` (f32 operands, one einsum
per group, scales on the f32 partials).

Not ported (TPU workarounds, ROADMAP.md): ``ATOMA_I4_SINGLEDOT`` (one bf16
dot per K block, a v5e throughput trade that changes the numbers) and
``ATOMA_INT8_MATMUL=xla`` (an opt-out to XLA's own fusion).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import torch

from . import cuda_lib
from .cuda_lib import INT, PTR
from .quant import _unpack_int4, true_divide

# W8A8: quantize activations per token to int8 and take exact integer dots
# (kernel H). Adds activation-quantization noise on top of the weights';
# read once at import, as the JAX package does.
_W8A8 = os.environ.get("ATOMA_W8A8", "0") not in ("", "0")

_REPLACES = "atoma_infer_tpu/ops/quant_kernels.py:249 (quantized_matmul_pallas, call :366)"
_FLOAT_ARGS = [PTR] * 5 + [INT] * 9 + [PTR]

QMM_I8 = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="quantized_matmul_int8",
        source="quant_matmul.cu",
        symbol="atoma_qmm_i8",
        argtypes=_FLOAT_ARGS,
        replaces=f"{_REPLACES} -> _kernel_i8 :84",
    )
)
QMM_I4 = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="quantized_matmul_int4",
        source="quant_matmul.cu",
        symbol="atoma_qmm_i4",
        argtypes=_FLOAT_ARGS,
        replaces=f"{_REPLACES} -> _kernel_i4 :112",
    )
)
_MMA_ARGS = [PTR] * 5 + [INT] * 6 + [PTR]
QMM_I8_MMA = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="quantized_matmul_int8_mma",
        source="quant_matmul.cu",
        symbol="atoma_qmm_i8_mma",
        argtypes=_MMA_ARGS,
        replaces=f"{_REPLACES} -> _kernel_i8 :84",
    )
)
QMM_I4_MMA = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="quantized_matmul_int4_mma",
        source="quant_matmul.cu",
        symbol="atoma_qmm_i4_mma",
        argtypes=_MMA_ARGS,
        replaces=f"{_REPLACES} -> _kernel_i4 :112",
    )
)
QMM_W8A8 = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="quantized_matmul_w8a8",
        source="quant_matmul.cu",
        symbol="atoma_qmm_w8a8",
        argtypes=[PTR] * 6 + [INT] * 10 + [PTR],
        replaces=f"{_REPLACES} with ATOMA_W8A8 :35 -> _scaled_dot integer branch :65-76",
    )
)

# Launch geometry, mirrored from csrc/quant_matmul.cu: 8 warps a block,
# 4 activation rows a block.
_WARPS = 8
_BLOCK_ROWS = 4
# Split K across blocks until a grid has this many (two blocks per SM of an
# H100's 132).
_TARGET_BLOCKS = 264
# Below this many (M tile, column slice, group) chains of loads, a warp's
# lanes split each group's rows 4 ways (measured on the H100: the small
# decode shapes gain, the others lose; PERF.md).
_ROW_SPLIT_BELOW = 65536


def plan(M: int, N: int, groups: int, vec: int) -> Tuple[int, int, int, int]:
    """(row slices per warp, group slices per block, groups per K split, K
    splits) for one call. Few chains of loads: 4 row slices and at most 2
    group slices. Otherwise up to 8 group slices share a block's groups.
    Then a grid smaller than ``_TARGET_BLOCKS`` is split over K into whole
    rounds of a group per slice."""
    pow2 = 1 << (groups.bit_length() - 1)
    chains = -(-M // _BLOCK_ROWS) * -(-N // vec) * groups
    rsplit, ks = (4, min(2, pow2)) if chains < _ROW_SPLIT_BELOW else (1, min(8, pow2))
    bn = (_WARPS // ks) * (32 // rsplit) * vec
    blocks = -(-M // _BLOCK_ROWS) * -(-N // bn)
    splits = max(1, min(-(-_TARGET_BLOCKS // blocks), groups // ks))
    gps = ks * -(-groups // (ks * splits))
    return rsplit, ks, gps, -(-groups // gps)


# The tensor-core route's block: 128 columns (csrc/quant_matmul.cu).
_MMA_BLOCK_COLS = 128


def mma_block_rows(M: int) -> int:
    """The activation rows of a tensor-core block, which follow M: the
    smallest of 16, 32, 64 that holds it, else 128."""
    return next((b for b in (16, 32, 64) if M <= b), 128)


def mma_plan(M: int, N: int, groups: int, slots: int) -> Tuple[int, int, int]:
    """(activation rows a block, groups per K split, K splits) of one call
    on the tensor-core route: K is split, in whole groups, into as many
    splits as keep the grid within ``slots``, the blocks of this
    instantiation the card holds at once (:func:`_mma_slots`). One wave,
    with as many weight copies in flight as the card takes."""
    block_rows = mma_block_rows(M)
    blocks = -(-N // _MMA_BLOCK_COLS) * -(-M // block_rows)
    gps = -(-groups // max(1, slots // blocks))
    return block_rows, gps, -(-groups // gps)


@functools.lru_cache(maxsize=None)
def _mma_slots(bits: int, block_rows: int, device: int) -> int:
    """The blocks of one tensor-core instantiation the card holds at once:
    the occupancy calculator's blocks an SM times the card's SMs."""
    fn = cuda_lib.load(QMM_I8_MMA.source).atoma_qmm_mma_blocks_per_sm
    fn.argtypes, fn.restype = [INT, INT], INT
    per_sm = fn(bits, block_rows)
    if per_sm < 1:
        raise RuntimeError(f"quantized_matmul: no occupancy for {bits}-bit, {block_rows} rows")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def mma_route_takes(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, *,
                    bits: int, group_size: int) -> bool:
    """Whether the tensor-core route takes a call: bf16 activations, N a
    multiple of 16, whole k16 steps in a group (``group_size`` a multiple of
    16 for int8 and of 32 for int4, whose packed rows hold half a group's),
    and x, the weight and the scales 16-byte aligned (``cp.async``; a layer
    of stacked weights is a view at an offset)."""
    return (
        x.dtype == torch.bfloat16
        and qweight.shape[-1] % 16 == 0
        and group_size % (16 if bits == 8 else 32) == 0
        and all(t.data_ptr() % 16 == 0 for t in (x, qweight, scales))
    )


@dataclasses.dataclass(frozen=True)
class QmmLaunch:
    """How one F or G call launches: the kernel (route), its geometry
    arguments after the shapes, and the f32 workspace's shape when K is
    split over blocks."""

    kernel: cuda_lib.CudaKernel
    geometry: Tuple[int, ...]
    workspace: Optional[Tuple[int, int, int]]


def qmm_launch(x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, *, bits: int,
               group_size: int) -> QmmLaunch:
    """The route and launch plan of ``x @ dequant(q)`` (shapes already
    checked): the tensor cores where :func:`mma_route_takes` admits the
    call, else the CUDA cores."""
    M, K = x.shape
    N = qweight.shape[1]
    groups = K // group_size
    if mma_route_takes(x, qweight, scales, bits=bits, group_size=group_size):
        slots = _mma_slots(bits, mma_block_rows(M), x.device.index or 0)
        block_rows, gps, splits = mma_plan(M, N, groups, slots)
        return QmmLaunch(QMM_I8_MMA if bits == 8 else QMM_I4_MMA, (block_rows, gps),
                         (splits, M, N) if splits > 1 else None)
    vec, ks, rsplit, gps, splits = _cuda_core_geometry(M, N, groups, qweight)
    return QmmLaunch(QMM_I8 if bits == 8 else QMM_I4,
                     (int(x.dtype == torch.bfloat16), vec, ks, rsplit, gps),
                     (splits, M, N) if splits > 1 else None)


def _check(name, tensors, qweight, scales, *, bits, group_size, M, K) -> int:
    """Validate the weight side against an [M, K] activation, then that
    every tensor lies on one CUDA device (last, so that CPU tensors reach
    every other check); returns N."""
    if bits not in (8, 4):
        raise ValueError(f"{name}: bits must be 8 or 4, not {bits}")
    if qweight.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise ValueError(f"{name}: qweight must be int8 and scales bfloat16")
    if qweight.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"{name}: one layer's 2-D qweight and scales")
    rows, N = qweight.shape
    if group_size <= 0 or K % group_size or rows * (2 if bits == 4 else 1) != K:
        raise ValueError(
            f"{name}: qweight {tuple(qweight.shape)} ({bits}-bit) does not fit K={K} "
            f"in groups of {group_size}"
        )
    if scales.shape != (K // group_size, N):
        raise ValueError(f"{name}: scales {tuple(scales.shape)}, want {(K // group_size, N)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if M == 0:
        raise ValueError(f"{name}: no activation rows")
    device = tensors[0].device
    if not all(t.is_cuda and t.device == device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    return N


def _cuda_core_geometry(M, N, groups, qweight):
    """(vec, ks, rsplit, gps, splits) of a CUDA-core launch (F, G or H)."""
    vec = 8 if N % 8 == 0 and qweight.data_ptr() % 8 == 0 else 1
    rsplit, ks, gps, splits = plan(M, N, groups, vec)
    return vec, ks, rsplit, gps, splits


def _workspace(shape, device):
    """The f32 partials of a call split over K, or None."""
    return torch.empty(shape, dtype=torch.float32, device=device) if shape else None


def quantized_matmul_cuda(
    x: torch.Tensor,        # [M, K] bf16/f32, contiguous
    qweight: torch.Tensor,  # int8 [K, N] | int4-packed [K/2, N]
    scales: torch.Tensor,   # bf16 [K/group_size, N]
    *,
    bits: int,
    group_size: int,
) -> torch.Tensor:
    """Launch kernel F (``bits=8``) or G (``bits=4``); output in x's dtype.

    bf16 activations take the tensor cores where :func:`mma_route_takes`
    admits the shape. f32 activations, and the shapes it does not admit,
    take the CUDA-core kernel (``qmm_float_kernel``): on the tensor cores an
    f32 activation would be rounded to bf16, while the CUDA-core kernel's
    f32 instantiation is the exact f32 function. Both routes are kernels;
    nothing here falls back to the plain version."""
    name = "quantized_matmul"
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be bfloat16 or float32, not {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be an [M, K] matrix")
    if bits == 4 and group_size % 2:
        raise ValueError(f"{name}: int4 needs an even group size, not {group_size}")
    M, K = x.shape
    N = _check(name, (x, qweight, scales), qweight, scales, bits=bits,
               group_size=group_size, M=M, K=K)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    launch = qmm_launch(x, qweight, scales, bits=bits, group_size=group_size)
    ws = _workspace(launch.workspace, x.device)
    launch.kernel(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        M, N, K, group_size, *launch.geometry, cuda_lib.current_stream_handle(x.device),
    )
    return out


def w8a8_matmul_cuda(
    xq: torch.Tensor,         # int8 [M, K], contiguous
    qweight: torch.Tensor,
    scales: torch.Tensor,
    act_scale: torch.Tensor,  # f32 [M, 1] (or [M]) per-token scales
    *,
    bits: int,
    group_size: int,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Launch kernel H: exact int32 group dots, × group scale, × token scale."""
    name = "w8a8_matmul"
    if xq.dtype != torch.int8 or xq.dim() != 2:
        raise ValueError(f"{name}: xq must be an int8 [M, K] matrix")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bfloat16 or float32, not {out_dtype}")
    if group_size % (4 if bits == 8 else 8):
        raise ValueError(
            f"{name}: the integer dots take 4 rows at a time: group size {group_size} "
            f"must be a multiple of {4 if bits == 8 else 8} for {bits}-bit weights"
        )
    M, K = xq.shape
    act = act_scale.reshape(-1)
    if act.dtype != torch.float32 or act.shape != (M,):
        raise ValueError(f"{name}: act_scale must be f32 with one scale per row")
    N = _check(name, (xq, qweight, scales, act), qweight, scales, bits=bits,
               group_size=group_size, M=M, K=K)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    vec, ks, rsplit, gps, splits = _cuda_core_geometry(M, N, K // group_size, qweight)
    ws = _workspace((splits, M, N) if splits > 1 else None, xq.device)
    QMM_W8A8(
        xq.data_ptr(), qweight.data_ptr(), scales.data_ptr(), act.data_ptr(),
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        M, N, K, group_size, bits, int(out_dtype == torch.bfloat16), vec, ks, rsplit, gps,
        cuda_lib.current_stream_handle(xq.device),
    )
    return out


# ------------------------------------------------------------ plain versions
def _grouped_weights(qweight, bits, group_size, dtype):
    q = _unpack_int4(qweight, group_size) if bits == 4 else qweight
    K, N = q.shape
    return q.to(dtype).reshape(K // group_size, group_size, N)


def quantized_matmul_plain(
    x: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor, *, bits: int,
    group_size: int,
) -> torch.Tensor:
    """Plain version of F and G: the XLA branch of the JAX package (f32
    operands, one dot per group, f32 partials × scales, summed over groups),
    cast to x's dtype."""
    qg = _grouped_weights(qweight, bits, group_size, torch.float32)
    xg = x.float().reshape(x.shape[0], qg.shape[0], group_size)
    partial = torch.einsum("mgk,gkn->mgn", xg, qg)
    return (partial * scales.float()).sum(dim=-2).to(x.dtype)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-token int8 quantization of ``x: [M, K]``
    (``quant_kernels.py:294-297``, plain ops as XLA runs them there):
    returns (int8 [M, K], f32 scales [M, 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    act_scale = true_divide(torch.clamp_min(amax, 1e-8), 127.0)
    xq = torch.clamp(torch.round(xf / act_scale), -127.0, 127.0).to(torch.int8)
    return xq, act_scale


def w8a8_matmul_plain(
    xq: torch.Tensor, qweight: torch.Tensor, scales: torch.Tensor,
    act_scale: torch.Tensor, *, bits: int, group_size: int, out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of H: each group's dot in f64 (exact for int8 × int8
    over any group this side of 2^37 rows), rounded to f32 as an int32 is,
    × group scale, summed over groups, × token scale, cast once."""
    qg = _grouped_weights(qweight, bits, group_size, torch.float64)
    xg = xq.to(torch.float64).reshape(xq.shape[0], qg.shape[0], group_size)
    dots = torch.einsum("mgk,gkn->mgn", xg, qg).float()
    out = (dots * scales.float()).sum(dim=-2) * act_scale.reshape(-1, 1).float()
    return out.to(out_dtype)
