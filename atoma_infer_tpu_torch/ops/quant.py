"""Weight-only INT8/INT4 quantization of linear weights.

Counterpart of the weight half of ``atoma_infer_tpu/ops/quant.py``:
symmetric absmax scales per output column and per group of ``group_size``
rows along the contraction axis, ``w ≈ qweight · scales[group, out]``. INT4
packs two values per byte along the contraction axis, group-local halves
with biased nibbles. ``quantize_weight`` gives the same bytes as the JAX
package's for the same f32 input, so quantized checkpoints carry across.

``quantized_matmul`` dispatches by device: a CUDA tensor launches the
hand-written kernels of ``ops/quant_kernels.py`` (F, G, or H under
``ATOMA_W8A8``), a CPU tensor takes their plain versions.

Not ported: the JAX ``layer`` field. XLA copies a sliced int8 array before a
custom call, so JAX keeps stacked weights whole and lets the kernel pick the
layer; here ``qweight[i]`` is a view, so a layer's weights are plain slices
(:meth:`QuantizedTensor.layer`). The KV-cache half (INT8 with scales,
e4m3) is ``ops/kv_cache.py``.
"""

from __future__ import annotations

import dataclasses

import torch

DEFAULT_GROUP_SIZE = 128


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A quantized linear weight: ``w ≈ qweight · scales`` (grouped). Layer-
    stacked weights carry a leading ``L`` axis on both tensors."""

    qweight: torch.Tensor  # int8 [(L,) in (/2 for int4), out]
    scales: torch.Tensor   # bf16 [(L,) in // group_size, out]
    bits: int = 8
    group_size: int = DEFAULT_GROUP_SIZE

    @property
    def in_dim(self) -> int:
        return self.qweight.shape[-2] * (2 if self.bits == 4 else 1)

    @property
    def out_dim(self) -> int:
        return self.qweight.shape[-1]

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer ``i`` of stacked weights, as views."""
        return dataclasses.replace(self, qweight=self.qweight[i], scales=self.scales[i])

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(
            self, qweight=self.qweight.to(device), scales=self.scales.to(device)
        )


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device. On CUDA, PyTorch
    turns a division by a Python scalar into a multiplication by its
    reciprocal, which can differ in the last bit; a divisor on ``x``'s
    device keeps the true division the CPU and the JAX package do."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def quantize_weight(
    w: torch.Tensor, bits: int = 8, group_size: int = DEFAULT_GROUP_SIZE
) -> QuantizedTensor:
    """Quantize ``w: [..., in, out]`` to int8/int4 with grouped absmax
    scales, on ``w``'s device. ``q`` is rounded (half to even) with the f32
    scale; the bf16 scale is what is stored. Leading axes are independent
    weights (the JAX loader ``vmap``s over layers)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, not {bits}")
    *lead, in_dim, out_dim = w.shape
    if in_dim % group_size != 0:
        group_size = in_dim  # degenerate: one group
    n_groups = in_dim // group_size
    wf = w.float().reshape(*lead, n_groups, group_size, out_dim)
    qmax = 127.0 if bits == 8 else 7.0
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # [..., G, 1, out]
    scales = torch.clamp_min(true_divide(absmax, qmax), 1e-8)
    q = torch.clamp(torch.round(wf / scales), -qmax, qmax).to(torch.int8)
    if bits == 4:
        # Group-local halves, biased nibbles (q + 8 in [1, 15]): the first
        # half of each group's rows in the low nibbles, the second in the
        # high nibbles.
        if group_size % 2:
            raise ValueError(f"int4 needs an even group size, not {group_size}")
        qg = q.to(torch.int32) + 8
        lo = qg[..., : group_size // 2, :] & 0xF
        hi = (qg[..., group_size // 2:, :] & 0xF) << 4
        q = (lo | hi).to(torch.uint8).view(torch.int8).reshape(*lead, in_dim // 2, out_dim)
    else:
        q = q.reshape(*lead, in_dim, out_dim)
    return QuantizedTensor(
        qweight=q.contiguous(),
        scales=scales.squeeze(-2).to(torch.bfloat16).contiguous(),
        bits=bits,
        group_size=group_size,
    )


def _unpack_int4(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """Unpack [..., in/2, out] int8 bytes → [..., in, out] int8 in [-7, 7]
    (group-local halves, biased nibbles — see :func:`quantize_weight`)."""
    as_u8 = packed.view(torch.uint8)
    lo = (as_u8 & 0xF).to(torch.int8) - 8
    hi = (as_u8 >> 4).to(torch.int8) - 8
    half = group_size // 2
    *lead, in_half, out_dim = packed.shape
    gs = in_half // half
    lo = lo.reshape(*lead, gs, half, out_dim)
    hi = hi.reshape(*lead, gs, half, out_dim)
    full = torch.cat([lo, hi], dim=-2)  # [..., gs, group, out]
    return full.reshape(*lead, in_half * 2, out_dim)


def effective_group_size(w: QuantizedTensor) -> int:
    """The group size the arrays hold: ``in_dim`` when it does not divide."""
    return w.group_size if w.in_dim % w.group_size == 0 else w.in_dim


def dequantize_weight(w: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize the dense weight (tests, and the library yardstick)."""
    group_size = effective_group_size(w)
    q = _unpack_int4(w.qweight, group_size) if w.bits == 4 else w.qweight
    *lead, in_dim, out_dim = q.shape
    scales = w.scales.float()  # [..., G, out]
    deq = q.float().reshape(*lead, in_dim // group_size, group_size, out_dim) * scales[
        ..., :, None, :
    ]
    return deq.reshape(*lead, in_dim, out_dim).to(dtype)


def quantized_matmul(
    x: torch.Tensor, w: QuantizedTensor, *, allow_w8a8: bool = True
) -> torch.Tensor:
    """``x @ dequant(w)`` in ``x``'s dtype, dequantization fused into the
    contraction. With ``ATOMA_W8A8`` set (``quant_kernels._W8A8``) and
    ``allow_w8a8``, activations are quantized per token to int8 first and
    every group's dot is an exact integer (kernel H); otherwise kernel F
    (int8) or G (int4). CPU tensors take the plain versions."""
    from . import quant_kernels as qk

    if w.qweight.dim() != 2:
        raise ValueError("quantized_matmul takes one layer's weights: use QuantizedTensor.layer")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    group_size = effective_group_size(w)
    if allow_w8a8 and qk._W8A8:
        xq, act_scale = qk.quantize_activations(x2)
        matmul = qk.w8a8_matmul_cuda if x.is_cuda else qk.w8a8_matmul_plain
        out = matmul(
            xq, w.qweight, w.scales, act_scale,
            bits=w.bits, group_size=group_size, out_dtype=x.dtype,
        )
    else:
        matmul = qk.quantized_matmul_cuda if x.is_cuda else qk.quantized_matmul_plain
        out = matmul(x2, w.qweight, w.scales, bits=w.bits, group_size=group_size)
    return out.reshape(*lead, w.out_dim)
