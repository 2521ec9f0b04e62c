"""Probe: does int8 x int8 run at about twice the bf16 x int8 rate on the card?

Counterpart of ``tools/w8a8_probe.py``. Times a plain matmul ``[M,K] x [K,N]``
with no scales, at the Llama-3.1-8B gate-projection shape, in two forms:
(a) bf16 x int8, products summed in f32 (the weight-only INT8 kernel's dot),
(b) int8 x int8 with an exact int32 sum (the W8A8 candidate),
both written out as f32, each over R = 16 distinct weights so that no weight
is in L2 when it is read. The matmul is kernel I (``csrc/w8a8_probe.cu``), on
the tensor cores through ``mma.sync``, one block per 128 columns over all of
M fed by a four-stage ``cp.async`` ring; its plain version sits beside it.

Usage:
    python -m atoma_infer_tpu_torch.tools.w8a8_probe                  # the card
    python -m atoma_infer_tpu_torch.tools.w8a8_probe --device cpu     # plain version

Prints the JAX tool's two lines (``bf16 x int8: … us/matmul`` and
``int8 x int8: … us/matmul  exact=…``), then the card's achieved rates, the
bound and the library call's time. ``--device cpu`` runs the plain version
at a small shape, timed on the host's clock.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops.cuda_lib import INT, PTR
from ..utils.device import resolve_device

M, K, N = 184, 4096, 14336
R = 16       # distinct weights a timed round
ITERS = 8    # timed rounds, as the JAX tool's timeit
CPU_SHAPE = (24, 256, 384)

# Published H100 SXM peaks (NVIDIA data sheet), for the bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS = {"mixed": 989e12, "int8": 1979e12}

_REPLACES = "tools/w8a8_probe.py:33 (matmul, call :34) -> kern :20"
_ARGS = [PTR, PTR, PTR, INT, INT, INT, PTR]

PROBE_MIXED = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="probe_matmul_mixed",
        source="w8a8_probe.cu",
        symbol="atoma_probe_mixed",
        argtypes=_ARGS,
        replaces=f"{_REPLACES}, bf16 x int8 with f32 accumulation",
    )
)
PROBE_INT8 = cuda_lib.register(
    cuda_lib.CudaKernel(
        name="probe_matmul_int8",
        source="w8a8_probe.cu",
        symbol="atoma_probe_int8",
        argtypes=_ARGS,
        replaces=f"{_REPLACES}, int8 x int8 with int32 accumulation",
    )
)

# The kernel's tile: K a multiple of 64, N of 128 (any M).
_K_MULTIPLE, _N_MULTIPLE = 64, 128


def _check(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int]:
    if x.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"probe_matmul: x must be bfloat16 or int8, not {x.dtype}")
    if w.dtype != torch.int8:
        raise ValueError(f"probe_matmul: w must be int8, not {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"probe_matmul: want x [M, K] and w [K, N], not {tuple(x.shape)} and {tuple(w.shape)}"
        )
    (m, k), n = x.shape, w.shape[1]
    return m, k, n


def probe_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch kernel I: ``x @ w`` in f32, mixed (x bf16) or int8 (x int8)."""
    m, k, n = _check(x, w)
    if m == 0 or k % _K_MULTIPLE or n % _N_MULTIPLE:
        raise ValueError(
            f"probe_matmul: the kernel takes M >= 1, K % {_K_MULTIPLE} == 0 and "
            f"N % {_N_MULTIPLE} == 0, not M={m}, K={k}, N={n}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("probe_matmul: x and w must be contiguous")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("probe_matmul: x and w must be on one CUDA device")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("probe_matmul: x and w must be 16-byte aligned (cp.async copies)")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    kernel = PROBE_INT8 if x.dtype == torch.int8 else PROBE_MIXED
    dev = cuda_lib.launch_device(x, w, out)
    kernel(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
           cuda_lib.current_stream_handle(dev), device=dev)
    return out


def probe_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel I. Mixed: ``x.float() @ w.float()``. int8: the
    product in f64, exact while every partial sum is below 2^53 (here at
    most K·127·127), then int64, then f32 rounded to nearest: the int32
    accumulator's ``.astype(f32)``."""
    _check(x, w)
    if x.dtype == torch.int8:
        return (x.double() @ w.double()).long().float()
    return x.float() @ w.float()


def probe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel I on CUDA tensors (or raise), its plain version on CPU ones."""
    return probe_matmul_cuda(x, w) if x.is_cuda else probe_matmul_plain(x, w)


def make_inputs(m: int, k: int, n: int, repeats: int, device) -> Dict[str, object]:
    """The JAX tool's inputs (``tools/w8a8_probe.py:56-59``) from
    ``numpy.random.default_rng(0)``: ``repeats`` int8 weights [k, n], a bf16
    x and an int8 x [m, k]."""
    rng = np.random.default_rng(0)
    ws = [torch.from_numpy(rng.integers(-127, 127, (k, n)).astype(np.int8)).to(device)
          for _ in range(repeats)]
    xb = torch.from_numpy(rng.standard_normal((m, k))).to(torch.bfloat16).to(device)
    xq = torch.from_numpy(rng.integers(-127, 127, (m, k)).astype(np.int8)).to(device)
    return dict(ws=ws, xb=xb, xq=xq)


def work(m: int, k: int, n: int, kind: str) -> Tuple[int, int]:
    """(bytes, operations) of one matmul: x, w read once, the f32 output
    written once; 2·m·k·n operations."""
    x_bytes = 1 if kind == "int8" else 2
    return m * k * x_bytes + k * n + m * n * 4, 2 * m * k * n


def bound_us(m: int, k: int, n: int, kind: str) -> Tuple[float, str]:
    """The least time an H100 SXM could take (published peaks), in µs, and
    what sets it: ``"bytes"`` or ``"operations"``."""
    nbytes, ops = work(m, k, n, kind)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e6
    t_ops = ops / PEAK_OPS[kind] * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_per_call_us(fn: Callable[[torch.Tensor], object], ws: Sequence[torch.Tensor],
                     iters: int = ITERS) -> float:
    """Mean µs of ``fn(w)`` over ``iters`` rounds of every weight, after one
    untimed round: CUDA events on the card, the host's clock on the CPU."""
    for w in ws:
        fn(w)
    if ws[0].is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            for w in ws:
                fn(w)
        end.record()
        torch.cuda.synchronize()
        total_ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            for w in ws:
                fn(w)
        total_ms = (time.perf_counter() - t0) * 1e3
    return total_ms * 1e3 / (iters * len(ws))


def library_call(kind: str, ws: Sequence[torch.Tensor]):
    """One PyTorch call for the same product, as a yardstick on the card,
    with its weights converted beforehand: ``torch._int_mm`` (int32 out) on
    column-major int8 weights for int8, ``torch.mm`` on bf16 weights with an
    f32 output for mixed. Returns (the call, its weights)."""
    if kind == "int8":
        return torch._int_mm, [w.t().contiguous().t() for w in ws]
    return (lambda x, w: torch.mm(x, w, out_dtype=torch.float32)), [w.to(torch.bfloat16) for w in ws]


def run_probe(device=None) -> Dict[str, object]:
    """Time both forms of kernel I over ``R`` weights (the plain version, at
    ``CPU_SHAPE``, on the CPU), check the int8 form against integer math on
    the first weight, and return the numbers: per form ``us``, ``bound_us``,
    ``bound_by``, achieved ``tflops`` and ``tbps``, and on the card
    ``plain_us`` and ``library_us``; plus ``exact`` (the JAX tool's check),
    ``bit_exact``, the shape and the device's name."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    m, k, n = (M, K, N) if on_card else CPU_SHAPE
    inputs = make_inputs(m, k, n, R, dev)
    ws = inputs["ws"]
    report: Dict[str, object] = dict(
        shape=[m, k, n], repeats=R,
        device=torch.cuda.get_device_name(dev) if on_card else "cpu",
    )
    for kind, x in (("mixed", inputs["xb"]), ("int8", inputs["xq"])):
        us = time_per_call_us(lambda w, x=x: probe_matmul(x, w), ws)
        nbytes, ops = work(m, k, n, kind)
        b_us, b_by = bound_us(m, k, n, kind)
        row = dict(us=us, bound_us=b_us, bound_by=b_by,
                   tflops=ops / us * 1e-6, tbps=nbytes / us * 1e-6)
        if on_card:
            row["plain_us"] = time_per_call_us(lambda w, x=x: probe_matmul_plain(x, w), ws, 1)
            call, lib_ws = library_call(kind, ws)
            row["library_us"] = time_per_call_us(lambda w, x=x: call(x, w), lib_ws)
            del lib_ws
        report[kind] = row
    # Correctness, as the JAX tool checks it: the int8 form against integer
    # math (the exact plain version) on the first weight.
    got = probe_matmul(inputs["xq"], ws[0])
    ref = probe_matmul_plain(inputs["xq"], ws[0])
    report["exact"] = bool(torch.allclose(got, ref, rtol=1e-6, atol=0.5))
    report["bit_exact"] = bool(torch.equal(got, ref))
    return report


def report_lines(report: Dict[str, object]) -> list:
    """The JAX tool's two lines, then one line a form with its rates."""
    mixed, i8 = report["mixed"], report["int8"]
    lines = [
        f"bf16 x int8: {mixed['us']:.1f} us/matmul",
        f"int8 x int8: {i8['us']:.1f} us/matmul  exact={report['exact']}",
    ]
    m, k, n = report["shape"]
    for label, kind in (("bf16 x int8", "mixed"), ("int8 x int8", "int8")):
        r = report[kind]
        extra = ""
        if "plain_us" in r:
            extra += f", plain {r['plain_us']:.1f} us"
        if "library_us" in r:
            lib = "torch._int_mm" if kind == "int8" else "torch.mm (bf16 weight)"
            extra += f", {lib} {r['library_us']:.1f} us"
        lines.append(
            f"{label} on {report['device']} [{m}x{k}]x[{k}x{n}] over {report['repeats']} "
            f"weights: {r['tflops']:.1f} T(FL)OP/s, {r['tbps']:.3f} TB/s; bound "
            f"{r['bound_us']:.1f} us by {r['bound_by']} (H100 SXM peaks){extra}"
        )
    lines.append(f"int8 x int8 bit-exact against integer math: {report['bit_exact']}")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the plain version "
                             f"at {CPU_SHAPE[0]} x {CPU_SHAPE[1]} x {CPU_SHAPE[2]})")
    args = parser.parse_args(argv)
    report = run_probe(args.device)
    for line in report_lines(report):
        print(line, flush=True)
    return report


if __name__ == "__main__":
    main()
