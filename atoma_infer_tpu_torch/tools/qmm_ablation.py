"""Where F and G's tensor-core time goes: ``qmm_mma_kernel`` with parts of its
loop removed or changed, timed on the card.

Builds ``csrc/quant_matmul.cu`` once as the port builds it and once for each
of its measurement hooks (see the source): a ring of 3 or 4 k tiles for
both forms (the port's: 3 for INT8, 4 for INT4), the loop without its
``mma`` (data movement and widening only), without its widening (raw words
as B), and the ``mma`` alone (no copies, no fragment loads). Each build is
timed on the tensor-core route at the Llama-3.1-8B gate projection (4096 ×
14336, groups of 128) for INT8 (F) and INT4 (G) weights at M = 8 (decode)
and 256 (a prefill chunk), over enough distinct weights that none is in L2,
in CUDA graphs, in turns (every variant forward, then backward). Only the
first build's results are right (checked against the plain version); the
others are for time only. A variant whose ring does not fit in shared
memory is reported as refused.

Usage (on the card only):
    python -m atoma_infer_tpu_torch.tools.qmm_ablation

Prints the card's name and power limit, the resident blocks an SM of each
instantiation, one line a variant, and a JSON object of the mean µs by
form, variant and M.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import subprocess
from typing import Dict, Optional, Sequence

import torch

from ..ops import cuda_lib, quant
from ..ops import quant_kernels as qk

SOURCE = cuda_lib.CSRC_DIR / "quant_matmul.cu"
VARIANTS = {
    "port": (),
    "stages3": ("-DATOMA_QMM_STAGES=3",),
    "stages4": ("-DATOMA_QMM_STAGES=4",),
    "no_mma": ("-DATOMA_QMM_NO_MMA",),
    "no_widen": ("-DATOMA_QMM_NO_WIDEN",),
    "mma_only": ("-DATOMA_QMM_MMA_ONLY",),
}
K, N, GROUP = 4096, 14336, 128
ROWS = (8, 256)


def build(name: str) -> ctypes.CDLL:
    """One variant's library under ``csrc/build/``, named by a hash of the
    source, the shared header and the flags."""
    flags = list(cuda_lib.NVCC_FLAGS) + list(VARIANTS[name])
    text = SOURCE.read_bytes() + (cuda_lib.CSRC_DIR / "mma_sm90.cuh").read_bytes()
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:12]
    out = cuda_lib.BUILD_DIR / f"libquant_matmul_{name}-{digest}.so"
    if not out.exists():
        cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([cuda_lib._nvcc(), *flags, "-o", str(out), str(SOURCE)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def entry(lib: ctypes.CDLL, bits: int):
    fn = getattr(lib, f"atoma_qmm_i{bits}_mma")
    fn.argtypes = qk.QMM_I8_MMA.argtypes
    fn.restype = ctypes.c_int
    return fn


def graph_us(fn, iters: int) -> float:
    """Mean µs of one ``fn()`` call (which launches ``iters`` matmuls),
    captured in a CUDA graph and replayed."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (3 * iters)


def run(rounds: int = 2) -> Dict[str, object]:
    if not torch.cuda.is_available():
        raise RuntimeError("qmm_ablation times kernels F and G on a CUDA device; none is available")
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.02
    occupancy = {}
    for name, lib in libs.items():
        fn = lib.atoma_qmm_mma_blocks_per_sm
        fn.argtypes, fn.restype = [cuda_lib.INT, cuda_lib.INT], ctypes.c_int
        occupancy[name] = {f"int{bits} rows {rows}": fn(bits, rows)
                           for bits in (8, 4) for rows in (16, 32, 64, 128)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    times: Dict[str, Dict[str, Dict[int, list]]] = {}
    for bits in (8, 4):
        qt = quant.quantize_weight(w, bits, GROUP)
        w_bytes = qt.qweight.numel() + qt.scales.numel() * 2
        copies = [qt] + [quant.QuantizedTensor(qt.qweight.clone(), qt.scales.clone(), bits, GROUP)
                         for _ in range(-(-128_000_000 // w_bytes) - 1)]
        kind = f"int{bits}"
        times[kind] = {v: {m: [] for m in ROWS} for v in VARIANTS}
        for m in ROWS:
            x = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
            # The port's plan on this card: one wave of the port build's blocks.
            slots = occupancy["port"][f"int{bits} rows {qk.mma_block_rows(m)}"] * sms
            block_rows, gps, splits = qk.mma_plan(m, N, K // GROUP, slots)
            out = torch.empty((m, N), dtype=torch.bfloat16, device=dev)
            ws = torch.empty((splits, m, N), dtype=torch.float32, device=dev)
            stream = cuda_lib.current_stream_handle(dev)

            def calls(fn, x=x, out=out, ws=ws, block_rows=block_rows, gps=gps):
                for c in copies:
                    err = fn(x.data_ptr(), c.qweight.data_ptr(), c.scales.data_ptr(),
                             out.data_ptr(), ws.data_ptr(), m, N, K, GROUP, block_rows, gps,
                             cuda_lib.current_stream_handle(dev))
                    if err:
                        raise RuntimeError(f"launch failed: error {err}")

            want = qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=bits,
                                             group_size=GROUP).float()
            err = entry(libs["port"], bits)(x.data_ptr(), qt.qweight.data_ptr(),
                                            qt.scales.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                            m, N, K, GROUP, block_rows, gps, stream)
            torch.cuda.synchronize()
            rel = (out.float() - want).abs().max().item() / want.abs().max().item()
            if err or not rel <= 1e-2:
                raise AssertionError(f"the port's build disagrees at {kind} M={m}: {err}, {rel}")
            order = list(VARIANTS) + list(VARIANTS)[::-1]
            for _ in range(rounds):
                for name in order:
                    fn = entry(libs[name], bits)
                    try:
                        us = graph_us(lambda fn=fn: calls(fn), len(copies))
                    except RuntimeError:  # the ring does not fit: refused at launch
                        torch.cuda.synchronize()
                        us = None
                    times[kind][name][m].append(us)
    means = {kind: {name: {m: (None if None in v else sum(v) / len(v)) for m, v in by_m.items()}
                    for name, by_m in by_name.items()}
             for kind, by_name in times.items()}
    return {"blocks_per_sm": occupancy, "us": means}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rounds", type=int, default=2,
                        help="forward-and-backward passes over the variants (default 2)")
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    result = run(args.rounds)
    for name, occ in result["blocks_per_sm"].items():
        print(f"{name:10s} blocks an SM: {occ}", flush=True)
    for kind, by_name in result["us"].items():
        for name, by_m in by_name.items():
            cols = ", ".join(f"M={m}: " + ("refused" if us is None else f"{us:.2f} us")
                             for m, us in by_m.items())
            print(f"{kind} {name:10s} {cols}", flush=True)
    print(json.dumps({"card": card, **result}))
    return result


if __name__ == "__main__":
    main()
