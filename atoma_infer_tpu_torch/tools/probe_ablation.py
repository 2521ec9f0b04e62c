"""Where kernel I's time goes: the W8A8 probe's matmul with parts of its loop
removed, timed on the card.

Builds ``csrc/w8a8_probe.cu`` once as the port builds it and once for each of
its measurement hooks (see the source's note): a ring of 2 or 3 k tiles
instead of 4, the loop without its ``mma`` (data movement and conversion
only), mixed without its widening, and the ``mma`` alone (no copies, no
fragment loads). Each build is timed at the probe's shape (184 × 4096 ×
14336, over 16 distinct weights, the JAX tool's inputs) and at M = 16 (the
same ``mma`` count, a twelfth of the x traffic), in turns (every variant
forward, then backward), both forms. Only the first build's results are
right; the others are for time only.

Usage (on the card only):
    python -m atoma_infer_tpu_torch.tools.probe_ablation

Prints the card's name and power limit, one line a variant, and a JSON
object of the mean µs by form, variant and M.
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

from ..ops import cuda_lib
from . import w8a8_probe as probe

SOURCE = cuda_lib.CSRC_DIR / "w8a8_probe.cu"
VARIANTS = {
    "port": (),
    "stages2": ("-DATOMA_PROBE_STAGES=2",),
    "stages3": ("-DATOMA_PROBE_STAGES=3",),
    "no_mma": ("-DATOMA_PROBE_NO_MMA",),
    "no_widen": ("-DATOMA_PROBE_NO_WIDEN",),
    "mma_only": ("-DATOMA_PROBE_MMA_ONLY",),
}
ROWS = (probe.M, 16)


def build(name: str) -> ctypes.CDLL:
    """One variant's library under ``csrc/build/``, named by a hash of the
    source, the shared header it includes and the flags."""
    flags = list(cuda_lib.NVCC_FLAGS) + list(VARIANTS[name])
    text = SOURCE.read_bytes() + (cuda_lib.CSRC_DIR / "mma_sm90.cuh").read_bytes()
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:12]
    out = cuda_lib.BUILD_DIR / f"libw8a8_probe_{name}-{digest}.so"
    if not out.exists():
        cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([cuda_lib._nvcc(), *flags, "-o", str(out), str(SOURCE)],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def entry(lib: ctypes.CDLL, kind: str):
    fn = getattr(lib, "atoma_probe_mixed" if kind == "mixed" else "atoma_probe_int8")
    fn.argtypes = [cuda_lib.PTR] * 3 + [cuda_lib.INT] * 3 + [cuda_lib.PTR]
    fn.restype = ctypes.c_int
    return fn


def run(rounds: int = 2) -> Dict[str, Dict[str, Dict[int, float]]]:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_ablation times kernel I on a CUDA device; none is available")
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev = torch.device("cuda")
    m, k, n = probe.M, probe.K, probe.N
    inputs = probe.make_inputs(m, k, n, probe.R, dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    times: Dict[str, Dict[str, Dict[int, list]]] = {}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for kind, x_full in (("mixed", inputs["xb"]), ("int8", inputs["xq"])):
        times[kind] = {v: {rows: [] for rows in ROWS} for v in VARIANTS}
        for _ in range(rounds):
            for name in order:
                fn = entry(libs[name], kind)
                for rows in ROWS:
                    x = x_full[:rows]

                    def call(w, x=x, rows=rows, fn=fn):
                        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, k,
                                 cuda_lib.current_stream_handle(dev))
                        if err:
                            raise RuntimeError(f"kernel I ablation launch failed: error {err}")

                    times[kind][name][rows].append(probe.time_per_call_us(call, inputs["ws"]))
    return {kind: {name: {rows: sum(v) / len(v) for rows, v in by_rows.items()}
                   for name, by_rows in by_name.items()}
            for kind, by_name in times.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, Dict[int, float]]]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rounds", type=int, default=2,
                        help="forward-and-backward passes over the variants (default 2)")
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    result = run(args.rounds)
    for kind, by_name in result.items():
        for name, by_rows in by_name.items():
            cols = ", ".join(f"M={rows}: {us:.2f} us" for rows, us in by_rows.items())
            print(f"{kind:5s} {name:8s} {cols}", flush=True)
    print(json.dumps({"card": card, "us": result}))
    return result


if __name__ == "__main__":
    main()
