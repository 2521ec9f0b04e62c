"""The card's yardstick: published peaks, an attention call's least work,
and the least time the card could take for it.

``chip_smoke.py`` and ``attn_bench`` share these, so that the bounds in the
kernels line and the tool's rows are one yardstick.
"""

from __future__ import annotations

import subprocess
from typing import Iterable, Optional, Tuple

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "int8": 1979e12}


# Llama-3.2-1B attention: (q heads, kv heads, head dim).
LLAMA_1B_HEADS = (32, 8, 64)


def attention_work(specs: Iterable[Tuple[int, int]], window: Optional[int], elt: int, *,
                   fused: bool, hq: int = LLAMA_1B_HEADS[0], hk: int = LLAMA_1B_HEADS[1],
                   d: int = LLAMA_1B_HEADS[2], kv_elt: Optional[int] = None,
                   slot_extra: int = 0) -> Tuple[int, int]:
    """(bytes, flops) the attention needs for these sequences, ``specs``
    their (query tokens, keys) pairs, at Llama-3.2-1B attention unless the
    heads are given: each needed K/V row read once
    (``kv_elt`` bytes an element, default ``elt``, plus ``slot_extra`` bytes
    of scales a slot), q read and out written once (``elt`` bytes an
    element); 4·D flops per (query head, key) pair. ``fused`` adds the new
    rows' read and the cache row's write."""
    row = 2 * hk * d * (kv_elt or elt) + slot_extra
    nbytes = flops = 0
    for q_len, kv in specs:
        first = kv - q_len
        lo = max(0, first - window + 1) if window else 0
        kv_read = kv - lo - (1 if fused else 0)
        nbytes += kv_read * row + 2 * q_len * hq * d * elt
        if fused:
            nbytes += 2 * hk * d * elt + row  # k_new/v_new in, the new row out
        for pos in range(first, kv):
            keys = min(pos + 1, window) if window else pos + 1
            flops += keys * hq * 4 * d
    return nbytes, flops


def bound(nbytes: int, flops: int, dtype_name: str) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the type's peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]
