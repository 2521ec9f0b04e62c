"""Plans of the tensor-core ragged attention kernel (kernels A, D and E for
bf16 queries, ``csrc/paged_attention_mma.cuh``), side by side on the card.

Run on a machine with an NVIDIA H100:
``python -m atoma_infer_tpu_torch.tools.rpa_ablation``. It builds the three
attention sources, checks the kernel against its plain version at small
shapes (head dims 32/64/128, GQA groups 1/3/4/8, blocks of 8/16/48/128,
bf16/INT8/e4m3 caches, one split and several) within 2e-2, then times, at
the Llama-3.1-8B attention shapes (Hq = 32, Hk = 8, D = 128, blocks of 16),
the mixed batch of ``chip_smoke.py`` phase 2 and a 256-query prefill chunk
at positions 1,792-2,047, each cache kind, under every plan of 4 or 8 warps
× 1, 2, 4 or 8 splits beside the plan the route picks and the CUDA-core
``rpa_kernel`` by a direct call, then the mixed batch's decode and prefill
rows apart, and one query tile over 1 and over 32 key tiles (a block's
latency a key tile): CUDA graphs of 20 launches, mean of 3 replays. One
JSON line per batch and cache kind.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch

from ..ops import cuda_lib, paged_attention as pa
from ..ops.attention import AttentionMetadata
from ..ops.kv_cache import FP8_MAX, kv_quant_scales, quantize_kv_rows

SOURCES = ("paged_attention.cu", "paged_attention_int8.cu", "paged_attention_fp8.cu")
TOL = 2e-2
KINDS = (None, torch.int8, torch.float8_e4m3fn)


def make_batch(rng, specs, *, hq, hk, d, bs, kind, device):
    """A ragged batch of (q_len, kv_len) sequences on random disjoint pages:
    bf16 queries over a cache of ``kind`` (INT8 with its scales)."""
    S, T = len(specs), -(-sum(q for q, _ in specs) // 8) * 8
    P = max(-(-kv // bs) for _, kv in specs)
    num_blocks = sum(-(-kv // bs) for _, kv in specs) + 4
    perm = rng.permutation(num_blocks)
    tables = np.zeros((S, P), np.int32)
    qsl = np.zeros(S + 1, np.int32)
    used = 0
    for s, (q_len, kv) in enumerate(specs):
        n = -(-kv // bs)
        tables[s, :n] = perm[used:used + n]
        # Past a sequence's pages the table holds garbage, as in the engine.
        tables[s, n:] = rng.integers(0, 1 << 20, size=P - n)
        used += n
        qsl[s + 1] = qsl[s] + q_len
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    cache = torch.randn((num_blocks, bs, 2 * hk * d), generator=gen, device=device)
    scales = None
    if kind == torch.int8:
        flat = cache.view(num_blocks * bs, hk, 2, d)
        sc = kv_quant_scales(flat[:, :, 0], flat[:, :, 1])
        cache = quantize_kv_rows(flat[:, :, 0], flat[:, :, 1], sc).view(num_blocks, bs, -1)
        scales = sc.to(torch.bfloat16).view(num_blocks, bs, 2)
    elif kind == torch.float8_e4m3fn:
        cache = cache.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    else:
        cache = cache.to(torch.bfloat16)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    meta = AttentionMetadata(
        slot_mapping=ints(np.full(T, -1)), block_tables=ints(tables),
        seq_lens=ints([kv for _, kv in specs]), query_start_loc=ints(qsl),
        num_seqs=ints([S]), block_size=bs, decode_only=False,
        max_q_len=max(q for q, _ in specs),
    )
    q = torch.randn((T, hq, d), generator=gen, device=device).to(torch.bfloat16)
    return dict(q=q, cache=cache, scales=scales, meta=meta, rows=int(qsl[S]), kind=kind)


def run_plan(b, plan, **kw):
    """The tensor-core kernel with a given plan."""
    q, m = b["q"], b["meta"]
    out = torch.empty_like(q)
    return pa.ragged_paged_attention_mma_launch(
        q, b["cache"], m, plan, out, kind=b["kind"], scale=q.shape[2] ** -0.5,
        kv_scales=b["scales"], **kw)


def run_cuda_cores(b, **kw):
    """The CUDA-core ``rpa_kernel`` on bf16 queries, by a direct launch."""
    q, m, cache, scales = b["q"], b["meta"], b["cache"], b["scales"]
    T, Hq, D = q.shape
    S, P = m.block_tables.shape
    out = torch.empty_like(q)
    window, cap, alibi = kw.get("sliding_window"), kw.get("soft_cap"), kw.get("alibi_slopes")
    pa.RAGGED_ATTENTION[b["kind"]](
        1, q.data_ptr(), cache.data_ptr(), None if scales is None else scales.data_ptr(),
        m.block_tables.data_ptr(), m.seq_lens.data_ptr(), m.query_start_loc.data_ptr(),
        m.num_seqs.data_ptr(), None if alibi is None else alibi.data_ptr(), out.data_ptr(),
        S, Hq, cache.shape[2] // (2 * D), D, P, m.block_size, int(m.max_q_len),
        float(D ** -0.5), 0 if window is None else int(window), 0.0 if cap is None else cap,
        cuda_lib.current_stream_handle(q.device))
    return out


def plain(b, **kw):
    return pa.ragged_paged_attention_paged_plain(
        b["q"], b["cache"], b["meta"], scale=b["q"].shape[2] ** -0.5, kv_scales=b["scales"], **kw)


def graph_ms(fn, iters=20):
    """Mean device ms of ``fn``, ``iters`` calls captured in a CUDA graph and
    replayed (the host's launch cost is not in the number)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def check_small(device):
    """The kernel against its plain version at small shapes, each under one
    split and under several; returns the worst |err|."""
    rng = np.random.default_rng(5)
    specs = [(20, 45), (1, 30), (7, 7), (1, 1), (33, 70), (1, 1500), (40, 700)]
    worst = 0.0
    for kind in KINDS:
        for d in (32, 64, 128):
            for group in (1, 3, 4, 8):
                for bs in (8, 16, 48, 128):
                    b = make_batch(rng, specs, hq=2 * group, hk=2, d=d, bs=bs, kind=kind,
                                   device=device)
                    ref = plain(b)[:b["rows"]].float()
                    for warps in (4, 8):
                        for splits in (1, 3):
                            plan = pa.RpaPlan(warps, warps * 16 // group, splits)
                            got = run_plan(b, plan)[:b["rows"]].float()
                            err = (got - ref).abs().max().item()
                            worst = max(worst, err)
                            if not torch.allclose(got, ref, atol=TOL, rtol=TOL):
                                raise AssertionError(
                                    f"{pa.RAGGED_ATTENTION_MMA[kind].name} D={d} G={group} "
                                    f"bs={bs} {plan}: max |err| {err:.3e}")
    return worst


def timed_rows(device):
    """Each batch and cache kind: every plan, the route's plan and the
    CUDA-core kernel, in CUDA graphs. The batches: phase 2's mixed batch,
    its 29 decode rows alone and its 3 prefill rows alone, the 256-query
    chunk, and one query tile walking 1 and 32 key tiles (one row, G = 4,
    and 32 tokens: a block's latency a key tile, empty and full)."""
    rng = np.random.default_rng(0)
    mixed = [(300, 300), (128, 700), (57, 57)] + [
        (1, int(k)) for k in rng.integers(16, 2048, size=29)]
    batches = {
        "mixed": mixed, "mixed decode rows": mixed[3:], "mixed prefill rows": mixed[:3],
        "prefill chunk": [(256, 2048)],
        "1 row, 1 key tile": [(1, 64)], "1 row, 32 key tiles": [(1, 2048)],
        "32 tokens, 1 key tile": [(32, 64)], "32 tokens, 32 key tiles": [(32, 2048)],
    }
    shapes = dict(hq=32, hk=8, d=128, bs=16, device=device)
    for label, specs in batches.items():
        for kind in KINDS:
            b = make_batch(rng, specs, kind=kind, **shapes)
            kernel = pa.RAGGED_ATTENTION_MMA[kind]
            ref = plain(b)[:b["rows"]].float()
            row = dict(batch=label, kernel=kernel.name)
            for warps in (4, 8):
                for splits in (1, 2, 4, 8):
                    plan = pa.RpaPlan(warps, warps * 16 // 4, splits)
                    err = (run_plan(b, plan)[:b["rows"]].float() - ref).abs().max().item()
                    if err > TOL * (1 + ref.abs().max().item()):
                        raise AssertionError(f"{kernel.name} {label} {plan}: max |err| {err:.3e}")
                    row[f"w{warps}s{splits}"] = graph_ms(lambda: run_plan(b, plan))
            m, D = b["meta"], b["q"].shape[2]
            route = pa.rpa_plan_for(b["q"], m, 8, kind)
            row["route_plan"] = [route.warps, route.splits]
            row["route_ms"] = graph_ms(lambda: pa.ragged_paged_attention_cuda(
                b["q"], b["cache"], m, scale=D ** -0.5, kv_scales=b["scales"]))
            row["cuda_cores_ms"] = graph_ms(lambda: run_cuda_cores(b))
            row["occupancy"] = {w: pa._rpa_slots(kind, D, w, 0) for w in (4, 8)}
            print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rpa_ablation needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for source, log in cuda_lib.build_all(SOURCES).items():
        for kernel, spill, regs in re.findall(
                r"Compiling entry function '(\w*rpa_\w*)'.*?(\d+) bytes spill stores.*?"
                r"Used (\d+) registers", log, re.S):
            print(f"{source}: {kernel[:60]} {regs} registers, {spill} bytes spilled")
    device = torch.device("cuda")
    print(f"small shapes agree, max |err| {check_small(device):.3e} (tol {TOL})", flush=True)
    timed_rows(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
