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

``--mode fused`` times the fused decode kernels instead (B, D and E's fused
variants; ``csrc/fused_decode_split.cuh``): after a check against the plain
version (caches and scales bit-exact), the split kernel on phase 2's
64-row decode batch of 16-2,047 keys and on an 8-row batch of 50-330 keys
(the services' decode steps), at the Llama-3.1-8B, Llama-3.2-1B and
Llama-3.2-3B attention shapes, under 1, 2, 3, 4, 6, 8 and 16 splits at most
(of at least 128 keys each) beside the route's plan (splits of at least
``FUSED_MIN_TILES`` key tiles) and the unsplit ``fused_decode_kernel`` by a
direct call, in CUDA graphs of 20 launches. Then the split kernel's measurement
hooks (``csrc/fused_decode_split.cuh``: register caps, the grid's
sequence-major order), each a
small build of the split kernel alone at D = 64 and 128, G = 4, timed on
the 64-row batch at the 8B and 1B shapes beside the same build without
hooks, in turns.

``--mode w512`` times the width 512's tensor-core kernel (A over a bf16
cache, ``csrc/paged_attention_w512.cuh``) at Gemma-2-9B's widths with heads
of 512 (8 q heads over 4 kv heads, soft cap 50, blocks of 16): after a
check against the plain version, ``chip_smoke.py``'s mixed batch at that
shape (decode rows of 16-1,023 keys), its decode and prefill rows apart,
and one 8-token tile (a block's whole query tile at G = 2) and one decode
row over 64 and over 1,024 keys (a block's latency a 64-key tile), each
under 1, 2, 4, 8 and 16 splits beside the route's plan, in CUDA graphs of 20
launches. One JSON line per batch.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch

from ..ops import cuda_lib, paged_attention as pa
from ..ops.cuda_lib import INT as ctypes_int
from ..ops.attention import AttentionMetadata
from ..ops.kv_cache import FP8_MAX, kv_quant_scales, quantize_kv_rows

SOURCES = ("paged_attention.cu", "paged_attention_int8.cu", "paged_attention_fp8.cu",
           "paged_attention_mma.cu", "paged_attention_int8_mma.cu", "paged_attention_fp8_mma.cu")
FUSED_SOURCES = ("fused_decode_split.cu", "fused_decode_split_int8.cu",
                 "fused_decode_split_fp8.cu")
W512_SOURCES = ("paged_attention_w512.cu", "paged_attention_mma.cu")
TOL = 2e-2
KINDS = (None, torch.int8, torch.float8_e4m3fn)


def make_batch(rng, specs, *, hq, hk, d, bs, kind, device, decode=False):
    """A ragged batch of (q_len, kv_len) sequences on random disjoint pages:
    bf16 queries over a cache of ``kind`` (INT8 with its scales). ``decode``:
    one query a sequence, with its new K and V rows and its slot."""
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

    slots = np.full(T, -1)
    if decode:
        T = S
        slots = np.array([tables[s, (kv - 1) // bs] * bs + (kv - 1) % bs
                          for s, (_, kv) in enumerate(specs)])
    meta = AttentionMetadata(
        slot_mapping=ints(slots), block_tables=ints(tables),
        seq_lens=ints([kv for _, kv in specs]), query_start_loc=ints(qsl),
        num_seqs=ints([S]), block_size=bs, decode_only=decode,
        max_q_len=max(q for q, _ in specs),
    )
    q = torch.randn((T, hq, d), generator=gen, device=device).to(torch.bfloat16)
    k, v = (torch.randn((T, hk, d), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    return dict(q=q, k=k, v=v, cache=cache, scales=scales, meta=meta, rows=int(qsl[S]),
                kind=kind)


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
        cuda_lib.current_stream_handle(q.device), device=q.device)
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
            # A head dim below its width has an 8-warp instantiation only.
            warps = (4, 8) if pa.instance_dim(D) == D else (8,)
            row["occupancy"] = {w: pa._rpa_slots(kind, D, w, 0) for w in warps}
            print(json.dumps(row), flush=True)


def run_fused_old(b):
    """The unsplit ``fused_decode_kernel`` on bf16 queries, by a direct launch."""
    q, m, cache, scales = b["q"], b["meta"], b["cache"], b["scales"]
    T, Hq, D = q.shape
    S, P = m.block_tables.shape
    nb, bs, row = cache.shape
    out = torch.empty_like(q)
    pa.FUSED_DECODE[b["kind"]](
        1, q.data_ptr(), b["k"].data_ptr(), b["v"].data_ptr(), cache.data_ptr(),
        None if scales is None else scales.data_ptr(), m.slot_mapping.data_ptr(),
        m.block_tables.data_ptr(), m.seq_lens.data_ptr(), m.query_start_loc.data_ptr(),
        m.num_seqs.data_ptr(), None, out.data_ptr(), S, Hq, row // (2 * D), D, P, bs, nb * bs,
        float(D ** -0.5), 0, 0.0, cuda_lib.current_stream_handle(q.device), device=q.device)
    return out


def run_fused_split(b, splits):
    """The split fused kernel (and the merge) with at most ``splits`` splits
    of at least ``RPA_MIN_TILES`` key tiles (128 keys), the sweep's grain."""
    q = b["q"]
    return pa.fused_split_launch(q, b["cache"], b["k"], b["v"], b["meta"], splits,
                                 torch.empty_like(q), kind=b["kind"], scale=q.shape[2] ** -0.5,
                                 kv_scales=b["scales"], min_tiles=pa.RPA_MIN_TILES)


FS_VARIANTS = {
    "port": (),
    "minb2": ("-DATOMA_FS_MINB=2",),
    "minb3": ("-DATOMA_FS_MINB=3",),
    "minb4": ("-DATOMA_FS_MINB=4",),
    "seq_major": ("-DATOMA_FS_SEQ_MAJOR",),
}
FS_ENTRIES = """#include "fused_decode_split.cuh"
ATOMA_FUSED_SPLIT_ENTRIES(, __nv_bfloat16, __nv_bfloat16, atoma::kNarrowDims)
ATOMA_FUSED_SPLIT_ENTRIES(_int8, __nv_bfloat16, int8_t, atoma::kNarrowDims)
ATOMA_FUSED_SPLIT_ENTRIES(_fp8, __nv_bfloat16, __nv_fp8_e4m3, atoma::kNarrowDims)
"""


def build_fs_variant(name: str):
    """The split kernel alone (D = 64 and 128 at G = 4, every cache kind)
    with one variant's hooks, in a library under ``csrc/build/``."""
    import ctypes
    import hashlib

    flags = list(cuda_lib.NVCC_FLAGS) + ["-DATOMA_FS_SHAPES_D128_G4", *FS_VARIANTS[name]]
    headers = b"".join(p.read_bytes() for p in sorted(cuda_lib.CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(FS_ENTRIES.encode() + headers + " ".join(flags).encode()).hexdigest()
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_lib.BUILD_DIR / f"fs_ablation_{digest[:12]}.cu"
    out = cuda_lib.BUILD_DIR / f"libfs_{name}-{digest[:12]}.so"
    if not out.exists():
        src.write_text(FS_ENTRIES)
        done = subprocess.run([cuda_lib._nvcc(), *flags, "-I", str(cuda_lib.CSRC_DIR), "-o",
                               str(out), str(src)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(out))


def fused_variants(device, rounds=2):
    """Every hook variant of the split kernel on the 64-row batch at the 8B
    (each cache kind) and 1B (bf16) shapes, 1 and 4 splits at most."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(FS_VARIANTS)) as pool:
        libs = dict(zip(FS_VARIANTS, pool.map(build_fs_variant, FS_VARIANTS)))
    rng = np.random.default_rng(1)
    rng.integers(16, 2048, size=29)
    specs = [(1, int(k)) for k in rng.integers(16, 2048, size=64)]
    suffix = {None: "", torch.int8: "_int8", torch.float8_e4m3fn: "_fp8"}
    for model, shape, kinds in (("8B", dict(hq=32, hk=8, d=128), KINDS),
                                ("1B", dict(hq=32, hk=8, d=64), (None,))):
        for kind in kinds:
            b = make_batch(np.random.default_rng(3), specs, bs=16, kind=kind, device=device,
                           decode=True, **shape)
            q, m, cache, scales = b["q"], b["meta"], b["cache"], b["scales"]
            T, Hq, D = q.shape
            S, P = m.block_tables.shape
            nb, bs, row = cache.shape
            ref = pa.fused_decode_attention_plain(q, cache.clone(), b["k"], b["v"], m,
                                                  scale=D ** -0.5,
                                                  kv_scales=None if scales is None
                                                  else scales.clone())

            def run(lib, splits):
                fn = getattr(lib, f"atoma_fused_decode_attention_split{suffix[kind]}")
                fn.argtypes, fn.restype = pa.FUSED_DECODE_SPLIT[kind].argtypes, ctypes_int
                out = torch.empty_like(q)
                ws_o = torch.empty((splits, T, Hq, D), dtype=torch.float32, device=device)
                ws_ml = torch.empty((splits, T, Hq, 2), dtype=torch.float32, device=device)
                err = fn(q.data_ptr(), b["k"].data_ptr(), b["v"].data_ptr(), cache.data_ptr(),
                         None if scales is None else scales.data_ptr(), None,
                         m.slot_mapping.data_ptr(), m.block_tables.data_ptr(),
                         m.seq_lens.data_ptr(), m.query_start_loc.data_ptr(),
                         m.num_seqs.data_ptr(), None, out.data_ptr(), ws_o.data_ptr(),
                         ws_ml.data_ptr(), T, S, Hq, row // (2 * D), D, P, bs, nb * bs, splits,
                         pa.RPA_MIN_TILES, float(D ** -0.5), 0, 0.0,
                         cuda_lib.current_stream_handle(device))
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                if splits > 1:
                    pa.split_combine(ws_o, ws_ml, out, m, num_kv_heads=row // (2 * D), bq=1,
                                     splits=splits, min_tiles=pa.RPA_MIN_TILES)
                return out

            ok = {}
            for name, lib in libs.items():
                try:
                    got = run(lib, 4)
                except RuntimeError as e:  # reported, and the variant left out
                    print(f"fused variant {name} {model} {kind}: {e}", flush=True)
                    continue
                err = (got.float() - ref.float()).abs().max().item()
                if err > TOL * (1 + ref.float().abs().max().item()):
                    raise AssertionError(f"fused variant {name} {model} {kind}: err {err:.3e}")
                ok[name] = lib
            libs_ok = ok
            times = {name: {1: [], 4: []} for name in libs_ok}
            order = list(libs_ok) + list(libs_ok)[::-1]
            for _ in range(rounds):
                for name in order:
                    for splits in (1, 4):
                        times[name][splits].append(graph_ms(lambda: run(libs_ok[name], splits)))
            row = dict(batch="64 rows variants", shape=model,
                       kernel=pa.FUSED_DECODE_SPLIT[kind].name)
            for name, by in times.items():
                for splits, v in by.items():
                    row[f"{name} s{splits}"] = sum(v) / len(v)
            print(json.dumps(row), flush=True)


def fused_rows(device):
    """The fused decode batches: check once, then every split count."""
    rng = np.random.default_rng(1)  # phase 2's 8B decode batch (check_kv8_kernels)
    rng.integers(16, 2048, size=29)
    long_rows = [(1, int(k)) for k in rng.integers(16, 2048, size=64)]
    short_rows = [(1, int(k)) for k in np.random.default_rng(8).integers(50, 331, size=8)]
    shapes = {"8B": dict(hq=32, hk=8, d=128), "1B": dict(hq=32, hk=8, d=64),
              "3B": dict(hq=24, hk=8, d=128)}
    for label, specs in (("64 rows", long_rows), ("8 rows", short_rows)):
        for model, shape in shapes.items():
            for kind in KINDS:
                b = make_batch(np.random.default_rng(3), specs, bs=16, kind=kind, device=device,
                               decode=True, **shape)
                cache0, scales0 = b["cache"].clone(), (None if b["scales"] is None
                                                       else b["scales"].clone())
                ref = pa.fused_decode_attention_plain(
                    b["q"], b["cache"], b["k"], b["v"], b["meta"], scale=shape["d"] ** -0.5,
                    kv_scales=b["scales"])
                want_cache, want_scales = b["cache"].clone(), b["scales"]
                b["cache"], b["scales"] = cache0, scales0
                got = pa.ragged_paged_attention_fused_cuda(
                    b["q"], b["cache"], b["k"], b["v"], b["meta"], scale=shape["d"] ** -0.5,
                    kv_scales=b["scales"])
                err = (got.float() - ref.float()).abs().max().item()
                same = torch.equal(b["cache"].view(torch.uint8), want_cache.view(torch.uint8)) and (
                    want_scales is None or torch.equal(b["scales"].view(torch.int16),
                                                       want_scales.view(torch.int16)))
                if not (same and err <= TOL * (1 + ref.float().abs().max().item())):
                    raise AssertionError(f"fused {model} {label} {kind}: err {err:.3e}, "
                                         f"cache {'equal' if same else 'differs'}")
                row = dict(batch=label, shape=model, kernel=pa.FUSED_DECODE_SPLIT[kind].name)
                for splits in (1, 2, 3, 4, 6, 8, 16):
                    row[f"s{splits}"] = graph_ms(lambda: run_fused_split(b, splits))
                row["route_splits"] = pa.fused_splits_for(b["q"], b["meta"], shape["hk"], kind)
                row["route_ms"] = graph_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                    b["q"], b["cache"], b["k"], b["v"], b["meta"], scale=shape["d"] ** -0.5,
                    kv_scales=b["scales"]))
                row["unsplit_ms"] = graph_ms(lambda: run_fused_old(b))
                row["slots"] = pa._fused_slots(kind, shape["d"], shape["hq"] // shape["hk"], 0)
                print(json.dumps(row), flush=True)


def w512_rows(device):
    """The width 512's kernel on the mixed batch, its parts and single
    tiles, under each split count and the route's plan (see the module's
    docstring)."""
    rng = np.random.default_rng(512)
    mixed = [(300, 300), (128, 700), (57, 57)] + [
        (1, int(k)) for k in rng.integers(16, 1024, size=29)]
    batches = {
        "mixed": mixed, "mixed decode rows": mixed[3:], "mixed prefill rows": mixed[:3],
        "1 row, 64 keys": [(1, 64)], "1 row, 1024 keys": [(1, 1024)],
        "8 tokens, 64 keys": [(8, 64)], "8 tokens, 1024 keys": [(8, 1024)],
    }
    hq, hk, d, cap = 8, 4, 512, 50.0
    tokens = pa.RPA_WARP_ROWS // (hq // hk)
    for label, specs in batches.items():
        b = make_batch(rng, specs, hq=hq, hk=hk, d=d, bs=16, kind=None, device=device)
        ref = plain(b, soft_cap=cap)[:b["rows"]].float()
        row = dict(batch=label, kernel=pa.ragged_route(b["q"], None).name)
        for splits in (1, 2, 4, 8, 16):
            plan = pa.RpaPlan(pa.W512_WARPS, tokens, splits)
            err = (run_plan(b, plan, soft_cap=cap)[:b["rows"]].float() - ref).abs().max().item()
            if err > TOL * (1 + ref.abs().max().item()):
                raise AssertionError(f"{row['kernel']} {label} {plan}: max |err| {err:.3e}")
            row[f"s{splits}"] = graph_ms(lambda: run_plan(b, plan, soft_cap=cap))
        route = pa.rpa_plan_for(b["q"], b["meta"], hk, None)
        row["route_plan"] = [route.warps, route.tokens, route.splits]
        row["route_ms"] = graph_ms(lambda: pa.ragged_paged_attention_cuda(
            b["q"], b["cache"], b["meta"], scale=d ** -0.5, soft_cap=cap))
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--mode", choices=("ragged", "fused", "w512"), default="ragged",
                        help="ragged: the tensor-core ragged kernel's plans (default); fused: "
                             "the split fused decode kernel's split counts; w512: the width "
                             "512's kernel's split counts and tiles")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rpa_ablation needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    pattern = {"ragged": "rpa_", "fused": "fused_split", "w512": "rpa_w512"}[args.mode]
    sources = {"ragged": SOURCES, "fused": SOURCES + FUSED_SOURCES,
               "w512": W512_SOURCES}[args.mode]
    for source, log in cuda_lib.build_all(sources).items():
        for kernel, spill, regs in re.findall(
                r"Compiling entry function '(\w*" + pattern + r"\w*)'.*?(\d+) bytes spill "
                r"stores.*?Used (\d+) registers", log, re.S):
            print(f"{source}: {kernel[:60]} {regs} registers, {spill} bytes spilled")
    device = torch.device("cuda")
    if args.mode == "fused":
        fused_rows(device)
        fused_variants(device)
        return 0
    if args.mode == "w512":
        w512_rows(device)
        return 0
    print(f"small shapes agree, max |err| {check_small(device):.3e} (tol {TOL})", flush=True)
    timed_rows(device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
