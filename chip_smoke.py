#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``atoma_infer_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases (each one
raises on failure; nothing is caught):

1. The card's name and power limit (``nvidia-smi``), then the kernels'
   build: every ``atoma_infer_tpu_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a``, all sources in parallel.
2. Every kernel against its plain PyTorch version on the card.
   Attention and KV write: first every compiled instantiation at small sizes
   (head_dim 32/64/128 × block size 8/16/32/48/64/128 × GQA group 1 to 8,
   bf16 and f32), then Llama-3.2-1B
   attention shapes (Hq=32, Hk=8, D=64, block 16) with a mixed
   prefill+decode batch and a pure-decode batch: the KV write bit-exact, the
   attention kernels within the tolerances below (plus one case each with a
   sliding window, a soft cap and ALiBi); the KV writes timed in CUDA
   graphs beside ``index_copy_`` (their eager, host-inclusive times on an
   earlier line). Quantized matmuls: a sweep at small sizes (8/4-bit
   weights × group 128 and one group × bf16/f32 × M in 1, 8, 64, 300, plus
   ragged N; F and G on their route and on the CUDA cores), W8A8's integer
   dots checked exact, F and G's tensor-core route over groups of 32, 64,
   128 and one × M from 1 to 300 × N in 72, 144, 200, 2048, 14336 (each
   call's route checked by the launch counters; misaligned and f32 inputs
   on the CUDA cores), ``quantize_weight`` on the card byte-identical to
   the CPU, then the Llama-3.1-8B projection and LM-head shapes at decode
   (M = 8, 64) and one prefill chunk (M = 256), F and G on both routes, and
   the CUDA-core route on its own traffic (f32, ``tiny_trained``'s gate
   projection, 8 rows).
   INT8 and e4m3 KV caches (kernels D, E and their
   writes): every instantiation at small sizes on a mixed and a decode
   batch, then the Llama-3.1-8B attention shapes (Hq=32, Hk=8, D=128, block
   16); the writes and the fused kernels' caches and scales bit-exact, the
   attention within the tolerances below. A, B, D and E at the
   Llama-3.2-3B attention shapes (3 query heads per kv head), the ragged
   kernels at blocks of 16 and of 64. Kernel I (the W8A8 rate probe's
   matmul, both forms) at small shapes (M = 1 to 400) and at the probe's
   (184 × 4096 × 14336): int8 bit-exact, mixed within its tolerance. Times
   with CUDA events: kernel, plain version and, where one PyTorch call
   computes the same function, that call.
3. The port's ``Llama`` with 2 layers at full width: Llama-3.2-1B and
   Llama-3.2-3B dense, and
   Llama-3.1-8B quantized (INT8, INT4, and INT8 over an INT8 and an e4m3
   KV cache), prefill plus 3 decode steps on the card (kernels) against the
   same f32 weights on the CPU (plain versions). Then services on the card
   against the same on the CPU, greedy tokens identical: the tiny random
   model with a pool tight enough that groups are swapped out and back,
   ``tiny_trained`` quantized to INT8 and to INT4 on load, and ``tiny_trained`` over an
   INT8 KV cache (INT8 weights) and an e4m3 one, swapped out and back.
   ``tiny_trained`` is served in f32, so its quantized services (INT8 and
   INT4) are F and G's CUDA-core route: their launches in the kernels line
   come from those runs, their times from that model's shape (phase 2).
   Then the quality ladder on ``tiny_trained`` in f32 at reduced sizes on
   the card against the CPU: greedy agreements identical, drifts within
   ``LADDER_CARD_TOL``.
4. Services through ``LlmService.start``, each with 8 requests (chunked
   prefill, one seeded sampled, half submitted while the others decode):
   the full-width bf16 Llama-3.2-1B (16 layers, KV pool sized from
   ``torch.cuda.mem_get_info``), the full-width bf16 Llama-3.2-3B (28
   layers, 3 query heads per kv head) and the 1B again with blocks of 64,
   then the full-width Llama-3.1-8B (32
   layers, bf16 activations, llama3 rope scaling, untied per-channel INT8
   LM head) with INT8 weights, INT4 weights and INT8 weights under W8A8
   over a bf16 KV cache, and INT8 weights over an INT8 KV cache (pool sized
   from free memory) and an e4m3 one; random weights from a
   ``torch.Generator``, quantized with the port's ``quantize_weight``.
   Every request must finish at its length or on
   EOS, every block must return to the pool, and every kernel of the path
   must have been launched during that service's run (launch counts are set
   to 0 just before it and read just after). Prints the worker's step wall
   times and one pure-decode step's device time by kernel
   (``torch.profiler``).
5. The quantization decision tools (``atoma_infer_tpu_torch/tools``): the
   W8A8 rate probe's ``main()`` (its path through kernel I, both forms
   launched, int8 exact), then the W8A8 and INT8-KV gates at their card
   defaults and the quality ladder on ``tiny_trained`` in bf16, each
   printing its JSON; every number finite, every agreement in [0, 1], and
   each tool's kernels launched in its own run (F and H; D; A to H).
6. A ``{"kernels": [...]}`` JSON line (each kernel's launches from its own
   path's run), then as the last line ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernels against their plain versions, by dtype. bf16:
# inputs and outputs are bf16 (one rounding of the output, 2^-8 relative)
# and both sides accumulate in f32 in different orders; f32: summation
# order only.
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Model check: f32 weights on both sides; logits differ by summation order
# through 2 layers and a 2048- or 4096-wide LM head.
MODEL_TOL = 1e-3
# Quantized matmuls against their plain versions: max |err| over the
# output's largest magnitude. bf16: one rounding of the output to bf16 on
# both sides (half an ulp each, up to 2^-8 of a value) after f32 sums in
# another order; f32: summation order only.
QMM_TOL = {"bfloat16": 1e-2, "float32": 1e-5}

# Published H100 SXM peaks (NVIDIA data sheet) for the roofline bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# Llama-3.2-1B (the configuration bench.py runs), attention shapes.
HQ, HK, D, BS = 32, 8, 64, 16

# Llama-3.1-8B widths (meta-llama/Llama-3.1-8B config.json) and its
# quantized matmul shapes: name -> (K, N, group size).
LLAMA_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    rope_theta=500000.0, max_position_embeddings=131072, tie_word_embeddings=False,
)
QMM_SHAPES = {
    "q_proj/o_proj": (4096, 4096, 128),
    "k_proj/v_proj": (4096, 1024, 128),
    "gate_proj/up_proj": (4096, 14336, 128),
    "down_proj": (14336, 4096, 128),
    "lm_head": (4096, 128256, 4096),
}
# Llama-3.2-3B widths (meta-llama/Llama-3.2-3B config.json; BASELINE.json
# config #2): 24 q heads over 8 kv heads (3 a group), tied embeddings, llama3
# rope scaling with factor 32.
LLAMA_3B = dict(
    vocab_size=128256, hidden_size=3072, intermediate_size=8192,
    num_attention_heads=24, num_key_value_heads=8, head_dim=128,
    rope_theta=500000.0, max_position_embeddings=131072, tie_word_embeddings=True,
)
# The shape and row count whose numbers go into the kernels line.
QMM_LINE_SHAPE, QMM_LINE_M = "gate_proj/up_proj", 8

# The service's pure-decode step (0-based, among pure-decode steps) that
# runs under torch.profiler: past the first wave's warm-up, with the second
# wave decoding.
PROFILED_DECODE_STEP = 12


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms, its launches captured in a CUDA
    graph and replayed, so the host's launch cost is not in the number."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def profile_device(torch, fn):
    """Run ``fn`` once under ``torch.profiler``. Returns (its result, wall
    ms, device busy ms, [(kernel, device ms)] largest first). Busy time is
    the sum of the device events' own times (one stream: they do not
    overlap); the wall clock includes the profiler's own overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    return out, wall_ms, sum(t for _, t in kernels), kernels


# --------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def build_kernels() -> float:
    from atoma_infer_tpu_torch.ops import cuda_lib

    t0 = time.monotonic()
    logs = cuda_lib.build_all()
    seconds = time.monotonic() - t0
    for source, text in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", text))
        log(f"built {source}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, {spills} bytes of spill stores")
    log(f"kernel build: {seconds:.1f} s")
    return seconds


# --------------------------------------------------------------- phase 2
def make_batch(rng, specs, *, dtype, num_blocks, decode_only, device,
               hq=HQ, hk=HK, d=D, bs=BS):
    """A ragged batch at the main path's bucketed shapes: ``specs`` is a
    list of (q_len, kv_len); every sequence on random disjoint pages."""
    import numpy as np
    import torch

    from atoma_infer_tpu_torch.engine.input_prep import bucket
    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata

    n = len(specs)
    S = bucket(n, dense=decode_only)
    T = S if decode_only else bucket(sum(q for q, _ in specs))
    P = bucket(max(-(-kv // bs) for _, kv in specs))
    perm = rng.permutation(num_blocks)
    tables = np.zeros((S, P), np.int32)
    seq_lens = np.zeros(S, np.int32)
    qsl = np.zeros(S + 1, np.int32)
    slots = np.full(T, -1, np.int32)
    used = 0
    for s, (q_len, kv) in enumerate(specs):
        pages = -(-kv // bs)
        tables[s, :pages] = perm[used: used + pages]
        used += pages
        seq_lens[s] = kv
        qsl[s + 1] = qsl[s] + q_len
        for i in range(q_len):
            pos = kv - q_len + i
            slots[qsl[s] + i] = tables[s, pos // bs] * bs + pos % bs
    assert used <= num_blocks
    qsl[n + 1:] = qsl[n]
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    meta = AttentionMetadata(
        slot_mapping=ints(slots), block_tables=ints(tables), seq_lens=ints(seq_lens),
        query_start_loc=ints(qsl), num_seqs=ints([n]), block_size=bs,
        decode_only=decode_only, max_q_len=max(q for q, _ in specs),
    )
    return dict(
        q=randn(T, hq, d), k=randn(T, hk, d), v=randn(T, hk, d),
        cache=randn(num_blocks, bs, 2 * hk * d), meta=meta, specs=specs,
        rows=int(qsl[n]), dtype=dtype,
    )


# The attention kernels' shape grid at small sizes: block sizes (8, 16, 32
# stage a whole page; 48, 64, 128 stage it in key tiles of gcd(bs, 32)) and
# GQA groups (the fused kernel is instantiated for 1 to 8).
VARIANT_BLOCK_SIZES = (8, 16, 32, 48, 64, 128)
VARIANT_GROUPS = tuple(range(1, 9))


def check_kernel_variants(torch):
    """Every compiled instantiation against its plain version at small
    sizes: head_dim 32/64/128 × block size 8/16/32/48/64/128 × 1 to 8 query
    heads per kv head, bf16 and f32 (the main-path shapes are checked at
    full size in :func:`check_kernels`)."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write, paged_attention

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    mixed_specs = [(20, 45), (1, 30), (7, 7), (1, 1), (33, 70)]
    decode_specs = [(1, 45), (1, 17), (1, 1), (1, 64), (1, 100)]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = ATTN_TOL[dtype_name]
        worst, cases = 0.0, 0
        for d in (32, 64, 128):
            for bs in VARIANT_BLOCK_SIZES:
                for group in VARIANT_GROUPS:
                    shape = dict(hq=2 * group, hk=2, d=d, bs=bs, dtype=dtype,
                                 num_blocks=64, device=dev)
                    label = f"{dtype_name} D={d} bs={bs} G={group}"
                    b = make_batch(rng, mixed_specs, decode_only=False, **shape)
                    m, n = b["meta"], b["rows"]
                    got, want = b["cache"].clone(), b["cache"].clone()
                    kv_write.write_kv_cache_cuda(got, b["k"], b["v"], m.slot_mapping)
                    kv_write.write_kv_cache_plain(want, b["k"], b["v"], m.slot_mapping)
                    if not torch.equal(got, want):
                        raise AssertionError(f"reshape_and_cache {label} is not bit-exact")
                    out = paged_attention.ragged_paged_attention_cuda(
                        b["q"], got, m, scale=d ** -0.5)
                    ref = paged_attention.ragged_paged_attention_paged_plain(
                        b["q"], got, m, scale=d ** -0.5)
                    if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
                        raise AssertionError(f"ragged_paged_attention {label} disagrees")
                    worst = max(worst, (out[:n].float() - ref[:n].float()).abs().max().item())

                    b = make_batch(rng, decode_specs, decode_only=True, **shape)
                    m, n = b["meta"], b["rows"]
                    got, want = b["cache"].clone(), b["cache"].clone()
                    out = paged_attention.ragged_paged_attention_fused_cuda(
                        b["q"], got, b["k"], b["v"], m, scale=d ** -0.5)
                    ref = paged_attention.fused_decode_attention_plain(
                        b["q"], want, b["k"], b["v"], m, scale=d ** -0.5)
                    if not torch.equal(got, want):
                        raise AssertionError(f"fused_decode_attention {label}: cache differs")
                    if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
                        raise AssertionError(f"fused_decode_attention {label} disagrees")
                    worst = max(worst, (out[:n].float() - ref[:n].float()).abs().max().item())
                    cases += 1
        log(f"kernel variants {dtype_name}: {cases} shapes × 3 kernels agree, "
            f"max |err| {worst:.3e} (tol {tol})")


def attention_work(specs, window, elt, *, fused, kv_elt=None, slot_extra=0,
                   hq=HQ, hk=HK, d=D):
    """(bytes, flops) the attention needs for these sequences: each needed
    K/V row read once (``kv_elt`` bytes an element, default ``elt``, plus
    ``slot_extra`` bytes of scales a slot), q read and out written once
    (``elt`` bytes an element); 4·D flops per (query head, key) pair.
    ``fused`` adds the new rows' read and the cache row's write."""
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


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch):
    """Phase 2; returns the per-kernel rows of the kernels line (without
    the launch counts)."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write, paged_attention
    from atoma_infer_tpu_torch.ops.attention import alibi_slopes

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    mixed_specs = [(300, 300), (128, 700), (57, 57)] + [
        (1, int(k)) for k in rng.integers(16, 2048, size=29)
    ]
    decode_specs = [(1, int(k)) for k in rng.integers(16, 2048, size=64)]
    rows = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = ATTN_TOL[dtype_name]
        elt = torch.tensor([], dtype=dtype).element_size()
        mixed = make_batch(rng, mixed_specs, dtype=dtype, num_blocks=4096,
                           decode_only=False, device=dev)
        decode = make_batch(rng, decode_specs, dtype=dtype, num_blocks=8192,
                            decode_only=True, device=dev)
        m = mixed["meta"]

        # C: reshape_and_cache, bit-exact.
        got = mixed["cache"].clone()
        want = mixed["cache"].clone()
        kv_write.write_kv_cache_cuda(got, mixed["k"], mixed["v"], m.slot_mapping)
        kv_write.write_kv_cache_plain(want, mixed["k"], mixed["v"], m.slot_mapping)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"reshape_and_cache ({dtype_name}) is not bit-exact")
        log(f"reshape_and_cache {dtype_name}: bit-exact on {mixed['rows']} rows")
        cache = got  # holds this step's rows for the attention checks
        if dtype_name == "bfloat16":
            valid = m.slot_mapping >= 0
            slots = m.slot_mapping[valid].long()
            fused_rows = torch.stack([mixed["k"], mixed["v"]], 2).reshape(
                mixed["k"].shape[0], -1)[valid]
            flat = cache.view(-1, cache.shape[-1])
            n = mixed["rows"]
            c_bytes = n * 2 * (2 * HK * D * elt) + m.slot_mapping.numel() * 4

            def write():
                kv_write.write_kv_cache_cuda(cache, mixed["k"], mixed["v"], m.slot_mapping)

            def copy():
                flat.index_copy_(0, slots, fused_rows)

            log(f"reshape_and_cache: eager, host-inclusive {cuda_ms(write):.4f} ms "
                f"(index_copy_ {cuda_ms(copy):.4f} ms)")
            # The kernel and index_copy_ in CUDA graphs (device time); the
            # plain version selects rows by a boolean mask, which waits on
            # the host, so it cannot be captured and is timed eagerly.
            rows["reshape_and_cache"] = dict(
                max_abs_err=0.0, ms=graph_ms(torch, write),
                plain_ms=cuda_ms(lambda: kv_write.write_kv_cache_plain(
                    cache, mixed["k"], mixed["v"], m.slot_mapping)),
                library_ms=graph_ms(torch, copy), bytes=c_bytes, flops=0,
            )

        # A: ragged paged attention on the mixed batch.
        variants = [("base", {})]
        if dtype_name == "bfloat16":
            variants += [
                ("sliding_window", dict(sliding_window=256)),
                ("soft_cap", dict(soft_cap=30.0)),
                ("alibi", dict(alibi_slopes=alibi_slopes(HQ, device=dev))),
            ]
        scale = D ** -0.5
        for label, kw in variants:
            out = paged_attention.ragged_paged_attention_cuda(
                mixed["q"], cache, m, scale=scale, **kw)
            ref = paged_attention.ragged_paged_attention_paged_plain(
                mixed["q"], cache, m, scale=scale, **kw)
            n = mixed["rows"]
            err = (out[:n].float() - ref[:n].float()).abs().max().item()
            ok = torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol)
            log(f"ragged_paged_attention {dtype_name} {label}: max |err| {err:.3e} "
                f"(tol {tol})")
            if not ok:
                raise AssertionError(f"ragged_paged_attention {dtype_name} {label} disagrees")
            if dtype_name == "bfloat16" and label == "base":
                nbytes, flops = attention_work(mixed_specs, None, elt, fused=False)
                rows["ragged_paged_attention"] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: paged_attention.ragged_paged_attention_cuda(
                        mixed["q"], cache, m, scale=scale)),
                    plain_ms=cuda_ms(lambda: paged_attention.ragged_paged_attention_paged_plain(
                        mixed["q"], cache, m, scale=scale), iters=5, warmup=1),
                    library_ms=None, bytes=nbytes, flops=flops,
                )

        # B: fused decode write + attention on the pure-decode batch.
        dm = decode["meta"]
        for label, kw in variants:
            got_cache = decode["cache"].clone()
            want_cache = decode["cache"].clone()
            out = paged_attention.ragged_paged_attention_fused_cuda(
                decode["q"], got_cache, decode["k"], decode["v"], dm, scale=scale, **kw)
            ref = paged_attention.fused_decode_attention_plain(
                decode["q"], want_cache, decode["k"], decode["v"], dm, scale=scale, **kw)
            n = decode["rows"]
            err = (out[:n].float() - ref[:n].float()).abs().max().item()
            ok = torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol)
            log(f"fused_decode_attention {dtype_name} {label}: max |err| {err:.3e} "
                f"(tol {tol}), cache bit-exact {torch.equal(got_cache, want_cache)}")
            if not ok or not torch.equal(got_cache, want_cache):
                raise AssertionError(f"fused_decode_attention {dtype_name} {label} disagrees")
            if dtype_name == "bfloat16" and label == "base":
                nbytes, flops = attention_work(decode_specs, None, elt, fused=True)
                c = got_cache
                rows["fused_decode_attention"] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: paged_attention.ragged_paged_attention_fused_cuda(
                        decode["q"], c, decode["k"], decode["v"], dm, scale=scale)),
                    plain_ms=cuda_ms(lambda: paged_attention.fused_decode_attention_plain(
                        decode["q"], c, decode["k"], decode["v"], dm, scale=scale),
                        iters=5, warmup=1),
                    library_ms=None, bytes=nbytes, flops=flops,
                )
        del mixed, decode, cache
        torch.cuda.empty_cache()
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"), "bfloat16")
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}), bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rows


# ------------------------------------- phase 2: INT8 and FP8 KV caches (D, E)
KV8_DTYPES = ("int8", "fp8")


def same_bytes(torch, a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def kv8_cache(torch, cache, kv, d):
    """A 1-byte cache from a random ``make_batch`` cache: each slot's K and V
    halves quantized to INT8 with their scales by the port's plain
    quantization (returns (cache, scales)), or rounded to e4m3 (scales
    None)."""
    from atoma_infer_tpu_torch.ops.kv_cache import FP8_MAX, kv_quant_scales, quantize_kv_rows

    if kv == "fp8":
        return cache.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn), None
    nb, bs, row = cache.shape
    flat = cache.view(nb * bs, row // (2 * d), 2, d)
    k, v = flat[:, :, 0], flat[:, :, 1]
    scales = kv_quant_scales(k, v)
    q = quantize_kv_rows(k, v, scales).view(nb, bs, row)
    return q, scales.to(torch.bfloat16).view(nb, bs, 2)


def kv8_write(cache, scales, k, v, slots, *, cuda):
    """The KV write of a 1-byte cache, kernel or plain version, in place."""
    from atoma_infer_tpu_torch.ops import kv_write

    if scales is not None:
        fn = kv_write.write_kv_cache_quant_cuda if cuda else kv_write.write_kv_cache_quant_plain
        fn(cache, scales, k, v, slots)
    else:
        fn = kv_write.write_kv_cache_cuda if cuda else kv_write.write_kv_cache_plain
        fn(cache, k, v, slots)


def clone(t):
    return None if t is None else t.clone()


def check_kv8(torch, b, kv, label, tol, *, decode):
    """One batch through the kernels of a 1-byte cache against their plain
    versions. Mixed: the write kernel (cache and scales bit-exact), then
    ragged attention over the written cache. Decode: the fused kernel (cache
    and scales bit-exact with write-then-plain-attention, so the current
    token is attended in the cache's type). Returns (max |err|, the
    post-write cache and scales)."""
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    m, n, d = b["meta"], b["rows"], b["q"].shape[2]
    scale = d ** -0.5
    cache, scales = kv8_cache(torch, b["cache"], kv, d)
    got_c, got_s, want_c, want_s = cache, scales, clone(cache), clone(scales)
    if decode:
        out = pa.ragged_paged_attention_fused_cuda(
            b["q"], got_c, b["k"], b["v"], m, scale=scale, kv_scales=got_s)
        ref = pa.fused_decode_attention_plain(
            b["q"], want_c, b["k"], b["v"], m, scale=scale, kv_scales=want_s)
        what = f"fused_decode_attention_{kv}"
    else:
        kv8_write(got_c, got_s, b["k"], b["v"], m.slot_mapping, cuda=True)
        kv8_write(want_c, want_s, b["k"], b["v"], m.slot_mapping, cuda=False)
        what = f"reshape_and_cache_{kv}"
    if not same_bytes(torch, got_c, want_c) or (
            scales is not None and not same_bytes(torch, got_s, want_s)):
        raise AssertionError(f"{what} {label}: cache or scales not bit-exact")
    if not decode:
        out = pa.ragged_paged_attention_cuda(b["q"], got_c, m, scale=scale, kv_scales=got_s)
        ref = pa.ragged_paged_attention_paged_plain(b["q"], got_c, m, scale=scale, kv_scales=got_s)
        what = f"ragged_paged_attention_{kv}"
    err = (out[:n].float() - ref[:n].float()).abs().max().item()
    if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what} {label} disagrees: max |err| {err:.3e}")
    return err, got_c, got_s


def check_kv8_variants(torch):
    """Every compiled INT8/e4m3 instantiation against its plain version at
    small sizes: head_dim 32/64/128 × block size 8/16/32/48/64/128 × 1 to 8
    query heads per kv head × bf16/f32 queries, on a mixed and a
    pure-decode batch."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    mixed_specs = [(20, 45), (1, 30), (7, 7), (1, 1), (33, 70)]
    decode_specs = [(1, 45), (1, 17), (1, 1), (1, 64), (1, 100)]
    for kv in KV8_DTYPES:
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            tol = ATTN_TOL[dtype_name]
            worst, cases = 0.0, 0
            for d in (32, 64, 128):
                for bs in VARIANT_BLOCK_SIZES:
                    for group in VARIANT_GROUPS:
                        shape = dict(hq=2 * group, hk=2, d=d, bs=bs, dtype=dtype,
                                     num_blocks=64, device=dev)
                        label = f"{dtype_name} D={d} bs={bs} G={group}"
                        for decode, specs in ((False, mixed_specs), (True, decode_specs)):
                            b = make_batch(rng, specs, decode_only=decode, **shape)
                            err, _, _ = check_kv8(torch, b, kv, label, tol, decode=decode)
                            worst = max(worst, err)
                        cases += 1
            log(f"{kv} KV variants {dtype_name}: {cases} shapes × 3 kernels agree, writes "
                f"and fused caches bit-exact, max |err| {worst:.3e} (tol {tol})")


def check_kv8_kernels(torch):
    """D and E (and the 1-byte writes) at the Llama-3.1-8B attention shapes
    (Hq=32, Hk=8, D=128, block 16), bf16 queries: a mixed batch and 64
    decode sequences, each kernel against its plain version, then timed
    (CUDA events). Returns the kernels line's rows."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    mixed_specs = [(300, 300), (128, 700), (57, 57)] + [
        (1, int(k)) for k in rng.integers(16, 2048, size=29)
    ]
    decode_specs = [(1, int(k)) for k in rng.integers(16, 2048, size=64)]
    shape = dict(hq=32, hk=8, d=128, bs=16, dtype=torch.bfloat16, device=dev)
    mixed = make_batch(rng, mixed_specs, num_blocks=4096, decode_only=False, **shape)
    decode = make_batch(rng, decode_specs, num_blocks=8192, decode_only=True, **shape)
    tol, scale = ATTN_TOL["bfloat16"], 128 ** -0.5
    rows = {}
    for kv in KV8_DTYPES:
        extra = 4 if kv == "int8" else 0  # bytes of scales a slot
        work = dict(kv_elt=1, slot_extra=extra, hq=32, hk=8, d=128)
        m, dm = mixed["meta"], decode["meta"]
        err, cache, scales = check_kv8(torch, mixed, kv, "8B mixed", tol, decode=False)
        n = mixed["rows"]
        log(f"reshape_and_cache_{kv} 8B: bit-exact on {n} rows; ragged_paged_attention_{kv} "
            f"8B mixed: max |err| {err:.3e} (tol {tol})")
        row_in, row_out = 2 * 8 * 128 * 2, 2 * 8 * 128 + extra

        def write(cache=cache, scales=scales):
            kv8_write(cache, scales, mixed["k"], mixed["v"], m.slot_mapping, cuda=True)

        log(f"reshape_and_cache_{kv} 8B: eager, host-inclusive {cuda_ms(write):.4f} ms")
        rows[f"reshape_and_cache_{kv}"] = dict(
            max_abs_err=0.0, ms=graph_ms(torch, write),  # device time, as C's
            plain_ms=cuda_ms(lambda: kv8_write(cache, scales, mixed["k"], mixed["v"],
                                               m.slot_mapping, cuda=False)),
            library_ms=None, bytes=n * (row_in + row_out) + m.slot_mapping.numel() * 4, flops=0,
        )
        nbytes, flops = attention_work(mixed_specs, None, 2, fused=False, **work)
        rows[f"ragged_paged_attention_{kv}"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                mixed["q"], cache, m, scale=scale, kv_scales=scales)),
            plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                mixed["q"], cache, m, scale=scale, kv_scales=scales), iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops,
        )
        err, dcache, dscales = check_kv8(torch, decode, kv, "8B decode", tol, decode=True)
        log(f"fused_decode_attention_{kv} 8B decode: max |err| {err:.3e} (tol {tol}), "
            "cache and scales bit-exact")
        nbytes, flops = attention_work(decode_specs, None, 2, fused=True, **work)
        rows[f"fused_decode_attention_{kv}"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                kv_scales=dscales)),
            plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                kv_scales=dscales), iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops,
        )
        del cache, scales, dcache, dscales
    # The bf16 cache at the same shapes, for the bytes a 1-byte cache saves.
    bf16_ms = cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
        decode["q"], decode["cache"], decode["k"], decode["v"], decode["meta"], scale=scale))
    log(f"fused_decode_attention (bf16 cache) 8B decode: {bf16_ms:.4f} ms")
    del mixed, decode
    torch.cuda.empty_cache()
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"), "bfloat16")
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library none), "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rows


# Llama-3.2-3B's attention shapes, in make_batch's names.
LLAMA_3B_HEADS = dict(hq=LLAMA_3B["num_attention_heads"], hk=LLAMA_3B["num_key_value_heads"],
                      d=LLAMA_3B["head_dim"])


def check_gqa_block_kernels(torch):
    """A, B, D and E at the Llama-3.2-3B attention shapes (3 query heads per
    kv head), bf16 queries, over a bf16, an INT8 and an e4m3 cache: the
    fused kernels on 64 decode sequences at block 16, the ragged ones on a
    mixed batch at block 16 and at block 64 (key tiles of 32 keys), each
    against its plain version (fused caches and scales bit-exact), then
    timed with CUDA events beside their bounds."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    tol, scale = ATTN_TOL["bfloat16"], 128 ** -0.5
    for bs in (16, 64):
        rng = np.random.default_rng(2)  # the same sequences at both block sizes
        mixed_specs = [(300, 300), (128, 700), (57, 57)] + [
            (1, int(k)) for k in rng.integers(16, 2048, size=29)
        ]
        decode_specs = [(1, int(k)) for k in rng.integers(16, 2048, size=64)]
        shape = dict(LLAMA_3B_HEADS, bs=bs, dtype=torch.bfloat16, device=dev)
        mixed = make_batch(rng, mixed_specs, num_blocks=65536 // bs, decode_only=False, **shape)
        decode = make_batch(rng, decode_specs, num_blocks=131072 // bs, decode_only=True,
                            **shape)
        m, n = mixed["meta"], mixed["rows"]
        for kv in (None,) + KV8_DTYPES:
            suffix = f"_{kv}" if kv else ""
            extra = 4 if kv == "int8" else 0
            work = dict(kv_elt=1 if kv else 2, slot_extra=extra, **LLAMA_3B_HEADS)
            if kv:
                cache, scales = kv8_cache(torch, mixed["cache"], kv, 128)
            else:
                cache, scales = mixed["cache"], None
            out = pa.ragged_paged_attention_cuda(mixed["q"], cache, m, scale=scale,
                                                 kv_scales=scales)
            ref = pa.ragged_paged_attention_paged_plain(mixed["q"], cache, m, scale=scale,
                                                        kv_scales=scales)
            err = (out[:n].float() - ref[:n].float()).abs().max().item()
            if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
                raise AssertionError(f"ragged_paged_attention{suffix} 3B bs={bs} disagrees: "
                                     f"max |err| {err:.3e}")
            ms = cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                mixed["q"], cache, m, scale=scale, kv_scales=scales))
            bound_ms, by = bound(*attention_work(mixed_specs, None, 2, fused=False, **work),
                                 "bfloat16")
            log(f"ragged_paged_attention{suffix} 3B mixed bs={bs}: {ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {by}, max |err| {err:.3e} (tol {tol})")
            if bs != 16:
                continue
            if kv:
                err, dcache, dscales = check_kv8(torch, decode, kv, "3B decode G=3", tol,
                                                 decode=True)
            else:
                dcache, dscales = decode["cache"].clone(), None
                want = decode["cache"].clone()
                out = pa.ragged_paged_attention_fused_cuda(
                    decode["q"], dcache, decode["k"], decode["v"], decode["meta"], scale=scale)
                ref = pa.fused_decode_attention_plain(
                    decode["q"], want, decode["k"], decode["v"], decode["meta"], scale=scale)
                dn = decode["rows"]
                err = (out[:dn].float() - ref[:dn].float()).abs().max().item()
                if not (torch.equal(dcache, want) and torch.allclose(
                        out[:dn].float(), ref[:dn].float(), atol=tol, rtol=tol)):
                    raise AssertionError(f"fused_decode_attention 3B G=3 disagrees: max |err| "
                                         f"{err:.3e}")
            ms = cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], dcache, decode["k"], decode["v"], decode["meta"], scale=scale,
                kv_scales=dscales))
            bound_ms, by = bound(*attention_work(decode_specs, None, 2, fused=True, **work),
                                 "bfloat16")
            log(f"fused_decode_attention{suffix} 3B decode G=3 bs={bs}: {ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {by}, max |err| {err:.3e} (tol {tol}), cache bit-exact")
        del mixed, decode, cache, scales
        torch.cuda.empty_cache()


# ----------------------------------------------- phase 2: quantized matmuls
def rel_err(got, want):
    """(max |got − want| over max |want|, max |got − want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err / max(want.abs().max().item(), 1e-30), err


def check_quant_variants(torch):
    """Kernels F, G and H against their plain versions at small sizes
    (8/4-bit weights × grouped, one group and ragged-N shapes × bf16/f32 ×
    M in 1, 8, 64, 300); H's group dots exact against an int64 product on
    the CPU (unit scales, f32 output); ``quantize_weight`` on the card
    byte-identical to the CPU."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    # (K, N, group): groups of 128, one group, ragged N (1-column path), and
    # one with enough load chains at M = 300 for the unsplit lanes.
    shapes = [(384, 256, 128), (384, 256, 384), (256, 250, 128), (512, 72, 512),
              (1024, 2048, 128)]
    worst, cases, exact = {}, 0, 0
    for bits in (8, 4):
        for K, N, group in shapes:
            qt = quant.quantize_weight(torch.randn(K, N, generator=gen, device=dev) * 0.05,
                                       bits, group)
            q_full = (quant._unpack_int4(qt.qweight, group) if bits == 4 else qt.qweight)
            q_full = q_full.cpu().long()
            for dtype_name in ("bfloat16", "float32"):
                dtype, tol = getattr(torch, dtype_name), QMM_TOL[dtype_name]
                for M in (1, 8, 64, 300):
                    label = f"{bits}-bit K={K} N={N} group={group} {dtype_name} M={M}"
                    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                    xq, act = qk.quantize_activations(x)
                    want = qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=bits,
                                                     group_size=group)
                    pairs = {
                        "weight-only": (
                            qk.quantized_matmul_cuda(x, qt.qweight, qt.scales, bits=bits,
                                                     group_size=group), want),
                        # The CUDA-core kernel on every shape, whatever the route.
                        "weight-only CUDA cores": (
                            cuda_core_matmul(torch, x, qt.qweight, qt.scales, bits=bits,
                                             group=group), want),
                        "w8a8": (
                            qk.w8a8_matmul_cuda(xq, qt.qweight, qt.scales, act, bits=bits,
                                                group_size=group, out_dtype=dtype),
                            qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act, bits=bits,
                                                 group_size=group, out_dtype=dtype)),
                    }
                    for kind, (got, want) in pairs.items():
                        if got.dtype != dtype or got.shape != (M, N):
                            raise AssertionError(f"quantized matmul {kind} {label}: "
                                                 f"{got.dtype} {tuple(got.shape)}")
                        rel, _ = rel_err(got, want)
                        key = (kind, bits, dtype_name)
                        worst[key] = max(worst.get(key, 0.0), rel)
                        if not rel <= tol:
                            raise AssertionError(
                                f"quantized matmul {kind} {label}: rel err {rel:.3e} > {tol}")
                    dots = qk.w8a8_matmul_cuda(
                        xq, qt.qweight, torch.ones_like(qt.scales), torch.ones_like(act),
                        bits=bits, group_size=group, out_dtype=torch.float32)
                    if not torch.equal(dots.cpu(), (xq.cpu().long() @ q_full).float()):
                        raise AssertionError(f"W8A8 {label}: integer dots are not exact")
                    cases += 1
                    exact += 1
    for (kind, bits, dtype_name), rel in sorted(worst.items()):
        log(f"quantized matmul {kind} {bits}-bit {dtype_name}: worst rel err {rel:.3e} "
            f"(tol {QMM_TOL[dtype_name]})")
    log(f"quantized matmul variants: {cases} cases × 3 kernels agree; W8A8 group dots "
        f"exact in {exact} cases")
    check_mma_route(torch)

    cpu_gen = torch.Generator().manual_seed(12)
    for shape, bits, group in (((4096, 4096), 8, 128), ((4096, 4096), 4, 128),
                               ((4096, 1024), 8, 4096), ((2, 512, 384), 4, 128)):
        w = torch.randn(shape, generator=cpu_gen)
        on_cpu = quant.quantize_weight(w, bits, group)
        on_card = quant.quantize_weight(w.to(dev), bits, group)
        if not (torch.equal(on_card.qweight.cpu(), on_cpu.qweight)
                and torch.equal(on_card.scales.cpu().view(torch.int16),
                                on_cpu.scales.view(torch.int16))):
            raise AssertionError(f"quantize_weight {shape} {bits}-bit differs on the card")
    log("quantize_weight: byte-identical on the card and the CPU (4 shapes)")


def cuda_core_matmul(torch, x, qweight, scales, *, bits, group):
    """F or G on the CUDA cores (``qmm_float_kernel``) by a direct launch,
    with the geometry ``quantized_matmul_cuda`` gives that route, whatever
    route the call's shape would take there."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    M, K = x.shape
    N = qweight.shape[1]
    vec, ks, rsplit, gps, splits = qk._cuda_core_geometry(M, N, K // group, qweight)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    (qk.QMM_I8 if bits == 8 else qk.QMM_I4)(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, M, N, K, group,
        int(x.dtype == torch.bfloat16), vec, ks, rsplit, gps,
        cuda_lib.current_stream_handle(x.device))
    return out


def routed(bits, fn):
    """Run ``fn``; returns (its result, the one F or G kernel it launched)."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    names = [f"quantized_matmul_int{bits}", f"quantized_matmul_int{bits}_mma"]
    before = {k: cuda_lib.KERNELS[k].launches for k in names}
    out = fn()
    launched = [k for k in names if cuda_lib.KERNELS[k].launches > before[k]]
    if len(launched) != 1:
        raise AssertionError(f"quantized matmul: launched {launched}")
    return out, launched[0]


# The tensor-core route's grid at small sizes: K = 512 in groups of 16, 32,
# 64, 128 and one group; M across one, two and several m16 tiles and blocks
# of 16 to 128 rows; N = 144 ends on a partial column block, 72 and 200 are
# no multiple of 16 and take the CUDA cores, as do INT4 groups of 16 (half a
# k16 step of packed rows).
MMA_GROUPS = (16, 32, 64, 128, 512)
MMA_ROWS = (1, 8, 15, 16, 17, 64, 255, 256, 300)
MMA_COLS = (72, 144, 200, 2048, 14336)


def check_mma_route(torch):
    """F and G's routes against their plain versions within
    ``QMM_TOL["bfloat16"]``: bf16 activations over the grid above, each call
    shown by the launch counters to take the route the shape asks for; then
    misaligned weights, activations and scales and f32 activations, each
    shown to take the CUDA cores."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    K = 512
    worst, cases = {}, 0
    for bits in (8, 4):
        w = torch.randn(K, max(MMA_COLS), generator=gen, device=dev) * 0.05
        for group in MMA_GROUPS:
            for N in MMA_COLS:
                qt = quant.quantize_weight(w[:, :N].contiguous(), bits, group)
                for M in MMA_ROWS:
                    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                    got, kernel = routed(bits, lambda: qk.quantized_matmul_cuda(
                        x, qt.qweight, qt.scales, bits=bits, group_size=group))
                    label = f"{bits}-bit group={group} N={N} M={M}"
                    takes_mma = N % 16 == 0 and group % (16 if bits == 8 else 32) == 0
                    if kernel.endswith("_mma") != takes_mma:
                        raise AssertionError(f"quantized matmul {label} took {kernel}")
                    rel, _ = rel_err(got, qk.quantized_matmul_plain(
                        x, qt.qweight, qt.scales, bits=bits, group_size=group))
                    if got.dtype != torch.bfloat16 or got.shape != (M, N) or not (
                            rel <= QMM_TOL["bfloat16"]):
                        raise AssertionError(f"{kernel} {label}: rel err {rel:.3e}")
                    worst[kernel] = max(worst.get(kernel, 0.0), rel)
                    cases += 1
    for kernel, rel in sorted(worst.items()):
        log(f"{kernel}: worst rel err {rel:.3e} over the route grid (tol "
            f"{QMM_TOL['bfloat16']})")
    log(f"quantized matmul route grid: {cases} cases agree, each on the route its shape asks for")

    # Off 16-byte alignment (a view 8 bytes into a larger tensor) and f32
    # activations: the CUDA cores, and the same numbers.
    M, N, group = 8, 2048, 128
    w = torch.randn(K, N, generator=gen, device=dev) * 0.05
    for bits in (8, 4):
        qt = quant.quantize_weight(w, bits, group)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)

        def shifted(t):
            step = 8 // t.element_size()
            buf = torch.empty(t.numel() + step, dtype=t.dtype, device=dev)
            view = buf[step:].view(t.shape)
            view.copy_(t)
            return view

        for what, (xx, q, sc) in {
            "misaligned weight": (x, shifted(qt.qweight), qt.scales),
            "misaligned activations": (shifted(x), qt.qweight, qt.scales),
            "misaligned scales": (x, qt.qweight, shifted(qt.scales)),
            "f32 activations": (x.float(), qt.qweight, qt.scales),
        }.items():
            got, kernel = routed(bits, lambda: qk.quantized_matmul_cuda(
                xx, q, sc, bits=bits, group_size=group))
            rel, _ = rel_err(got, qk.quantized_matmul_plain(xx, q, sc, bits=bits,
                                                            group_size=group))
            tol = QMM_TOL["float32" if xx.dtype == torch.float32 else "bfloat16"]
            if kernel.endswith("_mma") or not rel <= tol:
                raise AssertionError(f"{bits}-bit {what}: {kernel}, rel err {rel:.3e}")
            log(f"{bits}-bit {what}: {kernel}, rel err {rel:.3e} (tol {tol})")


def qmm_work(M, K, N, group, *, bits, x_bytes, w8a8=False, out_bytes=2):
    """(bytes, flops) of one quantized matmul: weights, scales, activations
    (plus per-token scales for W8A8) read once, the output (bf16 unless
    said) written once; 2·M·K·N operations."""
    nbytes = K * N * bits // 8 + (K // group) * N * 2 + M * K * x_bytes + M * N * out_bytes
    if w8a8:
        nbytes += M * 4
    return nbytes, 2 * M * K * N


def check_quant_kernels(torch):
    """F, G and H at the Llama-3.1-8B shapes, bf16 activations, M = 8 and
    64 (decode) and 256 (a prefill chunk): F and G on both routes (the
    tensor cores, which these shapes take, and the CUDA cores by a direct
    launch), each against its plain version, then timed (CUDA graphs; each
    timed launch reads weights that are not in L2, as in a decode step where
    every layer's weights are new). Then the CUDA-core route on the traffic
    that reaches it (:func:`check_cuda_core_rows`). Returns the kernels
    line's rows: the tensor cores' and H's at the 8B gate projection, M = 8;
    the CUDA cores' from the f32 service's shape."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for shape, (K, N, group) in QMM_SHAPES.items():
        w = torch.randn(K, N, generator=gen, device=dev) * 0.02
        for bits in (8, 4):
            if shape == "lm_head" and bits == 4:
                continue  # the LM head is always INT8 per channel
            qt = quant.quantize_weight(w, bits, group)
            w_bytes = qt.qweight.numel() + qt.scales.numel() * 2
            # Enough copies that one pass over them does not fit in L2 (50 MB).
            copies = [qt] + [quant.QuantizedTensor(qt.qweight.clone(), qt.scales.clone(),
                                                   bits, group)
                             for _ in range(-(-128_000_000 // w_bytes) - 1)]
            dense = [quant.dequantize_weight(c, torch.bfloat16) for c in copies]
            iters = max(2, 20 // len(copies))
            # (kernel, route): the tensor cores, the CUDA cores, W8A8 (H).
            kinds = [(f"quantized_matmul_int{bits}_mma", "mma"),
                     (f"quantized_matmul_int{bits}", "cuda_cores")]
            if shape != "lm_head":
                kinds.append(("quantized_matmul_w8a8", "w8a8"))
            for M in (8, 64, 256):
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                xq, act = qk.quantize_activations(x)
                library_ms = graph_ms(torch, lambda x=x: [torch.mm(x, d) for d in dense],
                                      iters=iters) / len(copies)
                for name, route in kinds:
                    if route == "w8a8":
                        def run(c, xq=xq, act=act):
                            return qk.w8a8_matmul_cuda(xq, c.qweight, c.scales, act, bits=bits,
                                                       group_size=group,
                                                       out_dtype=torch.bfloat16)

                        def plain(xq=xq, act=act):
                            return qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act,
                                                        bits=bits, group_size=group,
                                                        out_dtype=torch.bfloat16)
                    elif route == "cuda_cores":
                        def run(c, x=x):
                            return cuda_core_matmul(torch, x, c.qweight, c.scales, bits=bits,
                                                    group=group)
                    else:
                        def run(c, x=x):
                            return qk.quantized_matmul_cuda(x, c.qweight, c.scales, bits=bits,
                                                            group_size=group)

                        def plain(x=x):
                            return qk.quantized_matmul_plain(x, qt.qweight, qt.scales,
                                                             bits=bits, group_size=group)
                    got = run(qt)
                    if route != "w8a8" and routed(bits, lambda: run(qt))[1] != name:
                        raise AssertionError(f"{name} {shape} M={M}: another route ran")
                    rel, err = rel_err(got, plain())
                    if not rel <= QMM_TOL["bfloat16"]:
                        raise AssertionError(f"{name} {shape} M={M}: rel err {rel:.3e}")
                    ms = graph_ms(torch, lambda: [run(c) for c in copies],
                                  iters=iters) / len(copies)
                    plain_ms = graph_ms(torch, plain, iters=2)
                    lib = library_ms if route != "w8a8" else None
                    nbytes, flops = qmm_work(M, K, N, group, bits=bits,
                                             x_bytes=1 if route == "w8a8" else 2,
                                             w8a8=route == "w8a8")
                    bound_ms, bound_by = bound(nbytes, flops,
                                               "int8" if route == "w8a8" else "bfloat16")
                    lib_text = f"{lib:.4f} ms" if lib is not None else "none"
                    how = " bf16 (direct launch)" if route == "cuda_cores" else ""
                    log(f"{name}{how} {bits}-bit {shape} K={K} N={N} M={M}: {ms:.4f} ms (plain "
                        f"{plain_ms:.4f} ms, library {lib_text}), bound {bound_ms:.4f} ms by "
                        f"{bound_by}, max |err| {err:.3e} (rel {rel:.2e})")
                    # The line's W8A8 row is the main path's: INT8 weights.
                    # The CUDA cores' row comes from the traffic they serve.
                    if (shape, M) == (QMM_LINE_SHAPE, QMM_LINE_M) and route != "cuda_cores" and \
                            not (route == "w8a8" and bits == 4):
                        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=lib, bound_ms=bound_ms,
                                          bound_by=bound_by)
            del copies, dense
        del w
        torch.cuda.empty_cache()
    rows.update(check_cuda_core_rows(torch))
    return rows


def check_cuda_core_rows(torch):
    """F and G's CUDA-core route timed on the traffic that reaches it in
    the smoke: the f32 ``tiny_trained`` services' gate projection (hidden ×
    intermediate from the fixture's config, groups of 128) at their decode
    batch of 8 rows, f32 activations through ``quantized_matmul_cuda`` (the
    launch counters show the route), in CUDA graphs with the weight in L2
    as the whole model is there; against the plain version and ``torch.mm``
    on the dequantized f32 weight. Returns their kernels line rows."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    with open(os.path.join(REPO, "tests", "fixtures", "tiny_trained", "config.json")) as f:
        cfg = json.load(f)
    K, N, group, M = cfg["hidden_size"], cfg["intermediate_size"], quant.DEFAULT_GROUP_SIZE, 8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.05
    x = torch.randn(M, K, generator=gen, device=dev)
    rows = {}
    for bits in (8, 4):
        qt = quant.quantize_weight(w, bits, group)
        dense = quant.dequantize_weight(qt, torch.float32)

        def run():
            return qk.quantized_matmul_cuda(x, qt.qweight, qt.scales, bits=bits,
                                            group_size=group)

        def plain():
            return qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=bits,
                                             group_size=group)

        got, name = routed(bits, run)
        if name != f"quantized_matmul_int{bits}":
            raise AssertionError(f"f32 tiny_trained gate_proj {bits}-bit took {name}")
        rel, err = rel_err(got, plain())
        if got.dtype != torch.float32 or not rel <= QMM_TOL["float32"]:
            raise AssertionError(f"{name} f32 tiny_trained gate_proj: rel err {rel:.3e}")
        ms, plain_ms = graph_ms(torch, run), graph_ms(torch, plain)
        library_ms = graph_ms(torch, lambda: torch.mm(x, dense))
        bound_ms, bound_by = bound(*qmm_work(M, K, N, group, bits=bits, x_bytes=4, out_bytes=4),
                                   "float32")
        log(f"{name} f32 {bits}-bit tiny_trained gate_proj K={K} N={N} M={M}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, library {library_ms:.4f} ms), bound {bound_ms:.4f} ms "
            f"by {bound_by}, max |err| {err:.3e} (rel {rel:.2e})")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return rows


# ------------------------------------- phase 2: the W8A8 rate probe (kernel I)
# Kernel I's mixed form against its plain version: max |err| over the
# output's largest magnitude. Every bf16 × int8 product is exact in f32 on
# both sides, and the sums differ in order; the tensor cores also align each
# k16 step's addends to the largest before adding, cutting the low bits of
# the smaller ones (up to about 2^-23 of the running sum a step, 256 steps
# at K = 4096). The int8 form is exact on both sides and must be equal.
PROBE_MIXED_TOL = 1e-4


def check_probe_kernels(torch):
    """Kernel I, both forms, against its plain version at small shapes
    (M = 1 to 400, K = 64 to 1024, N = 128 to 640) and at the probe's
    (184 × 4096 × 14336), then timed there with CUDA events per matmul over
    16 distinct weights (58.7 MB each, so none is in L2), and over one
    weight 16 times (in L2) for what the kernel takes when device memory
    is not its limit: the kernel, its
    plain version, and one PyTorch call for the same product, its weights
    converted beforehand (``torch._int_mm`` on column-major int8 weights,
    int32 out; ``torch.mm`` on bf16 weights, f32 out), itself checked
    against the plain version. Returns the kernels line's rows."""
    from atoma_infer_tpu_torch.tools import w8a8_probe as probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)

    def int8(*shape):
        return torch.randint(-127, 127, shape, generator=gen, device=dev, dtype=torch.int8)

    def check(xq, xb, w, label):
        got, want = probe.probe_matmul_cuda(xq, w), probe.probe_matmul_plain(xq, w)
        if got.dtype != torch.float32 or not torch.equal(got, want):
            raise AssertionError(f"probe_matmul_int8 {label}: not bit-exact")
        got, want = probe.probe_matmul_cuda(xb, w), probe.probe_matmul_plain(xb, w)
        rel, err = rel_err(got, want)
        if got.dtype != torch.float32 or not rel <= PROBE_MIXED_TOL:
            raise AssertionError(f"probe_matmul_mixed {label}: rel err {rel:.3e}")
        return rel, err

    # M past one block's 192 rows (193, 200, 400) takes more blocks along y;
    # K = 64 and 320 end on half an int8 tile of 128 k.
    worst, cases = 0.0, 0
    for k, n in ((64, 128), (320, 256), (256, 384), (1024, 640)):
        for m in (1, 16, 24, 37, 64, 130, 192, 193, 200, 400):
            w = int8(k, n)
            xb = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            worst = max(worst, check(int8(m, k), xb, w, f"M={m} K={k} N={n}")[0])
            cases += 1
    log(f"probe_matmul: {cases} small shapes, int8 bit-exact, mixed worst rel err "
        f"{worst:.3e} (tol {PROBE_MIXED_TOL})")

    m, k, n = probe.M, probe.K, probe.N
    ws = [int8(k, n) for _ in range(probe.R)]
    xq = int8(m, k)
    xb = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    _, err_mixed = check(xq, xb, ws[0], "probe shape")
    rows = {}
    for name, kind, x, err in (("probe_matmul_mixed", "mixed", xb, err_mixed),
                               ("probe_matmul_int8", "int8", xq, 0.0)):
        call, lib_ws = probe.library_call(kind, ws)
        rel, _ = rel_err(call(x, lib_ws[0]).float(), probe.probe_matmul_plain(x, ws[0]))
        if not rel <= PROBE_MIXED_TOL:
            raise AssertionError(f"{name}: the library call disagrees (rel err {rel:.3e})")
        us = probe.time_per_call_us(lambda w, x=x: probe.probe_matmul_cuda(x, w), ws)
        plain_us = probe.time_per_call_us(lambda w, x=x: probe.probe_matmul_plain(x, w), ws, 1)
        lib_us = probe.time_per_call_us(lambda w, x=x: call(x, w), lib_ws)
        del lib_ws
        nbytes, ops = probe.work(m, k, n, kind)
        bound_ms, bound_by = bound(nbytes, ops, "int8" if kind == "int8" else "bfloat16")
        # The same call with one weight for every launch, so that it is read
        # from L2: what the kernel takes when device memory is not its limit.
        l2_us = probe.time_per_call_us(lambda w, x=x: probe.probe_matmul_cuda(x, w), ws[:1] * 16)
        rows[name] = dict(max_abs_err=err, ms=us / 1e3, plain_ms=plain_us / 1e3,
                          library_ms=lib_us / 1e3, bound_ms=bound_ms, bound_by=bound_by)
        log(f"{name} [{m}x{k}]x[{k}x{n}]: {us:.2f} us ({ops / us * 1e-6:.1f} T/s, "
            f"{nbytes / us * 1e-6:.3f} TB/s), bound {bound_ms * 1e3:.2f} us by {bound_by}: "
            f"{bound_ms * 1e3 / us:.1%} of the bound; plain {plain_us:.2f} us, library "
            f"{lib_us:.2f} us; weight in L2 {l2_us:.2f} us; max |err| {err:.3e}")
    del ws
    torch.cuda.empty_cache()
    return rows


PROBE_PATH = ("probe_matmul_mixed", "probe_matmul_int8")


def run_probe(torch):
    """The probe's ``main()`` on the card, the path through kernel I (the
    JAX tool's inputs from ``numpy.random.default_rng(0)``, its lines
    printed): both forms must launch and the int8 one be exact. Returns the
    launch counts of this run (all set to 0 just before it)."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.tools import w8a8_probe

    for kernel in cuda_lib.KERNELS.values():
        kernel.launches = 0
    report = w8a8_probe.main([])
    launches = {name: cuda_lib.KERNELS[name].launches for name in PROBE_PATH}
    log(f"probe: launches {launches}")
    if not (report["exact"] and report["bit_exact"]):
        raise AssertionError("probe: int8 x int8 is not exact against integer math")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the probe's path")
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- the quantization gates and the ladder
def finite_report(report, label):
    """Every number in a tool's report finite, every agreement in [0, 1]."""
    def walk(obj, key=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, k)
        elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
            if obj != obj or obj in (float("inf"), float("-inf")):
                raise AssertionError(f"{label}: {key} is {obj}")
            if "agreement" in key and not 0 <= obj <= 1:
                raise AssertionError(f"{label}: {key} = {obj} lies outside [0, 1]")
    walk(report)


def run_tools(torch):
    """The W8A8 and INT8-KV gates at their card defaults (Llama-3.2-1B
    widths, 16 layers, blocks of 32, 16 sequences at 512 keys, 24 steps;
    random bf16 weights from a seeded generator) and the quality ladder on
    ``tiny_trained`` in bf16 (16 prompts of 96 corpus tokens, 32 steps).
    Each prints its JSON on a line of its own; every number must be finite,
    every agreement in [0, 1], and each tool's kernels launched in its run
    (counts set to 0 just before it)."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.tools import kv_quant_gate, quality_ladder, w8a8_gate

    def ladder():
        report = quality_ladder.ladder(device="cuda")
        log(json.dumps(report))
        return report

    # F and H for the W8A8 gate, D for the INT8-KV gate, A to H for the
    # ladder (F and G on the tensor cores: bf16 activations).
    runs = (
        ("w8a8_gate", lambda: w8a8_gate.main([]),
         ("quantized_matmul_int8_mma", "quantized_matmul_w8a8")),
        ("kv_quant_gate", lambda: kv_quant_gate.main([]), ("fused_decode_attention_int8",)),
        ("quality_ladder", ladder,
         ATTENTION_PATH + kv8_path("int8") + kv8_path("fp8")
         + ("quantized_matmul_int8_mma", "quantized_matmul_int4_mma", "quantized_matmul_w8a8")),
    )
    for name, run, path in runs:
        for kernel in cuda_lib.KERNELS.values():
            kernel.launches = 0
        t0 = time.monotonic()
        report = run()
        launches = {k: cuda_lib.KERNELS[k].launches for k in path}
        log(f"{name}: {time.monotonic() - t0:.1f} s on the card; launches {launches}")
        finite_report(report, name)
        for kernel, count in launches.items():
            if count == 0:
                raise AssertionError(f"kernel {kernel} was not launched in the {name} run")
        gc.collect()
        torch.cuda.empty_cache()


# The ladder in f32, card (kernels) against CPU (plain versions): the sums
# differ in the last bits, and where a KV value or a W8A8 activation lies
# that close to an int8 step or e4m3 code it lands on the neighbouring one
# (under 0.02% of INT8 KV values in the 8B model check above); on this peaked
# model that moves a chosen token's logprob by far less than 1e-3.
LADDER_CARD_TOL = 1e-3


def check_ladder_parity(torch):
    """The quality ladder on ``tiny_trained`` in f32 at reduced sizes (4
    prompts of 32 tokens, 4 steps) on the card and on the CPU: greedy
    agreements identical, peakedness and drifts within
    ``LADDER_CARD_TOL``."""
    from atoma_infer_tpu_torch.tools import quality_ladder

    sizes = dict(steps=4, seqs=4, prompt_len=32)
    card = quality_ladder.ladder(device="cuda", dtype=torch.float32, **sizes)
    cpu = quality_ladder.ladder(device="cpu", **sizes)
    pairs = [(f"peakedness {k}", card["reference_peakedness"][k], v)
             for k, v in cpu["reference_peakedness"].items()]
    for name, ref in cpu["variants"].items():
        got = card["variants"][name]
        if got["greedy_agreement"] != ref["greedy_agreement"]:
            raise AssertionError(f"ladder {name}: greedy agreement {got['greedy_agreement']} on "
                                 f"the card, {ref['greedy_agreement']} on the CPU")
        pairs += [(f"{name} {k}", got[k], ref[k]) for k in ("mean_abs_dlogprob", "max_abs_dlogprob")]
    worst = max(abs(a - b) for _, a, b in pairs)
    log(f"ladder f32 card vs CPU: greedy agreements identical, worst |diff| {worst:.2e} "
        f"(tol {LADDER_CARD_TOL}); card {json.dumps(card['variants'])}")
    for label, a, b in pairs:
        if abs(a - b) > LADDER_CARD_TOL:
            raise AssertionError(f"ladder {label}: {a} on the card, {b} on the CPU")


# --------------------------------------------------------------- phase 3
def params_to(params, device):
    """A copy of a parameter dict (one level of nesting) on ``device``;
    quantized weights move with their ``to``."""
    return {
        k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict) else v.to(device))
        for k, v in params.items()
    }


def code_steps(torch, a, b):
    """Per element, how many representable values apart two tensors of one
    dtype are: int8 steps, or e4m3/bf16 codes of the same sign (a change of
    sign counts as far apart)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.int8:
        return (a.int() - b.int()).abs()
    bits = 8 * a.element_size()
    view = torch.uint8 if bits == 8 else torch.int16
    ai, bi = (x.view(view).int() & ((1 << bits) - 1) for x in (a, b))
    sign = 1 << (bits - 1)
    return torch.where((ai & sign) == (bi & sign), (ai - bi).abs(), 1 << 30)


def model_parity(torch, cfg, params_cpu, label, tol, kv_dtype=None):
    """A 2-layer ``Llama`` on the card (kernels) against the same f32
    weights on the CPU (plain versions): a prefill and 3 decode steps of two
    sequences; logits within ``tol``. KV caches in f32 within ``tol``; a
    1-byte cache (``kv_dtype`` int8 or fp8) and its scales equal except in
    at most 1% of the values, each one step or code apart: the card's and
    the CPU's f32 projections differ in the last bits, and a value within
    that of a rounding boundary lands on the neighbouring step."""
    import numpy as np

    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata
    from atoma_infer_tpu_torch.ops.kv_cache import alloc_kv_scales

    cpu = Llama(cfg, dtype=torch.float32, device="cpu")
    gpu = Llama(cfg, dtype=torch.float32, device="cuda")
    params_gpu = params_to(params_cpu, gpu.device)
    cache_dtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(kv_dtype)
    caches = {name: m.alloc_kv_cache(64, BS, dtype=cache_dtype)
              for name, m in (("cpu", cpu), ("cuda", gpu))}
    scales = {name: ([alloc_kv_scales(64, BS, m.device) for _ in range(cfg.num_layers)]
                     if kv_dtype == "int8" else None)
              for name, m in (("cpu", cpu), ("cuda", gpu))}
    tables = [list(range(0, 20, 2)), list(range(1, 21, 2))]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 259, size=n).tolist() for n in (37, 70)]
    worst = 0.0
    for step in range(4):
        decode = step > 0
        lens = [len(p) + step for p in prompts]
        q_lens = [1, 1] if decode else lens
        T = 8 if decode else 128
        toks = np.zeros(T, np.int32)
        pos = np.zeros(T, np.int32)
        slots = np.full(T, -1, np.int32)
        qsl = np.zeros(9, np.int32)
        bt = np.zeros((8, 16), np.int32)
        sl = np.zeros(8, np.int32)
        r = 0
        for s, (kv, q) in enumerate(zip(lens, q_lens)):
            bt[s, : len(tables[s])] = tables[s]
            sl[s] = kv
            for i in range(kv - q, kv):
                toks[r] = prompts[s][i] if i < len(prompts[s]) else 3 + (i * 7) % 250
                pos[r] = i
                slots[r] = tables[s][i // BS] * BS + i % BS
                r += 1
            qsl[s + 1] = r
        qsl[3:] = r
        sel = qsl[1:3] - 1
        logits = {}
        for name, model, params in (("cpu", cpu, params_cpu), ("cuda", gpu, params_gpu)):
            def ints(a, dev=model.device):
                return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

            meta = AttentionMetadata(
                slot_mapping=ints(slots), block_tables=ints(bt), seq_lens=ints(sl),
                query_start_loc=ints(qsl), num_seqs=ints([2]), block_size=BS,
                decode_only=decode, max_q_len=max(q_lens),
            )
            with torch.inference_mode():
                hidden = model.forward(params, ints(toks), ints(pos), caches[name], meta,
                                       kv_scales=scales[name])
                logits[name] = model.compute_logits(params, hidden[ints(sel).long()]).float().cpu()
        err = (logits["cpu"] - logits["cuda"]).abs().max().item()
        worst = max(worst, err)
        log(f"model {label} step {step} ({'decode' if decode else 'prefill'}): "
            f"max |logit err| {err:.3e} (tol {tol})")
        if not torch.allclose(logits["cuda"], logits["cpu"], atol=tol, rtol=tol):
            raise AssertionError(f"model {label}: logits disagree at step {step}")
    tiers = [("cache", caches)] + ([("scales", scales)] if kv_dtype == "int8" else [])
    for what, tier in tiers:
        for layer, (c, g) in enumerate(zip(tier["cpu"], tier["cuda"])):
            if kv_dtype is None:
                err = (c - g.cpu()).abs().max().item()
                if err > tol:
                    raise AssertionError(f"model {label}: layer {layer} KV cache differs by {err}")
                continue
            steps = code_steps(torch, c, g)
            moved = (steps > 0).float().mean().item()
            log(f"model {label}: layer {layer} {what}: {int((steps > 0).sum())} of "
                f"{steps.numel()} values one step apart")
            if steps.max().item() > 1 or moved > 0.01:
                raise AssertionError(f"model {label}: layer {layer} {what} differs "
                                     f"(max {steps.max().item()} steps, {moved:.2%} moved)")
    return worst


def check_model(torch):
    """2-layer full-width Llama-3.2-1B and Llama-3.2-3B (3 query heads per
    kv head), dense f32: card vs CPU."""
    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=2,
        num_attention_heads=HQ, num_key_value_heads=HK, head_dim=D,
        max_position_embeddings=4096, tie_word_embeddings=True,
    )
    params = Llama(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    model_parity(torch, cfg, params, "1B dense", MODEL_TOL)
    cfg = llama_3b_config(2)
    params = Llama(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    model_parity(torch, cfg, params, "3B dense", MODEL_TOL)



def llama_3b_config(num_layers):
    from atoma_infer_tpu_torch.models.llama import LlamaConfig
    from atoma_infer_tpu_torch.ops.rope import RopeScalingConfig

    return LlamaConfig(
        num_hidden_layers=num_layers,
        rope_scaling=RopeScalingConfig(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                       original_max_position_embeddings=8192),
        **LLAMA_3B,
    )


def llama_8b_config(num_layers):
    from atoma_infer_tpu_torch.models.llama import LlamaConfig
    from atoma_infer_tpu_torch.ops.rope import RopeScalingConfig

    return LlamaConfig(
        num_hidden_layers=num_layers,
        rope_scaling=RopeScalingConfig(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                       original_max_position_embeddings=8192),
        **LLAMA_8B,
    )


def check_quant_model(torch):
    """2-layer full-width Llama-3.1-8B, f32 activations, weights quantized
    with the port's quantize_weight (INT8 and INT4, with the untied
    per-channel INT8 LM head): card vs CPU. W8A8 is held to its plain
    version kernel by kernel (phase 2) and not here: with these random
    weights its logits move by a tenth when one activation in a row rounds
    to the other int8 (the residual stream is small against the layers'
    outputs, so the next RMSNorm magnifies the change), and the card's and
    the CPU's f32 sums make such a rounding differ in some rows."""
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import quantize_params

    cfg = llama_8b_config(2)
    dense = Llama(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    model_parity(torch, cfg, quantize_params(dense, "int8"), "8B INT8", MODEL_TOL)
    model_parity(torch, cfg, quantize_params(dense, "int4"), "8B INT4", MODEL_TOL)


# Logits over a 1-byte KV cache, card against CPU: a value that lands on the
# neighbouring int8 step (1/127 of its row's absmax) or e4m3 code (up to 1/8
# of the value) moves the logits by far less than a wrong scale or row would
# (order 1).
KV8_MODEL_TOL = {"int8": 1e-2, "fp8": 5e-2}


def check_kv8_model(torch):
    """2-layer full-width Llama-3.1-8B with INT8 weights (quantized with the
    port's quantize_weight), f32 activations, over an INT8 KV cache and then
    an e4m3 one: card vs CPU."""
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import quantize_params

    cfg = llama_8b_config(2)
    dense = Llama(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    params = quantize_params(dense, "int8")
    for kv in KV8_DTYPES:
        worst = model_parity(torch, cfg, params, f"8B INT8 + {kv} KV", KV8_MODEL_TOL[kv], kv)
        log(f"model 8B INT8 + {kv} KV: worst |logit err| {worst:.3e} (tol {KV8_MODEL_TOL[kv]})")


def check_service_parity(torch):
    """The service on the card (kernels, pinned host swap tier) against the
    same service on the CPU (plain versions): the tiny random Llama in f32,
    its weights drawn once on the CPU, and a pool of 12 blocks, so that
    2-sequence groups are preempted by swap. Greedy tokens must be identical
    (``top_k=1`` makes the sampled groups greedy whatever the noise), swaps
    must have happened on both, and every block must come back."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import build_tiny_random
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    cpu_model, cpu_params, tokenizer = build_tiny_random("cpu")
    gpu_model = Llama(cpu_model.config, dtype=torch.float32, device="cuda")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]
    blocks = 12
    runs = {}
    for name, model, params in (
        ("cpu", cpu_model, cpu_params),
        ("cuda", gpu_model, params_to(cpu_params, gpu_model.device)),
    ):
        config = EngineConfig(
            model=ModelConfig(model_name="tiny-random", dtype="float32"),
            cache=CacheConfig(
                block_size=16, num_device_blocks_override=blocks, num_host_blocks_override=64,
            ),
            scheduler=SchedulerConfig(
                max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
            ),
            validation=ValidationConfig(best_of=2, max_input_tokens=128, max_total_tokens=256),
        )
        service = LlmService.start(
            config, model=model, params=params, tokenizer=tokenizer, device=model.device
        )
        cache_engine = service.engine.worker.cache_engine
        swap_out = cache_engine.swap_out
        swapped = []

        def counting_swap_out(mapping, swap_out=swap_out, swapped=swapped):
            swapped.append(len(mapping))
            return swap_out(mapping)

        cache_engine.swap_out = counting_swap_out

        async def drive(service=service):
            task = asyncio.create_task(service.engine.run())
            futs = [
                await service.handle_request(GenerateRequest(
                    request_id=f"parity-{i}", inputs=prompt,
                    parameters=GenerateParameters(
                        max_new_tokens=20, best_of=2, do_sample=True, top_k=1, seed=i,
                    ),
                ))
                for i, prompt in enumerate(prompts)
            ]
            results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
            service.stop()
            task.cancel()
            return results

        results = asyncio.run(drive())
        free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
        if free != blocks:
            raise AssertionError(f"service parity ({name}): {blocks - free} blocks leaked")
        if not sum(swapped):
            raise AssertionError(f"service parity ({name}): no group was swapped out")
        runs[name] = [[tuple(o.token_ids) for o in r.outputs] for r in results]
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError("service parity: greedy tokens differ between card and CPU")
    n = sum(len(t) for r in runs["cuda"] for t in r)
    log(f"service parity: {len(prompts)} requests × 2 sequences, {n} greedy tokens "
        f"identical on the card and the CPU, with swaps on both")


def check_quant_service_parity(torch):
    """``tiny_trained`` through ``LlmService.start`` from its directory with
    INT8 and then INT4 quantization on load, in f32, on the card (F and G on
    the CUDA cores: f32 activations) against the CPU (plain versions), with
    a pool of 5 blocks so that requests are preempted by recompute: greedy
    tokens identical, every block back in the pool. Returns the CUDA-core
    kernels' launches, each from its own card run (counts set to 0 just
    before it)."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.server import metrics
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]
    blocks = 5
    launches = {}
    for quantization in ("int8", "int4"):
        kernel = f"quantized_matmul_{quantization}"
        runs = {}
        for device in ("cpu", "cuda"):
            config = EngineConfig(
                model=ModelConfig(model_name=fixture, dtype="float32", quantization=quantization),
                cache=CacheConfig(
                    block_size=16, num_device_blocks_override=blocks, num_host_blocks_override=64,
                ),
                scheduler=SchedulerConfig(
                    max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
                ),
                validation=ValidationConfig(max_input_tokens=128, max_total_tokens=256),
            )
            service = LlmService.start(config, model_dir=fixture, device=device)
            preempt0 = metrics.PREEMPTIONS.value
            for k in cuda_lib.KERNELS.values():
                k.launches = 0

            async def drive(service=service):
                task = asyncio.create_task(service.engine.run())
                futs = [
                    await service.handle_request(GenerateRequest(
                        request_id=f"quant-parity-{i}", inputs=prompt,
                        parameters=GenerateParameters(max_new_tokens=16),
                    ))
                    for i, prompt in enumerate(prompts)
                ]
                results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
                service.stop()
                task.cancel()
                return results

            results = asyncio.run(drive())
            launched = cuda_lib.KERNELS[kernel].launches
            label = f"quantized service parity {quantization} ({device})"
            free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
            if free != blocks:
                raise AssertionError(f"{label}: {blocks - free} blocks leaked")
            if metrics.PREEMPTIONS.value == preempt0:
                raise AssertionError(f"{label}: no preemption")
            if (device == "cuda") != (launched > 0):
                raise AssertionError(f"{label}: {launched} launches of {kernel}")
            if device == "cuda":
                launches[kernel] = launched
            runs[device] = [tuple(r.outputs[0].token_ids) for r in results]
        if runs["cuda"] != runs["cpu"]:
            raise AssertionError(f"quantized service parity {quantization}: greedy tokens "
                                 "differ between card and CPU")
        n = sum(len(t) for t in runs["cuda"])
        log(f"quantized service parity: tiny_trained {quantization.upper()} f32, {len(prompts)} "
            f"requests, {n} greedy tokens identical on the card and the CPU, with preemption "
            f"by recompute on both; {kernel} launched {launches[kernel]} times")
    return launches


def kv8_path(kv):
    return (f"reshape_and_cache_{kv}", f"ragged_paged_attention_{kv}",
            f"fused_decode_attention_{kv}")


def check_kv8_service_parity(torch):
    """``tiny_trained`` from its directory with an INT8 KV cache (and INT8
    weights) and with an e4m3 one, on the card (kernels) against the CPU
    (plain versions): 2-sequence greedy groups on a pool of 12 blocks, so
    that groups are swapped to the host tier (INT8 scales with their pages)
    and back. Greedy tokens identical, swaps on both, every block back, and
    on the card every kernel of the path launched."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]
    blocks = 12
    for kv, quantization in (("int8", "int8"), ("fp8", None)):
        runs = {}
        for device in ("cpu", "cuda"):
            config = EngineConfig(
                model=ModelConfig(model_name=fixture, dtype="float32",
                                  quantization=quantization, kv_cache_dtype=kv),
                cache=CacheConfig(block_size=16, num_device_blocks_override=blocks,
                                  num_host_blocks_override=64),
                scheduler=SchedulerConfig(
                    max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
                ),
                validation=ValidationConfig(best_of=2, max_input_tokens=128,
                                            max_total_tokens=256),
            )
            service = LlmService.start(config, model_dir=fixture, device=device)
            cache_engine = service.engine.worker.cache_engine
            swapped = []
            swap_out = cache_engine.swap_out

            def counting_swap_out(mapping, swap_out=swap_out, swapped=swapped):
                swapped.append(len(mapping))
                return swap_out(mapping)

            cache_engine.swap_out = counting_swap_out
            before = {k: cuda_lib.KERNELS[k].launches for k in kv8_path(kv)}

            async def drive(service=service):
                task = asyncio.create_task(service.engine.run())
                futs = [
                    await service.handle_request(GenerateRequest(
                        request_id=f"kv-parity-{i}", inputs=prompt,
                        parameters=GenerateParameters(
                            max_new_tokens=16, best_of=2, do_sample=True, top_k=1, seed=i,
                        ),
                    ))
                    for i, prompt in enumerate(prompts)
                ]
                results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
                service.stop()
                task.cancel()
                return results

            results = asyncio.run(drive())
            label = f"{kv} KV service parity ({device})"
            free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
            if free != blocks:
                raise AssertionError(f"{label}: {blocks - free} blocks leaked")
            if not sum(swapped):
                raise AssertionError(f"{label}: no group was swapped out")
            launched = {k: cuda_lib.KERNELS[k].launches - n for k, n in before.items()}
            if any((device == "cuda") != (n > 0) for n in launched.values()):
                raise AssertionError(f"{label}: launches {launched}")
            runs[device] = [[tuple(o.token_ids) for o in r.outputs] for r in results]
        if runs["cuda"] != runs["cpu"]:
            raise AssertionError(f"{kv} KV service parity: greedy tokens differ "
                                 "between card and CPU")
        n = sum(len(t) for r in runs["cuda"] for t in r)
        log(f"{kv} KV service parity: tiny_trained{' INT8' if quantization else ''}, "
            f"{len(prompts)} requests × 2 sequences, {n} greedy tokens identical on the "
            f"card and the CPU, with swaps on both")


# --------------------------------------------------------------- phase 4
ATTENTION_PATH = ("reshape_and_cache", "ragged_paged_attention", "fused_decode_attention")


def serve(torch, label, model, params, config, path):
    """Drive one service: 8 requests with chunked prefill in two waves,
    one decode step profiled. Every request must finish, every block return,
    and every kernel of ``path`` launch. Returns the launch counts of this
    run (all set to 0 just before it)."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    cfg = model.config
    service = LlmService.start(
        config, model=model, params=params, tokenizer=ByteTokenizer(cfg.vocab_size),
        device=model.device,
    )
    pool = config.cache.num_device_blocks
    log(f"service {label}: KV pool {pool} blocks of {config.cache.block_size} tokens")

    # Per step: (prefill groups, decode groups, wall seconds of the worker
    # call, which ends when the sampled tokens are on the host, whether it
    # ran under the profiler).
    steps = []
    profiled = {}
    worker = service.engine.worker
    execute = worker.execute_model

    def timed_execute(request):
        metas = request.sequence_groups_metadata
        prefills = sum(m.is_prompt for m in metas)
        decodes = len(metas) - prefills
        t0 = time.monotonic()
        pure_decode = [s for s in steps if s[1] and not s[0]]
        traced = not prefills and len(pure_decode) == PROFILED_DECODE_STEP
        if traced:
            out, profiled["wall_ms"], profiled["busy_ms"], profiled["kernels"] = \
                profile_device(torch, lambda: execute(request))
            profiled["seqs"] = decodes
        else:
            out = execute(request)
        steps.append((prefills, decodes, time.monotonic() - t0, traced))
        return out

    worker.execute_model = timed_execute
    new_tokens = 32
    lengths = [16, 300, 45, 120, 200, 77, 250, 33]
    text = "The quick brown fox jumps over the lazy dog. " * 8

    def request(i):
        sampled = i == 3
        return GenerateRequest(
            request_id=f"smoke-{i}",
            inputs=text[: lengths[i]],
            parameters=GenerateParameters(
                max_new_tokens=new_tokens, do_sample=sampled,
                temperature=0.8 if sampled else None, top_p=0.9 if sampled else None,
                seed=1234 if sampled else None,
            ),
        )

    for kernel in cuda_lib.KERNELS.values():
        kernel.launches = 0

    async def drive():
        task = asyncio.create_task(service.engine.run())
        fut0, stream0 = await service.handle_request(request(0), stream=True)
        futs = [fut0] + [await service.handle_request(request(i)) for i in (1, 2, 3)]
        for _ in range(4):  # the first wave is decoding: admit the second
            await asyncio.wait_for(stream0.get(), timeout=300)
        futs += [await service.handle_request(request(i)) for i in (4, 5, 6, 7)]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=600)
        service.stop()
        task.cancel()
        return results

    t0 = time.monotonic()
    results = asyncio.run(drive())
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: k.launches for name, k in cuda_lib.KERNELS.items()}

    eos = set(cfg.eos_token_ids)
    generated = 0
    for r in results:
        out = r.outputs[0]
        generated += len(out.token_ids)
        at_length = len(out.token_ids) == new_tokens and out.finish_reason == "length_capped"
        at_eos = out.finish_reason == "stopped" and out.token_ids[-1] in eos
        if not (at_length or at_eos):
            raise AssertionError(
                f"{label} {r.request_id}: {len(out.token_ids)} tokens, finish {out.finish_reason}"
            )
    free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
    if free != pool:
        raise AssertionError(f"service {label}: {pool - free} KV blocks leaked")
    mixed = sum(1 for p, d, _, _ in steps if p and d)
    traced_s = sum(t for _, _, t, traced in steps if traced)
    log(f"service {label}: {len(results)} requests, {generated} tokens, {len(steps)} steps "
        f"({mixed} mixed prefill+decode) in {seconds:.2f} s ({traced_s:.2f} s of it "
        f"in the profiled step); launches {launches}")
    if mixed == 0:
        raise AssertionError(f"service {label}: no mixed prefill+decode step ran")
    for kind, pick in (("pure-decode", lambda p, d: d and not p),
                       ("mixed", lambda p, d: p and d)):
        ms = sorted(t * 1e3 for p, d, t, traced in steps if pick(p, d) and not traced)
        log(f"service {label}: {kind} worker step wall p50 {ms[len(ms) // 2]:.2f} ms, "
            f"max {ms[-1]:.2f} ms over {len(ms)} steps")
    if profiled.get("kernels"):
        top = ", ".join(f"{name[:48]} {t:.3f}" for name, t in profiled["kernels"][:6])
        # The quantized linears' share: kernels F, G, H and their K-split sums.
        qmm = sum(t for name, t in profiled["kernels"]
                  if "qmm_" in name or "split_reduce" in name)
        log(f"service {label}: profiled pure-decode step ({profiled['seqs']} seqs): device "
            f"busy {profiled['busy_ms']:.3f} ms of {profiled['wall_ms']:.2f} ms wall under "
            f"the profiler, quantized matmuls {qmm:.3f} ms; top device time (ms): {top}")
    else:
        log(f"service {label}: device time of a decode step not measured (the profiler "
            "recorded no device events)")
    for name in path:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    return launches


def bf16_config(name, block_size):
    """A bf16 service's configuration: KV pool sized from
    ``torch.cuda.mem_get_info``, chunked prefill with a 256-token budget
    (prompts arriving while others decode share steps with them, so mixed
    prefill+decode steps run)."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )

    return EngineConfig(
        model=ModelConfig(model_name=name, dtype="bfloat16"),
        cache=CacheConfig(block_size=block_size, hbm_memory_utilization=0.5,
                          num_host_blocks_override=64),
        scheduler=SchedulerConfig(
            max_num_batched_tokens=256, max_num_sequences=64, max_model_len=2048,
            enable_chunked_prefill=True,
        ),
        validation=ValidationConfig(max_input_tokens=1024, max_total_tokens=2048),
    )


def llama_1b_model(torch):
    """Llama-3.2-1B at full width, 16 layers, random bf16 weights."""
    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=HQ, num_key_value_heads=HK, head_dim=D,
        max_position_embeddings=4096, tie_word_embeddings=True,
    )
    model = Llama(cfg, dtype=torch.bfloat16, device="cuda")
    return model, model.init_params(torch.Generator(device=model.device).manual_seed(0))


def run_service(torch):
    """The bf16 Llama-3.2-1B service (16 layers), blocks of 16."""
    model, params = llama_1b_model(torch)
    return serve(torch, "1B bf16", model, params, bf16_config("llama-3.2-1b-random", BS),
                 ATTENTION_PATH)


def run_shape_services(torch):
    """Services at the shapes the kernels first refused: the bf16
    Llama-3.2-3B at full width (28 layers, 3 query heads per kv head,
    blocks of 16 as ``BASELINE.json`` config #2 says), whose decode steps
    must go through the fused kernel at G = 3, then the 16-layer
    Llama-3.2-1B with blocks of 64 (the ragged kernel in key tiles)."""
    from atoma_infer_tpu_torch.models.llama import Llama

    model = Llama(llama_3b_config(28), dtype=torch.bfloat16, device="cuda")
    params = model.init_params(torch.Generator(device=model.device).manual_seed(3))
    serve(torch, "3B bf16", model, params, bf16_config("llama-3.2-3b-random", BS),
          ATTENTION_PATH)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    model, params = llama_1b_model(torch)
    serve(torch, "1B bf16 block 64", model, params, bf16_config("llama-3.2-1b-random", 64),
          ATTENTION_PATH)


def run_quant_services(torch):
    """Llama-3.1-8B at full width (32 layers) with INT8 weights, INT4
    weights, and INT8 weights under W8A8, then INT8 weights over an INT8
    and an e4m3 KV cache: random bf16 weights from a seeded generator,
    quantized on the card with the port's quantize_weight (an untied
    per-channel INT8 LM head in all). Returns each quantized and 1-byte-KV
    kernel's launches from its own path's service."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import quantize_params
    from atoma_infer_tpu_torch.ops import quant_kernels

    model = Llama(llama_8b_config(32), dtype=torch.bfloat16, device="cuda")
    t0 = time.monotonic()
    dense = model.init_params(torch.Generator(device=model.device).manual_seed(8))
    params = {q: quantize_params(dense, q) for q in ("int8", "int4")}
    del dense
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"8B weights: drawn and quantized on the card in {time.monotonic() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    def config(quantization, kv_cache_dtype=None, **cache):
        cache = cache or dict(num_device_blocks_override=2048)
        return EngineConfig(
            model=ModelConfig(model_name="llama-3.1-8b-random", dtype="bfloat16",
                              quantization=quantization, kv_cache_dtype=kv_cache_dtype),
            cache=CacheConfig(block_size=BS, num_host_blocks_override=64, **cache),
            scheduler=SchedulerConfig(
                max_num_batched_tokens=256, max_num_sequences=64, max_model_len=2048,
                enable_chunked_prefill=True,
            ),
            validation=ValidationConfig(max_input_tokens=1024, max_total_tokens=2048),
        )

    launches = {}
    # bf16 activations at these shapes take F and G's tensor-core route.
    runs = (
        ("8B INT8", "int8", False, "quantized_matmul_int8_mma"),
        ("8B INT4", "int4", False, "quantized_matmul_int4_mma"),
        ("8B INT8 W8A8", "int8", True, "quantized_matmul_w8a8"),
    )
    for label, quantization, w8a8, kernel in runs:
        saved = quant_kernels._W8A8
        quant_kernels._W8A8 = w8a8
        try:
            # The LM head is INT8 per channel and weight-only in all three.
            path = ATTENTION_PATH + (kernel, "quantized_matmul_int8_mma")
            counts = serve(torch, label, model, params[quantization], config(quantization), path)
        finally:
            quant_kernels._W8A8 = saved
        launches[kernel] = counts[kernel]
        gc.collect()
        torch.cuda.empty_cache()

    # INT8 weights over an INT8 KV cache (BASELINE config #3; the pool sized
    # from free memory, so the scales' bytes per block are exercised), then
    # over an e4m3 cache.
    for kv, cache in (("int8", dict(hbm_memory_utilization=0.5)),
                      ("fp8", dict(num_device_blocks_override=2048))):
        cfg = config("int8", kv, **cache)
        label = f"8B INT8 + {kv.upper()} KV"
        path = kv8_path(kv) + ("quantized_matmul_int8_mma",)
        counts = serve(torch, label, model, params["int8"], cfg, path)
        per_block = cfg.cache.block_bytes(
            model.config.num_layers, model.config.num_kv_heads, model.config.head_dim, 1,
            scale_pages=kv == "int8")
        log(f"service {label}: {cfg.cache.num_device_blocks} KV blocks × {per_block} bytes "
            f"= {cfg.cache.num_device_blocks * per_block / 2**30:.2f} GiB")
        launches.update({k: counts[k] for k in kv8_path(kv)})
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "atoma_infer_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(card_line())
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on "
        f"{torch.cuda.get_device_name(0)}")
    # Every kernel module registers its kernels on import.
    from atoma_infer_tpu_torch.ops import cuda_lib, kv_write, paged_attention, quant_kernels  # noqa: F401
    from atoma_infer_tpu_torch.tools import w8a8_probe  # noqa: F401

    t0 = time.monotonic()

    def phase(fn):
        out = fn(torch)
        log(f"[{time.monotonic() - t0:.0f} s] {fn.__name__} done")
        return out

    build_kernels()
    phase(check_kernel_variants)
    rows = phase(check_kernels)
    phase(check_quant_variants)
    rows.update(phase(check_quant_kernels))
    phase(check_kv8_variants)
    rows.update(phase(check_kv8_kernels))
    phase(check_gqa_block_kernels)
    rows.update(phase(check_probe_kernels))
    phase(check_model)
    phase(check_quant_model)
    phase(check_kv8_model)
    phase(check_service_parity)
    launches_cuda_cores = phase(check_quant_service_parity)
    phase(check_kv8_service_parity)
    phase(check_ladder_parity)
    # The profiler's first start sets up device tracing, which takes
    # seconds: do it here, outside the services' runs.
    profile_device(torch, lambda: torch.ones(1, device="cuda") + 1)
    launches = phase(run_service)
    gc.collect()  # the finished service's KV pool
    torch.cuda.empty_cache()
    phase(run_shape_services)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase(run_quant_services))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase(run_probe))
    launches.update(launches_cuda_cores)
    phase(run_tools)

    line = []
    for name, kernel in cuda_lib.KERNELS.items():
        r = rows[name]
        line.append(dict(
            name=name, route="cuda", source=f"atoma_infer_tpu_torch/csrc/{kernel.source}",
            replaces=kernel.replaces, launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
