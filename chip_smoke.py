#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``atoma_infer_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases (each one
raises on failure; nothing is caught):

1. The card's name and power limit (``nvidia-smi``), then the kernels'
   build: every ``atoma_infer_tpu_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a``, all sources in parallel.
2. Every kernel against its plain PyTorch version on the card: first every
   compiled instantiation at small sizes (head_dim × block size × GQA group,
   bf16 and f32), then Llama-3.2-1B attention shapes (Hq=32, Hk=8, D=64,
   block 16) with a mixed prefill+decode batch and a pure-decode batch: the
   KV write bit-exact, the attention kernels within the tolerances below
   (plus one case each with a sliding window, a soft cap and ALiBi). Times
   with CUDA events: kernel, plain version and, where one PyTorch call
   computes the same function, that call.
3. The port's ``Llama`` at full 1B width with 2 layers: prefill plus 3
   decode steps on the card (kernels) against the same f32 weights on the
   CPU (plain versions). Then the service with the tiny random model on the
   card against the same on the CPU, with a pool tight enough that groups
   are swapped out and back: greedy tokens identical.
4. The service: ``LlmService.start`` with the full-width bf16 Llama-3.2-1B
   (16 layers, random weights from a ``torch.Generator``), the KV pool
   sized from ``torch.cuda.mem_get_info``, chunked prefill, 8 requests (one
   seeded sampled, half submitted while the others decode). Every request
   must finish at its length or on EOS, every block must return to the
   pool, and every kernel must have been launched during this run. Prints
   the worker's step wall times and one pure-decode step's device time by
   kernel (``torch.profiler``).
5. A ``{"kernels": [...]}`` JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import asyncio
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
# through 2 layers and a 2048-wide LM head.
MODEL_TOL = 1e-3

# Published H100 SXM peaks (NVIDIA data sheet) for the roofline bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Llama-3.2-1B (the configuration bench.py runs), attention shapes.
HQ, HK, D, BS = 32, 8, 64, 16

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


def check_kernel_variants(torch):
    """Every compiled instantiation against its plain version at small
    sizes: head_dim 32/64/128 × block size 8/16/32 × 1/2/4/8 query heads
    per kv head, bf16 and f32 (the main-path shapes are checked at full
    size in :func:`check_kernels`)."""
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
            for bs in (8, 16, 32):
                for group in (1, 2, 4, 8):
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


def attention_work(specs, window, elt, *, fused):
    """(bytes, flops) the attention needs for these sequences: each needed
    K/V row read once, q read and out written once; 4·D flops per (query
    head, key) pair. ``fused`` adds the new rows' read and cache write."""
    row = 2 * HK * D * elt
    nbytes = flops = 0
    for q_len, kv in specs:
        first = kv - q_len
        lo = max(0, first - window + 1) if window else 0
        kv_read = kv - lo - (1 if fused else 0)
        nbytes += kv_read * row + 2 * q_len * HQ * D * elt
        if fused:
            nbytes += 2 * row  # k_new/v_new in, the new row out
        for pos in range(first, kv):
            keys = min(pos + 1, window) if window else pos + 1
            flops += keys * HQ * 4 * D
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
            rows["reshape_and_cache"] = dict(
                max_abs_err=0.0,
                ms=cuda_ms(lambda: kv_write.write_kv_cache_cuda(
                    cache, mixed["k"], mixed["v"], m.slot_mapping)),
                plain_ms=cuda_ms(lambda: kv_write.write_kv_cache_plain(
                    cache, mixed["k"], mixed["v"], m.slot_mapping)),
                library_ms=cuda_ms(lambda: flat.index_copy_(0, slots, fused_rows)),
                bytes=c_bytes, flops=0,
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


# --------------------------------------------------------------- phase 3
def params_to(params, device):
    """A copy of a parameter dict (one level of nesting) on ``device``."""
    return {
        k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict) else v.to(device))
        for k, v in params.items()
    }


def check_model(torch):
    """2-layer full-width Llama: card (kernels) vs CPU (plain versions)."""
    import numpy as np

    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig
    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata

    cfg = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=2,
        num_attention_heads=HQ, num_key_value_heads=HK, head_dim=D,
        max_position_embeddings=4096, tie_word_embeddings=True,
    )
    cpu = Llama(cfg, dtype=torch.float32, device="cpu")
    gpu = Llama(cfg, dtype=torch.float32, device="cuda")
    params_cpu = cpu.init_params(torch.Generator().manual_seed(1))
    params_gpu = params_to(params_cpu, gpu.device)
    caches = {"cpu": cpu.alloc_kv_cache(64, BS), "cuda": gpu.alloc_kv_cache(64, BS)}
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
                hidden = model.forward(params, ints(toks), ints(pos), caches[name], meta)
                logits[name] = model.compute_logits(params, hidden[ints(sel).long()]).float().cpu()
        err = (logits["cpu"] - logits["cuda"]).abs().max().item()
        worst = max(worst, err)
        log(f"model step {step} ({'decode' if decode else 'prefill'}): "
            f"max |logit err| {err:.3e} (tol {MODEL_TOL})")
        if not torch.allclose(logits["cuda"], logits["cpu"], atol=MODEL_TOL, rtol=MODEL_TOL):
            raise AssertionError(f"model logits disagree at step {step}")
    for layer, (c, g) in enumerate(zip(caches["cpu"], caches["cuda"])):
        err = (c - g.cpu()).abs().max().item()
        if err > MODEL_TOL:
            raise AssertionError(f"layer {layer} KV cache differs by {err}")
    return worst


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


# --------------------------------------------------------------- phase 4
def run_service(torch):
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    cfg = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=HQ, num_key_value_heads=HK, head_dim=D,
        max_position_embeddings=4096, tie_word_embeddings=True,
    )
    model = Llama(cfg, dtype=torch.bfloat16, device="cuda")
    params = model.init_params(torch.Generator(device=model.device).manual_seed(0))
    config = EngineConfig(
        model=ModelConfig(model_name="llama-3.2-1b-random", dtype="bfloat16"),
        cache=CacheConfig(block_size=BS, hbm_memory_utilization=0.5, num_host_blocks_override=64),
        # Chunked prefill (256-token budget): prompts arriving while others
        # decode share steps with them, so mixed prefill+decode steps run.
        scheduler=SchedulerConfig(
            max_num_batched_tokens=256, max_num_sequences=64, max_model_len=2048,
            enable_chunked_prefill=True,
        ),
        validation=ValidationConfig(max_input_tokens=1024, max_total_tokens=2048),
    )
    service = LlmService.start(
        config, model=model, params=params, tokenizer=ByteTokenizer(cfg.vocab_size),
        device=model.device,
    )
    pool = config.cache.num_device_blocks
    log(f"service: KV pool {pool} blocks of {BS} tokens (sized from mem_get_info)")

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

    # The profiler's first start sets up device tracing, which takes
    # seconds: do it here, outside the service's run.
    profile_device(torch, lambda: torch.ones(1, device=model.device) + 1)
    # Every kernel module of the path registers its kernels on import; the
    # attention dispatch imports its module lazily, so import it here.
    from atoma_infer_tpu_torch.ops import kv_write, paged_attention  # noqa: F401

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
                f"{r.request_id}: {len(out.token_ids)} tokens, finish {out.finish_reason}"
            )
    free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
    if free != pool:
        raise AssertionError(f"{pool - free} KV blocks leaked")
    mixed = sum(1 for p, d, _, _ in steps if p and d)
    traced_s = sum(t for _, _, t, traced in steps if traced)
    log(f"service: {len(results)} requests, {generated} tokens, {len(steps)} steps "
        f"({mixed} mixed prefill+decode) in {seconds:.2f} s ({traced_s:.2f} s of it "
        f"in the profiled step); launches {launches}")
    if mixed == 0:
        raise AssertionError("no mixed prefill+decode step ran")
    for kind, pick in (("pure-decode", lambda p, d: d and not p),
                       ("mixed", lambda p, d: p and d)):
        ms = sorted(t * 1e3 for p, d, t, traced in steps if pick(p, d) and not traced)
        log(f"service: {kind} worker step wall p50 {ms[len(ms) // 2]:.2f} ms, "
            f"max {ms[-1]:.2f} ms over {len(ms)} steps")
    if profiled.get("kernels"):
        top = ", ".join(f"{name[:48]} {t:.3f}" for name, t in profiled["kernels"][:6])
        log(f"service: profiled pure-decode step ({profiled['seqs']} seqs): device busy "
            f"{profiled['busy_ms']:.3f} ms of {profiled['wall_ms']:.2f} ms wall under "
            f"the profiler; top device time (ms): {top}")
    else:
        log("service: device time of a decode step not measured (the profiler "
            "recorded no device events)")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
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
    build_kernels()
    check_kernel_variants(torch)
    rows = check_kernels(torch)
    check_model(torch)
    check_service_parity(torch)
    launches = run_service(torch)

    from atoma_infer_tpu_torch.ops import cuda_lib

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
