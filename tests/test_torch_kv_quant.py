"""The port's INT8 and FP8 KV caches vs the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the port
keeps two bf16 scales per slot where JAX keeps a 128-lane page, so scales
compare as ``port == jax[..., :2]``. Tolerances:
- INT8 scales and rows, e4m3 rows, caches after every write (plain or
  fused): byte for byte;
- attention over a 1-byte cache, f32: atol 1e-5 / rtol 1e-5 against the XLA
  oracle (the same dequantized f32 arithmetic in another order) and against
  the Pallas kernel in interpret mode (online softmax; scales applied after
  the dots there, before them here: ~1e-6 apart);
- the model over 1-byte caches: its f32 projections are summed in another
  order than XLA's (≈1e-6 apart), and a value that sits within that of a
  rounding boundary lands on the neighbouring int8 step or e4m3 code. So the
  caches agree byte for byte except in at most 1% of the values (a handful
  per layer here), each one step or code apart, the scales within one bf16
  ulp; and the logits, which such a step moves, within atol 1e-3 (INT8:
  one step is 1/127 of a row's absmax) or 2e-2 (e4m3: one code is up to
  1/8 of a value) — errors of a wrong scale or a wrong row are of order 1;
- services: greedy tokens identical, with preemption by swap and by
  recompute.
"""

import asyncio
import dataclasses
import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from atoma_infer_tpu.ops import kv_cache as jkv
from atoma_infer_tpu.ops.kv_cache import kv_cache_view as jax_kv_cache_view
from atoma_infer_tpu.ops.kv_cache import scales_flat as jax_scales_flat
from atoma_infer_tpu.ops.paged_attention import (
    _e4m3_decode,
    ragged_paged_attention_fused,
    ragged_paged_attention_fused_quant,
    ragged_paged_attention_pallas,
)
from atoma_infer_tpu.ops.reference import ragged_paged_attention_xla
from atoma_infer_tpu_torch.ops import kv_cache as pkv
from atoma_infer_tpu_torch.ops import attention as port_attention
from atoma_infer_tpu_torch.ops.paged_attention import (
    fused_decode_attention_plain,
    ragged_paged_attention_paged_plain,
)

from torch_parity import FIXTURE_TINY_TRAINED as FIXTURE
from torch_parity import (
    jax_meta,
    jax_scale_pages,
    model_step,
    quantized_case,
    to_numpy,
    to_torch,
    torch_meta,
    valid_rows,
)

torch.set_num_threads(2)

JAX, PORT = "atoma_infer_tpu", "atoma_infer_tpu_torch"
ATOL = 1e-5
BF16 = ml_dtypes.bfloat16
FP8 = ml_dtypes.float8_e4m3fn


def _bytes(a) -> np.ndarray:
    """Raw bytes of a numpy/JAX array or a tensor, for exact comparison."""
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


# ------------------------------------------------------------ quantization
def _kv_inputs(kind, dtype, T=6, hk=2, d=32, seed=0):
    """K/V [T, Hk, D] as numpy f32 holding values exact in ``dtype``."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        k, v = (rng.standard_normal((2, T, hk, d)) * 3).astype(np.float32)
    elif kind == "half_steps":
        # Scale s = 2^-4 exactly (absmax 127·s), every other value at
        # (n + 0.5)·s: x·(1/s) lands on .5 and must round half to even.
        s = np.float32(2.0**-4)
        n = rng.integers(-126, 126, size=(2, T, hk, d)).astype(np.float32)
        k, v = (n + np.float32(0.5)) * s
        k[:, 0, 0], v[:, 0, 0] = 127 * s, -127 * s
    elif kind == "zero_token":
        k, v = rng.standard_normal((2, T, hk, d)).astype(np.float32)
        k[2], v[2] = 0.0, 0.0  # the 1e-8 scale floor
    else:
        raise ValueError(kind)
    if dtype == "bfloat16":
        k, v = (x.astype(BF16).astype(np.float32) for x in (k, v))
    return k, v


def _both(x, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "half_steps", "zero_token"])
def test_int8_scales_rows_and_write_are_jax_bytes(kind, dtype):
    k, v = _kv_inputs(kind, dtype)
    kj, kt = _both(k, dtype)
    vj, vt = _both(v, dtype)
    scales_j = jkv.kv_quant_scales(kj, vj)
    scales_t = pkv.kv_quant_scales(kt, vt)
    np.testing.assert_array_equal(scales_t.numpy(), np.asarray(scales_j))
    rows_j = jkv.quantize_kv_rows(kj, vj, scales_j)
    rows_t = pkv.quantize_kv_rows(kt, vt, scales_t)
    assert rows_t.dtype == torch.int8
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    if kind == "half_steps":  # the .5 cases really are there, and rounded to even
        assert np.any(np.abs(np.asarray(rows_j)) % 2 == 0)

    # The write: padding (-1) and out-of-range slots dropped.
    nb, bs = 4, 8
    slots = np.asarray([5, -1, 31, 12, 40, 0], np.int32)
    cache = np.zeros((nb, bs, 2 * 2 * 32), np.int8)
    cache_j, sc_j = jkv.write_kv_cache_quant(
        jnp.asarray(cache), jkv.alloc_kv_scales(nb, bs), kj, vj, jnp.asarray(slots)
    )
    cache_t = torch.from_numpy(cache.copy())
    sc_t = pkv.alloc_kv_scales(nb, bs)
    pkv.write_kv_cache_quant(cache_t, sc_t, kt, vt, torch.from_numpy(slots))
    np.testing.assert_array_equal(cache_t.numpy(), np.asarray(cache_j))
    np.testing.assert_array_equal(_bytes(sc_t), _bytes(np.asarray(sc_j)[..., :2]))
    assert not np.asarray(sc_j)[..., 2:].astype(np.float32).any()


def _fp8_inputs(seed=1):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((2, 8, 2, 32)) * 100).astype(np.float32)
    k[0, 0, :6] = [500.0, -1e4, 448.0, 464.0, -465.0, 449.0]          # past ±448
    k[1, 0, :8] = np.float32(2.0**-9) * np.arange(1, 9)              # subnormals
    k[2, 0, :4] = [2.0**-10, 3 * 2.0**-10, 1.0625, 1.1875]          # ties
    v[3] = rng.standard_normal((2, 32)).astype(np.float32) * 2.0**-8
    return k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_rows_and_write_are_jax_bytes(dtype):
    k, v = _fp8_inputs()
    kj, kt = _both(k, dtype)
    vj, vt = _both(v, dtype)
    rows_j = jkv.kv_rows(kj, vj, jnp.float8_e4m3fn)
    rows_t = pkv.kv_rows(kt, vt, torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(rows_t), _bytes(rows_j))
    nb, bs = 4, 8
    slots = np.asarray([3, 9, -1, 30, 31, 2, 64, 17], np.int32)
    cache = np.zeros((nb, bs, 2 * 2 * 32), FP8)
    cache_j = jkv.write_kv_cache(jnp.asarray(cache), kj, vj, jnp.asarray(slots))
    cache_t = to_torch(cache)
    pkv.write_kv_cache(cache_t, kt, vt, torch.from_numpy(slots))
    got = _bytes(cache_t)
    np.testing.assert_array_equal(got, _bytes(cache_j))
    # No NaN byte (0x7F, 0xFF) is ever written: writes clip to ±448.
    assert not np.isin(_bytes(rows_t), [0x7F, 0xFF]).any()
    assert not np.isin(got, [0x7F, 0xFF]).any()


def test_e4m3_decode_equals_jax_byte_decoder():
    """The port widens e4m3 as the card does (torch's conversion); it equals
    the TPU kernel's VPU byte decoder for every non-NaN byte."""
    b = np.arange(256, dtype=np.uint8)
    port = torch.from_numpy(b).view(torch.float8_e4m3fn).float().numpy()
    jax_dec = np.asarray(_e4m3_decode(jnp.asarray(b.view(np.int8)), jnp.float32))
    keep = ~np.isin(b, [0x7F, 0xFF])
    assert keep.sum() == 254 and np.isnan(port[~keep]).all()
    np.testing.assert_array_equal(port[keep], jax_dec[keep])


# ---------------------------------------------------------------- attention
# Shapes of the JAX package's own INT8/FP8 kernel tests
# (tests/test_paged_attention_kernel.py:435-447,689-693).
SHAPES = dict(num_q_heads=8, num_kv_heads=4, head_dim=64, block_size=32)
ATTN_CASES = {
    # name: (seq_specs, ragged_case kwargs, pages_per_chunk)
    "decode": ([(1, kv) for kv in (1, 5, 31, 33, 64, 128)], dict(pad_seqs_to=8), None),
    "prefill_mixed": ([(40, 40), (1, 70), (8, 24)], dict(num_blocks=16), None),
    "long_kv": ([(1, 1000), (1, 600)], dict(num_blocks=64), 4),
}


def _attention_inputs(kv_dtype, name):
    specs, kw, ppc = ATTN_CASES[name]
    kw = dict(SHAPES, **kw)
    seed = sorted(ATTN_CASES).index(name) + (10 if kv_dtype == "fp8" else 0)
    case = quantized_case(np.random.default_rng(seed), specs, kv_dtype, **kw)
    return case, ppc


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_plain_vs_xla_oracle_and_pallas(kv_dtype, name):
    case, ppc = _attention_inputs(kv_dtype, name)
    D, Hk = case["q"].shape[2], case["k_new"].shape[1]
    scale = D**-0.5
    n = valid_rows(case)
    scales = case.get("kv_scales")

    got = ragged_paged_attention_paged_plain(
        torch.from_numpy(case["q"]), to_torch(case["kv_cache"]), torch_meta(case),
        scale=scale, kv_scales=None if scales is None else to_torch(scales),
    ).numpy()
    # The layer's dispatch on the CPU takes the same plain version.
    dispatched = port_attention.ragged_paged_attention(
        torch.from_numpy(case["q"]), to_torch(case["kv_cache"]), torch_meta(case),
        scale=scale, kv_scales=None if scales is None else to_torch(scales),
    ).numpy()
    np.testing.assert_array_equal(dispatched, got)

    meta = jax_meta(case)
    cache = jnp.asarray(case["kv_cache"])
    k_view, v_view = jax_kv_cache_view(cache, Hk, D)
    kw = {}
    if scales is not None:
        pages = jnp.asarray(jax_scale_pages(scales))
        kw = dict(zip(("k_scale", "v_scale"), jax_scales_flat(pages)))
    oracle = np.asarray(
        ragged_paged_attention_xla(
            jnp.asarray(case["q"]), k_view, v_view, meta.block_tables, meta.seq_lens,
            meta.query_start_loc, scale=scale, block_size=meta.block_size, **kw,
        )
    )
    pallas = np.asarray(
        ragged_paged_attention_pallas(
            jnp.asarray(case["q"]), cache, meta, scale=scale, interpret=True,
            pages_per_chunk=ppc,
            kv_scales=None if scales is None else jnp.asarray(jax_scale_pages(scales)),
        )
    )
    np.testing.assert_allclose(got[:n], oracle[:n], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got[:n], pallas[:n], atol=ATOL, rtol=ATOL)


def _decode_case(kv_dtype, seed):
    specs = [(1, kv) for kv in (1, 32, 33, 64, 95, 128)]
    return quantized_case(np.random.default_rng(seed), specs, kv_dtype, pad_seqs_to=8, **SHAPES)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_fused_decode_plain_vs_pallas_fused(kv_dtype):
    """The fused decode plain version (write, then attend over the written
    cache) against JAX's fused kernels in interpret mode: caches and scales
    byte for byte, outputs within ATOL; the layer entry point on the CPU
    gives the same."""
    case = _decode_case(kv_dtype, seed=33)
    D = case["q"].shape[2]
    scale = D**-0.5
    n = valid_rows(case)
    meta_t = torch_meta(case)
    assert meta_t.decode_only
    q, k_new, v_new = (torch.from_numpy(case[x]) for x in ("q", "k_new", "v_new"))
    scales = case.get("kv_scales")

    runs = {}
    for how in ("plain", "layer"):
        cache_t = to_torch(case["kv_cache"]).clone()
        sc_t = None if scales is None else to_torch(scales).clone()
        fn = fused_decode_attention_plain if how == "plain" else port_attention.paged_attention_layer
        out = fn(q, cache_t, k_new, v_new, meta_t, scale=scale, kv_scales=sc_t).numpy()
        runs[how] = (out, cache_t, sc_t)
    np.testing.assert_array_equal(runs["layer"][0][:n], runs["plain"][0][:n])

    meta = dataclasses.replace(jax_meta(case), decode_only=True)
    args = (jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]))
    kn, vn = jnp.asarray(case["k_new"]), jnp.asarray(case["v_new"])
    if kv_dtype == "int8":
        out_j, cache_j, sc_j = ragged_paged_attention_fused_quant(
            *args, jnp.asarray(jax_scale_pages(scales)), kn, vn, meta, scale=scale,
            interpret=True,
        )
    else:
        out_j, cache_j = ragged_paged_attention_fused(
            *args, kn, vn, meta, scale=scale, interpret=True
        )
    for out, cache_t, sc_t in runs.values():
        np.testing.assert_array_equal(_bytes(cache_t), _bytes(cache_j))
        if sc_t is not None:
            np.testing.assert_array_equal(_bytes(sc_t), _bytes(np.asarray(sc_j)[..., :2]))
        np.testing.assert_allclose(out[:n], np.asarray(out_j)[:n], atol=ATOL, rtol=ATOL)


# -------------------------------------------------------------------- model
LOGIT_TOL = {"int8": 1e-3, "fp8": 2e-2}


def _assert_one_step_apart(got, want, what):
    """Equal bytes, except in at most 1% of the values, each one int8 step,
    one e4m3 code or one bf16 ulp apart (same sign)."""
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == np.int8:
        step = np.abs(got.astype(np.int32) - want.astype(np.int32))
    else:  # e4m3 or bf16: sign bit, then magnitude codes in order
        bits = 8 * got.dtype.itemsize
        uint = np.uint8 if bits == 8 else np.uint16
        a, b = (np.ascontiguousarray(x).view(uint).astype(np.int32) for x in (got, want))
        sign = 1 << (bits - 1)
        step = np.where((a & sign) == (b & sign), np.abs(a - b), 1 << 30)
    assert step.max() <= 1, f"{what}: values {step.max()} steps apart"
    assert (step > 0).mean() <= 0.01, f"{what}: {(step > 0).sum()} of {step.size} differ"


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_model_logits_caches_and_scales_match_jax(kv_dtype):
    """Prefill, decode, then a mixed step through the port's ``Llama`` and
    JAX's on ``tiny_trained`` with a 1-byte cache (tolerances above)."""
    from atoma_infer_tpu.models.llama import Llama as JaxLlama
    from atoma_infer_tpu.models.weights import load_hf_config, load_llama_params
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import load_hf_config as port_cfg
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    jcfg = load_hf_config(FIXTURE)
    jmodel = JaxLlama(jcfg, dtype=jnp.float32)
    jparams = load_llama_params(FIXTURE, jcfg, dtype=jnp.float32)
    model = Llama(port_cfg(FIXTURE), dtype=torch.float32, device="cpu")
    params = params_from_numpy(jparams)
    L = jcfg.num_layers
    jdt, tdt = (jnp.int8, torch.int8) if kv_dtype == "int8" else (jnp.float8_e4m3fn, torch.float8_e4m3fn)
    shape = jmodel.kv_cache_shape(16, 16)[1:]
    jcache = tuple(jnp.zeros(shape, jdt) for _ in range(L))
    tcache = model.alloc_kv_cache(16, 16, dtype=tdt)
    jscales = tscales = None
    if kv_dtype == "int8":
        jscales = tuple(jkv.alloc_kv_scales(16, 16) for _ in range(L))
        tscales = [pkv.alloc_kv_scales(16, 16) for _ in range(L)]

    rng = np.random.default_rng(4)
    stream = [rng.integers(2, 1024, size=48).astype(np.int32) for _ in range(2)]
    tables = [[3, 9, 1], [12, 0, 7]]
    # A prefill, a decode step, then a mixed chunk + decode step.
    for seq_lens, q_lens in (((21, 30), (21, 30)), ((22, 31), (1, 1)), ((40, 32), (18, 1))):
        case, positions, toks = model_step(seq_lens, q_lens, tables, stream)
        out = jmodel.forward(
            jparams, jnp.asarray(toks), jnp.asarray(positions), jcache, jax_meta(case),
            kv_scales=jscales,
        )
        hidden_j, jcache = out[0], out[1]
        if jscales is not None:
            jscales = out[2]
        logits_j = np.asarray(jmodel.compute_logits(jparams, hidden_j))
        hidden_t = model.forward(
            params, torch.from_numpy(toks), torch.from_numpy(positions), tcache,
            torch_meta(case), kv_scales=tscales,
        )
        logits_t = model.compute_logits(params, hidden_t).numpy()
        n = int(case["query_start_loc"][-1])
        tol = LOGIT_TOL[kv_dtype]
        np.testing.assert_allclose(logits_t[:n], logits_j[:n], atol=tol, rtol=tol)
        for layer in range(L):
            _assert_one_step_apart(tcache[layer], jcache[layer], f"layer {layer} cache")
            if tscales is not None:
                _assert_one_step_apart(
                    tscales[layer], np.asarray(jscales[layer])[..., :2], f"layer {layer} scales"
                )


# ----------------------------------------------------------------- services
PROMPTS = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]
SERVICE_CASES = {
    # name: (kv_cache_dtype, weight quantization, device blocks, best_of,
    #        expect swap, expect preemption)
    "int8": ("int8", None, 128, 1, False, False),
    "int8_recompute": ("int8", None, 5, 1, False, True),
    "int8_swap": ("int8", None, 12, 2, True, True),
    "int8_weights_int8": ("int8", "int8", 128, 1, False, False),
    "int8_weights_int8_swap": ("int8", "int8", 12, 2, True, True),
    "fp8": ("fp8", None, 128, 1, False, False),
    "fp8_recompute": ("fp8", None, 5, 1, False, True),
    "fp8_swap": ("fp8", None, 12, 2, True, True),
    "fp8_weights_int8": ("fp8", "int8", 128, 1, False, False),
}


def _serve(pkg, kv_dtype, quantization, blocks, best_of, max_new=16):
    """``LlmService.start`` from ``tiny_trained``'s directory with a KV
    dtype; returns (greedy tokens, swapped-out blocks, preemptions, free
    blocks at the end)."""
    cfg = importlib.import_module(f"{pkg}.config")
    types = importlib.import_module(f"{pkg}.types")
    metrics = importlib.import_module(f"{pkg}.server.metrics")
    service_mod = importlib.import_module(f"{pkg}.engine.llm_service")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(
            model_name=FIXTURE, dtype="float32", quantization=quantization,
            kv_cache_dtype=kv_dtype,
        ),
        cache=cfg.CacheConfig(
            block_size=16, num_device_blocks_override=blocks, num_host_blocks_override=64
        ),
        scheduler=cfg.SchedulerConfig(
            max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
            use_native_core=False,
        ),
        validation=cfg.ValidationConfig(
            best_of=best_of, max_input_tokens=128, max_total_tokens=256
        ),
    )
    kw = dict(device="cpu") if pkg == PORT else {}
    service = service_mod.LlmService.start(config, model_dir=FIXTURE, **kw)
    ce = service.engine.worker.cache_engine
    swapped = []
    swap_out = ce.swap_out

    def spy(mapping):
        swapped.append(len(mapping))
        return swap_out(mapping)

    ce.swap_out = spy
    preempt0 = metrics.PREEMPTIONS.value

    async def scenario():
        task = asyncio.create_task(service.engine.run())
        futs = []
        for i, prompt in enumerate(PROMPTS):
            params = dict(max_new_tokens=max_new)
            if best_of > 1:
                # Greedy 2-sequence groups: the kind the scheduler swaps.
                params.update(best_of=best_of, do_sample=True, top_k=1, seed=i)
            futs.append(await service.handle_request(types.GenerateRequest(
                request_id=f"kv-{i}", inputs=prompt,
                parameters=types.GenerateParameters(**params),
            )))
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
        service.stop()
        task.cancel()
        return results

    results = asyncio.run(scenario())
    free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
    tokens = [[tuple(o.token_ids) for o in r.outputs] for r in results]
    return tokens, sum(swapped), metrics.PREEMPTIONS.value - preempt0, free, ce


@pytest.mark.parametrize("name", sorted(SERVICE_CASES))
def test_service_greedy_tokens_match_jax(name):
    kv_dtype, quantization, blocks, best_of, want_swap, want_preempt = SERVICE_CASES[name]
    want, j_swap, j_pre, j_free, jce = _serve(JAX, kv_dtype, quantization, blocks, best_of)
    got, p_swap, p_pre, p_free, pce = _serve(PORT, kv_dtype, quantization, blocks, best_of)
    assert got == want
    assert all(len(t) > 0 for r in got for t in r)
    assert p_free == j_free == blocks, "every block returns to the pool"
    assert (p_swap > 0) == (j_swap > 0) == want_swap
    assert (p_pre > 0) == (j_pre > 0) == want_preempt
    want_dtype = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
    assert pce.dtype == want_dtype and pce.quantized == (kv_dtype == "int8")
    assert jce.quantized == pce.quantized


# ------------------------------------------------------------- cache engine
@pytest.mark.parametrize("dtype", [torch.int8, torch.float8_e4m3fn])
def test_swap_and_copy_are_bit_exact(dtype):
    from atoma_infer_tpu_torch.engine.cache_engine import CacheEngine

    ce = CacheEngine(
        num_layers=2, num_kv_heads=2, head_dim=8, block_size=4,
        num_device_blocks=6, num_host_blocks=4, dtype=dtype, device="cpu",
    )
    assert ce.quantized == (dtype == torch.int8)
    assert ce.host_cache.dtype == dtype
    gen = torch.Generator().manual_seed(0)
    tiers = [ce.kv_cache] + ([ce.kv_scales] if ce.quantized else [])
    for layers in tiers:
        for t in layers:
            raw = t.view(torch.uint8)
            raw.copy_(torch.randint(0, 256, raw.shape, generator=gen, dtype=torch.uint8))
    before = [[t.clone() for t in layers] for layers in tiers]

    def same(a, b):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    ce.execute([], [(1, 0), (4, 3)], [])
    for layers in tiers:
        for t in layers:
            t.zero_()
    ce.execute([(0, 5), (3, 2)], [], [])
    for layers, old in zip(tiers, before):
        for t, b in zip(layers, old):
            assert same(t[5], b[1]) and same(t[2], b[4])
    ce.execute([], [], [(5, 0)])
    for layers, old in zip(tiers, before):
        for t, b in zip(layers, old):
            assert same(t[0], b[1])


@pytest.mark.parametrize(
    "kv_cache_dtype, cache_dtype", [(None, torch.bfloat16), ("int8", torch.int8), ("fp8", torch.float8_e4m3fn)]
)
def test_block_bytes_count_what_the_cache_engine_allocates(kv_cache_dtype, cache_dtype):
    from atoma_infer_tpu_torch.config import CacheConfig, ModelConfig
    from atoma_infer_tpu_torch.engine.cache_engine import CacheEngine

    L, hk, d, bs, blocks = 3, 2, 16, 8, 5
    model = ModelConfig(dtype="bfloat16", kv_cache_dtype=kv_cache_dtype)
    cache = CacheConfig(block_size=bs)
    per_block = cache.block_bytes(L, hk, d, model.kv_dtype_size, scale_pages=kv_cache_dtype == "int8")
    ce = CacheEngine(
        num_layers=L, num_kv_heads=hk, head_dim=d, block_size=bs,
        num_device_blocks=blocks, num_host_blocks=0, dtype=cache_dtype, device="cpu",
    )
    allocated = sum(t.numel() * t.element_size() for t in ce.kv_cache + (ce.kv_scales or []))
    assert allocated == blocks * per_block
    # The pool the profile sizes from a memory budget uses the same bytes.
    cache.num_host_blocks = 0
    cache.profile(L, hk, d, model.kv_dtype_size, scale_pages=kv_cache_dtype == "int8")
    assert cache.num_device_blocks == 512  # no device: the fixed CPU pool


# ------------------------------------------------------ kernel wrappers' checks
def _wrapper_inputs(kv_dtype, change):
    """Valid decode-step inputs for a 1-byte cache, with one thing changed;
    on the CPU the last check to fail is the device check."""
    case = quantized_case(np.random.default_rng(30), [(1, 20), (1, 9)], kv_dtype)
    t = {k: to_torch(case[k]) for k in ("q", "kv_cache", "k_new", "v_new")}
    scales = to_torch(case["kv_scales"]) if kv_dtype == "int8" else None
    if change == "missing_scales":
        scales = None
    elif change == "stray_scales":
        scales = pkv.alloc_kv_scales(*t["kv_cache"].shape[:2])
    elif change == "scales_shape":
        scales = torch.zeros(t["kv_cache"].shape[:2] + (128,), dtype=torch.bfloat16)
    elif change == "cache_dtype":
        t["kv_cache"] = t["kv_cache"].view(torch.uint8)
    return t, scales, torch_meta(case)


@pytest.mark.parametrize(
    "kv_dtype, change, message",
    [
        ("int8", "cpu", "CUDA device"),
        ("int8", "missing_scales", "kv_scales come with an int8 cache"),
        ("int8", "scales_shape", r"bfloat16 \[pages, block_size, 2\]"),
        ("int8", "cache_dtype", "must have q's dtype"),
        ("fp8", "cpu", "CUDA device"),
        ("fp8", "stray_scales", "kv_scales come with an int8 cache"),
        ("fp8", "cache_dtype", "must have q's dtype"),
    ],
)
def test_attention_wrappers_reject_what_the_kernels_do_not_take(kv_dtype, change, message):
    from atoma_infer_tpu_torch.ops.paged_attention import (
        ragged_paged_attention_cuda,
        ragged_paged_attention_fused_cuda,
    )

    t, scales, meta = _wrapper_inputs(kv_dtype, change)
    with pytest.raises(ValueError, match=message):
        ragged_paged_attention_cuda(t["q"], t["kv_cache"], meta, scale=0.2, kv_scales=scales)
    with pytest.raises(ValueError, match=message):
        ragged_paged_attention_fused_cuda(
            t["q"], t["kv_cache"], t["k_new"], t["v_new"], meta, scale=0.2, kv_scales=scales
        )


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_write_wrappers_raise_without_a_card(kv_dtype):
    from atoma_infer_tpu_torch.ops.kv_write import write_kv_cache_cuda, write_kv_cache_quant_cuda

    t, scales, meta = _wrapper_inputs(kv_dtype, "cpu")
    if kv_dtype == "int8":
        with pytest.raises(ValueError, match="CUDA device"):
            write_kv_cache_quant_cuda(t["kv_cache"], scales, t["k_new"], t["v_new"], meta.slot_mapping)
    with pytest.raises(ValueError, match="CUDA device"):
        write_kv_cache_cuda(t["kv_cache"], t["k_new"], t["v_new"], meta.slot_mapping)
