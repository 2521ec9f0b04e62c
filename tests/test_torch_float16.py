"""float16 in the port, against the JAX package in float16.

The plain versions of kernels A–H (and the merge of split rows) take fp16
tensors on the CPU, as the fp16 instantiations take them on the card, and
are held here against the JAX package on the same numpy inputs. JAX serves
fp16 attention through XLA, not Pallas (its ``ops/attention.py:100-119``
admits bf16, f32, int8 and e4m3 caches only), so the attention oracle is
its XLA branch (``ops/reference.py``), which computes in f32 and rounds the
output to fp16 once, as the plain versions do. Tolerances:

- writes (C; the INT8 and e4m3 writes from fp16 rows, D's and E's): byte
  for byte, scales too;
- attention (A, B, D, E) and the merge: atol = rtol = 2^-10, two fp16 ulps
  (the same f32 arithmetic in another order, one rounding to fp16 on each
  side); bf16's parity tests take 2e-2;
- F and G against JAX's XLA branch (f32 operands, one rounding): 2^-10 of
  the output's largest value; H against JAX's W8A8 Pallas kernel in
  interpret mode: 2^-9, since JAX rounds the kernel's output to fp16 before
  the token scale and the port rounds once;
- the Llama model on ``tiny_trained`` cast to fp16: logits within 0.05 of
  JAX's fp16 model, caches within four fp16 ulps (fp16 products and sums
  on both sides, rounded at different places through 4 layers); the
  service: greedy tokens identical to JAX's fp16 ``LlmService``.

Also the routes the fp16 kernels take on the card (by shape, without a
card): the tensor-core instantiations ``*_f16``, at the bf16 head dims, and
a refusal where the tensor cores do not take the shape.
"""

import asyncio
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FIXTURE_TINY_TRAINED as FIXTURE
from torch_parity import jax_meta, ragged_case, torch_meta, valid_rows

from atoma_infer_tpu.ops import kv_cache as jkv
from atoma_infer_tpu.ops import quant as jquant
from atoma_infer_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from atoma_infer_tpu.ops.reference import (
    ragged_paged_attention_xla,
    ragged_paged_attention_xla_partial,
)
from atoma_infer_tpu_torch.ops import kv_cache as pkv
from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops import quant, quant_kernels as qk
from atoma_infer_tpu_torch.ops.attention import alibi_slopes

torch.set_num_threads(2)

TOL = 2.0**-10
F16 = np.float16


def _f16(a):
    """numpy f32 values rounded to fp16, as a JAX array and a CPU tensor."""
    h = np.asarray(a, np.float32).astype(F16)
    return jnp.asarray(h), torch.from_numpy(h.copy())


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return t.view(torch.uint8).numpy() if t.element_size() == 1 else \
            t.view(torch.int16).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _jax_attention(case, q, cache, *, k_scale=None, v_scale=None, **kw):
    D, Hk = case["q"].shape[2], case["k_new"].shape[1]
    meta = jax_meta(case)
    k_view, v_view = jkv.kv_cache_view(cache, Hk, D)
    return np.asarray(ragged_paged_attention_xla(
        q, k_view, v_view, meta.block_tables, meta.seq_lens, meta.query_start_loc,
        scale=D ** -0.5, block_size=meta.block_size, k_scale=k_scale, v_scale=v_scale, **kw))


ATTN_CASES = {
    "causal_prefill": ([(37, 37)], {}),
    "mixed_prefill_decode": ([(24, 24), (13, 13), (1, 7), (1, 50), (1, 1)], {}),
    "chunked_continuation": ([(20, 52), (9, 30)], {}),
    "sliding_window": ([(30, 45), (1, 40)], dict(sliding_window=11)),
    "soft_cap": ([(18, 18), (1, 25)], dict(soft_cap=2.0)),
    "alibi": ([(18, 30), (1, 25)], dict(alibi=True)),
}


def _options(opts, hq):
    jax_kw, torch_kw = dict(opts), dict(opts)
    if jax_kw.pop("alibi", None):
        torch_kw.pop("alibi")
        jax_kw["alibi_slopes"] = jnp.asarray(np.asarray(jax_alibi_slopes(hq)))
        torch_kw["alibi_slopes"] = alibi_slopes(hq)
    return jax_kw, torch_kw


# ------------------------------------------------------------ A and C
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_write_and_ragged_attention_match_jax(name):
    """C (the write of fp16 rows into an fp16 cache, byte for byte) then A
    over the written cache, against JAX's XLA scatter and XLA attention in
    fp16."""
    specs, opts = ATTN_CASES[name]
    case = ragged_case(np.random.default_rng(list(ATTN_CASES).index(name)), specs)
    jax_kw, torch_kw = _options(opts, case["q"].shape[1])
    (qj, qt), (cj, ct), (kj, kt), (vj, vt) = (_f16(case[x]) for x in (
        "q", "kv_cache", "k_new", "v_new"))
    slots = case["slot_mapping"]
    cj = jkv.write_kv_cache(cj, kj, vj, jnp.asarray(slots))
    pkv.write_kv_cache(ct, kt, vt, torch.from_numpy(slots))
    np.testing.assert_array_equal(_bytes(ct), _bytes(cj))
    got = pa.ragged_paged_attention_paged_plain(qt, ct, torch_meta(case), scale=32 ** -0.5,
                                                **torch_kw)
    assert got.dtype == torch.float16
    want = _jax_attention(case, qj, cj, **jax_kw)
    n = valid_rows(case)
    np.testing.assert_allclose(got.float().numpy()[:n], want[:n].astype(np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [None, 24])
def test_fused_decode_matches_jax(window):
    """B: the write, then attention over the cache holding it, against
    JAX's XLA scatter and XLA attention (JAX's fused kernel takes no fp16)."""
    specs = [(1, kv) for kv in (1, 5, 16, 17, 64, 33)]
    case = ragged_case(np.random.default_rng(20), specs, pad_seqs_to=8)
    meta = dataclasses.replace(torch_meta(case), decode_only=True)
    (qj, qt), (cj, ct), (kj, kt), (vj, vt) = (_f16(case[x]) for x in (
        "q", "kv_cache", "k_new", "v_new"))
    got = pa.fused_decode_attention_plain(qt, ct, kt, vt, meta, scale=32 ** -0.5,
                                          sliding_window=window)
    cj = jkv.write_kv_cache(cj, kj, vj, jnp.asarray(case["slot_mapping"]))
    np.testing.assert_array_equal(_bytes(ct), _bytes(cj))
    want = _jax_attention(case, qj, cj, sliding_window=window)
    n = valid_rows(case)
    np.testing.assert_allclose(got.float().numpy()[:n], want[:n].astype(np.float32),
                               atol=TOL, rtol=TOL)


# ------------------------------------------------------------ D and E
@pytest.mark.parametrize("fused", [False, True], ids=["ragged", "fused"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_one_byte_caches_from_fp16_rows_match_jax(kv, fused):
    """D and E with fp16 queries: the INT8 write (scales from the fp16
    rows' absmax) and the e4m3 write, byte for byte with JAX's, then the
    ragged (mixed batch) or fused (decode batch) attention over the
    written cache against JAX's XLA attention over the same bytes."""
    specs = ([(1, kv_len) for kv_len in (3, 17, 40, 64)] if fused
             else [(24, 24), (1, 30), (9, 41)])
    case = ragged_case(np.random.default_rng(5 + fused), specs, pad_seqs_to=8 if fused else None)
    (qj, qt), (kj, kt), (vj, vt) = (_f16(case[x]) for x in ("q", "k_new", "v_new"))
    nb, bs, row = case["kv_cache"].shape
    slots = case["slot_mapping"]
    meta = torch_meta(case)
    if kv == "int8":
        cj, scj = jkv.write_kv_cache_quant(jnp.zeros((nb, bs, row), jnp.int8),
                                           jkv.alloc_kv_scales(nb, bs), kj, vj,
                                           jnp.asarray(slots))
        ct, sct = torch.zeros((nb, bs, row), dtype=torch.int8), pkv.alloc_kv_scales(nb, bs)
        write = lambda: pkv.write_kv_cache_quant(ct, sct, kt, vt, torch.from_numpy(slots))  # noqa
        flat = jkv.scales_flat(scj)
        jax_scales = dict(k_scale=flat[0], v_scale=flat[1])
    else:
        cj = jkv.write_kv_cache(jnp.zeros((nb, bs, row), jnp.float8_e4m3fn), kj, vj,
                                jnp.asarray(slots))
        ct, sct = torch.zeros((nb, bs, row), dtype=torch.float8_e4m3fn), None
        write = lambda: pkv.write_kv_cache(ct, kt, vt, torch.from_numpy(slots))  # noqa
        jax_scales = {}
    if fused:
        got = pa.fused_decode_attention_plain(qt, ct, kt, vt, meta, scale=32 ** -0.5,
                                              kv_scales=sct)
    else:
        write()
        got = pa.ragged_paged_attention_paged_plain(qt, ct, meta, scale=32 ** -0.5,
                                                    kv_scales=sct)
    np.testing.assert_array_equal(_bytes(ct), _bytes(cj))
    if sct is not None:
        np.testing.assert_array_equal(_bytes(sct), _bytes(np.asarray(scj)[..., :2]))
    want = _jax_attention(case, qj, cj, **jax_scales)
    n = valid_rows(case)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy()[:n], want[:n].astype(np.float32),
                               atol=TOL, rtol=TOL)


# ------------------------------------------------------------- the merge
def test_split_merge_of_jax_partials_matches_jax_attention():
    """The merge of split rows in fp16 (``split_combine_plain``, the plain
    version of ``rpa_combine_kernel``): fed JAX's XLA partials over each
    split's key range (the splits the kernels cut, ``split_key_ranges``),
    it gives JAX's whole XLA attention in fp16."""
    kvs = (70, 130, 300, 200)
    case = ragged_case(np.random.default_rng(8), [(1, k) for k in kvs], num_blocks=64)
    qj, qt = _f16(case["q"])
    cj, _ = _f16(case["kv_cache"])
    jkw = dict(scale=32 ** -0.5, block_size=16)
    meta = jax_meta(case)
    k_view, v_view = jkv.kv_cache_view(cj, 2, 32)
    splits, min_tiles = 4, 1
    T, Hq, D = case["q"].shape
    ws_o = np.zeros((splits, T, Hq, D), np.float32)
    ws_ml = np.zeros((splits, T, Hq, 2), np.float32)
    ws_ml[..., 0] = -np.inf
    P = case["block_tables"].shape[1]
    for s, kv in enumerate(kvs):
        for i, (lo, hi) in enumerate(pa.split_key_ranges(kv - 1, None, splits, min_tiles)):
            pages = np.zeros((len(kvs), P), bool)
            pages[s, lo // 16:-(-hi // 16)] = True
            num, m, l = (np.asarray(x) for x in ragged_paged_attention_xla_partial(
                qj, k_view, v_view, meta.block_tables, meta.seq_lens, meta.query_start_loc,
                page_valid=jnp.asarray(pages), **jkw))
            ws_o[i, s], ws_ml[i, s, :, 0], ws_ml[i, s, :, 1] = num[s], m[s], l[s]
    out = torch.zeros((T, Hq, D), dtype=torch.float16)
    got = pa.split_combine_plain(torch.from_numpy(ws_o), torch.from_numpy(ws_ml), out,
                                 torch_meta(case), bq=1, splits=splits, min_tiles=min_tiles)
    assert got.dtype == torch.float16
    want = np.asarray(ragged_paged_attention_xla(
        qj, k_view, v_view, meta.block_tables, meta.seq_lens, meta.query_start_loc, **jkw))
    rows = slice(1, len(kvs))  # the first row's 70 keys take one split: left as is
    np.testing.assert_allclose(got.float().numpy()[rows], want[rows].astype(np.float32),
                               atol=TOL, rtol=TOL)


# ------------------------------------------------------------ F, G and H
def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("M", [1, 16, 300])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_matches_jax_xla_branch(bits, M):
    """F and G's plain version on fp16 activations against JAX's XLA branch
    (f32 operands, one dot a group, scales on the f32 partials): both round
    once to fp16."""
    rng = np.random.default_rng(bits + M)
    w = (rng.standard_normal((256, 384)) * 0.05).astype(np.float32)
    xj, xt = _f16(rng.standard_normal((M, 256)))
    want = np.asarray(jquant.quantized_matmul(xj, jquant.quantize_weight(jnp.asarray(w), bits,
                                                                         128)))
    got = quant.quantized_matmul(xt, quant.quantize_weight(torch.from_numpy(w), bits, 128))
    assert got.dtype == torch.float16 and want.dtype == np.float16
    _close(got.numpy(), want, TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_w8a8_matches_jax_pallas_interpret(monkeypatch, bits):
    """H on fp16 activations: the per-token int8 activations exactly JAX's,
    the output against JAX's W8A8 Pallas kernel in interpret mode."""
    from atoma_infer_tpu.ops import quant_kernels as jkernels

    rng = np.random.default_rng(30 + bits)
    w = (rng.standard_normal((256, 256)) * 0.05).astype(np.float32)
    xj, xt = _f16(rng.standard_normal((16, 256)))
    jq = jquant.quantize_weight(jnp.asarray(w), bits, 128)
    pq = quant.quantize_weight(torch.from_numpy(w), bits, 128)
    p_xq, p_scale = qk.quantize_activations(xt)
    xf = xj.astype(jnp.float32)
    j_scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True), 1e-8) / 127.0
    np.testing.assert_array_equal(p_xq.numpy(), np.asarray(
        jnp.clip(jnp.round(xf / j_scale), -127.0, 127.0).astype(jnp.int8)))
    monkeypatch.setattr(jkernels, "_W8A8", True)
    want = jkernels.quantized_matmul_pallas(xj, jq.qweight, jq.scales, bits=bits, group_size=128,
                                            interpret=True)
    monkeypatch.setattr(qk, "_W8A8", True)
    got = quant.quantized_matmul(xt, pq)
    assert got.dtype == torch.float16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2 * TOL)


# ------------------------------------------------------------- the model
def test_llama_logits_on_tiny_trained_in_fp16_match_jax():
    """``tiny_trained`` loaded in fp16 by both packages: a prefill, a
    decode and a mixed step, logits within 0.05 (0.011-0.016 seen, at
    logits up to 15) and the fp16 caches within 1.6e-2 (four fp16 ulps at
    their largest values, 4-8: K and V are an fp16 projection and the rope
    away from hidden states that already differ in rounding)."""
    from atoma_infer_tpu.models.llama import Llama as JaxLlama
    from atoma_infer_tpu.models.weights import load_hf_config as jcfg_load
    from atoma_infer_tpu.models.weights import load_llama_params as jload
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import load_hf_config, load_llama_params

    from torch_parity import model_step

    jmodel = JaxLlama(jcfg_load(FIXTURE), dtype=jnp.float16)
    jparams = jload(FIXTURE, jmodel.config, dtype=jnp.float16)
    model = Llama(load_hf_config(FIXTURE), dtype=torch.float16, device="cpu")
    params = load_llama_params(FIXTURE, model.config, dtype=torch.float16, device="cpu")
    assert params["embed"].dtype == torch.float16
    rng = np.random.default_rng(3)
    stream = [rng.integers(3, 1000, size=48).astype(np.int32) for _ in range(2)]
    tables = [[3, 9, 1], [12, 0, 7]]
    jcache = jnp.zeros(jmodel.kv_cache_shape(16, 16), jnp.float16)
    tcache = model.alloc_kv_cache(16, 16)
    assert tcache[0].dtype == torch.float16
    for seq_lens, q_lens in (((21, 30), (21, 30)), ((22, 31), (1, 1)), ((40, 32), (18, 1))):
        case, pos, toks = model_step(seq_lens, q_lens, tables, stream)
        hj, jcache = jmodel.forward(jparams, jnp.asarray(toks), jnp.asarray(pos), jcache,
                                    jax_meta(case))
        ht = model.forward(params, torch.from_numpy(toks), torch.from_numpy(pos), tcache,
                           torch_meta(case))
        n = int(case["query_start_loc"][-1])
        want = np.asarray(jmodel.compute_logits(jparams, hj))[:n]
        got = model.compute_logits(params, ht).numpy()[:n]
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=0.05, rtol=0.05)
    got, want = torch.stack(tcache).float().numpy(), np.asarray(jcache).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=1.6e-2, rtol=1.6e-2)


PROMPTS = ["the cat sat on the mat. the cat", "hello world, this is a test", "once upon a time"]


def _serve(pkg, **kw):
    cfg = importlib.import_module(f"{pkg}.config")
    types = importlib.import_module(f"{pkg}.types")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(model_name=FIXTURE, dtype="float16"),
        cache=cfg.CacheConfig(block_size=16, num_device_blocks_override=96,
                              num_host_blocks_override=16),
        scheduler=cfg.SchedulerConfig(max_num_batched_tokens=256, max_num_sequences=8,
                                      max_model_len=256),
        validation=cfg.ValidationConfig(max_input_tokens=200, max_total_tokens=256),
    )
    service = importlib.import_module(f"{pkg}.engine.llm_service").LlmService.start(
        config, model_dir=FIXTURE, **kw)

    async def run():
        task = asyncio.create_task(service.engine.run())
        futs = [await service.handle_request(types.GenerateRequest(
            request_id=f"req-{i}", inputs=p,
            parameters=types.GenerateParameters(max_new_tokens=24, do_sample=False)))
            for i, p in enumerate(PROMPTS)]
        out = await asyncio.wait_for(asyncio.gather(*futs), timeout=180)
        service.stop()
        task.cancel()
        return {r.request_id: list(r.outputs[0].token_ids) for r in out}

    return asyncio.run(run()), service


def test_fp16_service_matches_jax_fp16_service():
    """``dtype = "float16"``: the port's service from ``tiny_trained``'s
    directory (weights loaded in fp16, an fp16 KV cache) gives JAX's fp16
    ``LlmService``'s greedy tokens."""
    want, _ = _serve("atoma_infer_tpu")
    got, service = _serve("atoma_infer_tpu_torch", device="cpu")
    assert service.engine.worker.cache_engine.kv_cache[0].dtype == torch.float16
    assert got == want


# ---------------------------------------------------- the card's routes
def _q(dtype, d=64, hq=4):
    return torch.zeros((8, hq, d), dtype=dtype)


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("kind", [None, torch.int8, torch.float8_e4m3fn], ids=["f16", "int8",
                                                                             "fp8"])
def test_fp16_kernel_shapes_are_the_bf16_routes(kind, head_dim):
    """fp16 queries take the bf16 route's head dims: every family's over an
    fp16, an INT8 and an e4m3 cache; a 1-byte cache at 96 and 256 through
    the fp16 ``*_wide`` instantiations, as bf16 through its own."""
    shape = dict(head_dim=head_dim, dtype=torch.float16, kind=kind, group=2, block_size=16)
    for fused in (False, True):
        pa.check_kernel_shape(fused=fused, **shape)
    q16 = _q(torch.float16, d=head_dim)
    wide = kind is not None and head_dim in pa.WIDE_HEAD_DIMS
    assert pa.ragged_route(q16, kind) is (pa.RAGGED_ATTENTION_MMA_WIDE_F16 if wide
                                          else pa.RAGGED_ATTENTION_MMA_F16)[kind]
    assert pa.fused_route(q16, kind) is (pa.FUSED_DECODE_SPLIT_WIDE_F16 if wide
                                         else pa.FUSED_DECODE_SPLIT_F16)[kind]


@pytest.mark.parametrize("kind", [None, torch.int8, torch.float8_e4m3fn])
def test_fp16_attention_routes(kind):
    """fp16 queries: the fp16 instantiations of the tensor-core ragged
    kernel, the split fused kernel and the merge, each with its own launch
    counter and source; bf16 and f32 keep theirs."""
    q16 = _q(torch.float16)
    suffix = {None: "", torch.int8: "_int8", torch.float8_e4m3fn: "_fp8"}[kind]
    ragged, fused = pa.ragged_route(q16, kind), pa.fused_route(q16, kind)
    assert ragged is pa.RAGGED_ATTENTION_MMA_F16[kind] and fused is pa.FUSED_DECODE_SPLIT_F16[kind]
    assert ragged.name == pa.RAGGED_ATTENTION_MMA[kind].name + "_f16"
    assert ragged.source == f"paged_attention{suffix}_f16.cu"
    assert fused.source == f"fused_decode_split{suffix}_f16.cu"
    assert ragged.symbol == f"atoma_ragged_paged_attention_mma{suffix}_f16"
    assert pa.ragged_route(_q(torch.bfloat16), kind) is pa.RAGGED_ATTENTION_MMA[kind]
    assert pa.fused_route(_q(torch.float32), kind) is pa.FUSED_DECODE[kind]
    assert pa.combine_route(q16) is pa.SPLIT_COMBINE_F16
    assert pa.combine_route(_q(torch.bfloat16)) is pa.SPLIT_COMBINE


def test_fp16_write_counters_are_their_own():
    """The fp16 writes launch the same C entries as bf16's, counted apart."""
    from atoma_infer_tpu_torch.ops import kv_write as kw

    for k in (kw.KV_WRITE, kw.KV_WRITE_FP8, kw.KV_WRITE_INT8):
        f16 = kw._by_rows(k, torch.zeros(1, dtype=torch.float16))
        assert f16 is not k and f16.symbol == k.symbol and f16.name == k.name + "_f16"
        assert kw._by_rows(k, torch.zeros(1, dtype=torch.bfloat16)) is k


class _FakeCuda:
    """An aligned fp16/int8 tensor stand-in for the route functions, which
    read only dtype, shape and data_ptr."""

    def __init__(self, t):
        self.t = t
        self.dtype, self.shape = t.dtype, t.shape

    def data_ptr(self):
        return 0

    @property
    def device(self):
        return torch.device("cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_fp16_matmul_routes(monkeypatch, bits):
    """F and G on fp16 activations take their fp16 tensor-core
    instantiation at the shapes the tensor cores take, and raise elsewhere
    (no CUDA-core fp16 kernel); H's fp16 output the int8 tensor cores'
    fp16 entry, and raises elsewhere."""
    monkeypatch.setattr(qk, "_mma_slots", lambda *a: 2 * 132)
    monkeypatch.setattr(qk, "_w8a8_mma_slots", lambda *a: 2 * 132)
    x = _FakeCuda(torch.zeros((8, 256), dtype=torch.float16))
    w = _FakeCuda(torch.zeros((256 if bits == 8 else 128, 512), dtype=torch.int8))
    s = _FakeCuda(torch.zeros((2, 512), dtype=torch.bfloat16))
    launch = qk.qmm_launch(x, w, s, bits=bits, group_size=128)
    assert launch.kernel is (qk.QMM_I8_MMA_F16 if bits == 8 else qk.QMM_I4_MMA_F16)
    assert launch.kernel.symbol == f"atoma_qmm_i{bits}_mma_f16"
    ragged = _FakeCuda(torch.zeros((256 if bits == 8 else 128, 520), dtype=torch.int8))
    with pytest.raises(ValueError, match="fp16 activations take the tensor cores only"):
        qk.qmm_launch(x, ragged, s, bits=bits, group_size=128)
    xq = _FakeCuda(torch.zeros((8, 256), dtype=torch.int8))
    h = qk.w8a8_launch(xq, w, s, bits=bits, group_size=128, out_dtype=torch.float16)
    assert h.kernel is qk.QMM_W8A8_MMA_F16 and h.kernel.symbol == qk.QMM_W8A8_MMA.symbol
    assert qk.w8a8_launch(xq, w, s, bits=bits, group_size=128).kernel is qk.QMM_W8A8_MMA
    with pytest.raises(ValueError, match="fp16 output takes the int8 tensor cores only"):
        qk.w8a8_launch(xq, ragged, s, bits=bits, group_size=128, out_dtype=torch.float16)
