"""The port's weight quantization and quantized matmuls vs the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- quantized weights, scales, unpacking and dequantization: byte for byte;
- the plain quantized matmul in f32 against JAX's XLA branch: rtol 1e-5 of
  the output's largest value (the same f32 arithmetic summed in another
  order);
- bf16 against JAX's Pallas kernel in interpret mode: one bf16 ulp of the
  output (rtol 2^-7), since both accumulate in f32 and round once;
- W8A8: the quantized activations exactly; outputs rtol 1e-5 in f32, and two
  bf16 ulps (rtol 2^-6) in bf16, where JAX rounds the kernel output to bf16
  before the token scale and the port rounds once;
- model logits atol/rtol 1e-4, as ``tests/test_torch_model.py``;
- services: greedy tokens identical.
"""

import asyncio
import dataclasses
import importlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FIXTURE_TINY_TRAINED as FIXTURE
from torch_parity import jax_meta, model_step, torch_meta

from atoma_infer_tpu.ops import quant as jquant
from atoma_infer_tpu_torch.ops import quant, quant_kernels

torch.set_num_threads(2)

JAX, PORT = "atoma_infer_tpu", "atoma_infer_tpu_torch"


def _np_q(q):
    """qweight and scales of either package as numpy (scales as raw bits)."""
    if isinstance(q.qweight, torch.Tensor):
        return q.qweight.numpy(), q.scales.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(q.qweight), np.asarray(q.scales).view(np.uint16)


def _assert_same_bytes(jq, pq):
    jw, js = _np_q(jq)
    pw, ps = _np_q(pq)
    assert (jq.bits, jq.group_size) == (pq.bits, pq.group_size)
    assert jw.dtype == pw.dtype == np.int8 and jw.shape == pw.shape
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(ps, js)


# ---------------------------------------------------------------- (a), (b)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape, group", [((256, 384), 128), ((512, 96), 128), ((100, 64), 128),
                                          ((256, 128), 256)])
def test_quantize_weight_is_byte_identical(bits, shape, group):
    w = np.random.default_rng(sum(shape) + bits).standard_normal(shape).astype(np.float32)
    jq = jquant.quantize_weight(jnp.asarray(w), bits, group)
    pq = quant.quantize_weight(torch.from_numpy(w), bits, group)
    _assert_same_bytes(jq, pq)
    assert (pq.in_dim, pq.out_dim) == (jq.in_dim, jq.out_dim)
    if shape[0] % group:
        assert pq.group_size == shape[0]  # degenerate: one group


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_stacked_weight_matches_jax_vmap(bits):
    w = np.random.default_rng(7).standard_normal((3, 256, 160)).astype(np.float32) * 0.05
    jq = jax.vmap(lambda a: jquant.quantize_weight(a, bits))(jnp.asarray(w))
    pq = quant.quantize_weight(torch.from_numpy(w), bits)
    _assert_same_bytes(jq, pq)
    for i in range(3):  # layer views are the per-layer weights
        one = quant.quantize_weight(torch.from_numpy(w[i]), bits)
        assert torch.equal(pq.layer(i).qweight, one.qweight)
        assert torch.equal(pq.layer(i).scales, one.scales)


@pytest.mark.parametrize("bits", [8, 4])
def test_unpack_and_dequantize_equal_jax(bits):
    w = np.random.default_rng(3).standard_normal((2, 384, 64)).astype(np.float32)
    jq = jax.vmap(lambda a: jquant.quantize_weight(a, bits))(jnp.asarray(w))
    pq = quant.quantize_weight(torch.from_numpy(w), bits)
    if bits == 4:
        np.testing.assert_array_equal(
            quant._unpack_int4(pq.qweight, 128).numpy(),
            np.asarray(jquant._unpack_int4(jq.qweight, 128)),
        )
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jquant.dequantize_weight(jq, jdt).astype(jnp.float32))
        got = quant.dequantize_weight(pq, tdt).float().numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------- (c)
def _case(bits, K, N, group, M, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jq = jquant.quantize_weight(jnp.asarray(w), bits, group)
    pq = quant.quantize_weight(torch.from_numpy(w), bits, group)
    return x, jq, pq


def _close(got, want, rtol):
    """|got − want| ≤ rtol · max|want| elementwise and rtol · |want| + 1e-6·max."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale * 0.5 + 1e-6 * scale)


@pytest.mark.parametrize("M", [1, 16, 300])
@pytest.mark.parametrize("bits, group", [(8, 128), (4, 128), (8, 256)])
def test_plain_matmul_f32_matches_xla_branch(bits, group, M):
    x, jq, pq = _case(bits, 256, 384, group, M, seed=M + bits)
    want = np.asarray(jquant.quantized_matmul(jnp.asarray(x), jq))
    got = quant.quantized_matmul(torch.from_numpy(x), pq)
    assert got.dtype == torch.float32 and got.shape == (M, 384)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("M", [1, 16, 300])
@pytest.mark.parametrize("bits, group", [(8, 128), (4, 128), (8, 256), (4, 256)])
def test_plain_matmul_bf16_matches_pallas_interpret(bits, group, M):
    from jax.experimental.pallas import tpu as pltpu

    from atoma_infer_tpu.ops.quant_kernels import quantized_matmul_pallas

    x, jq, pq = _case(bits, 256, 256, group, M, seed=10 * M + bits)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = quantized_matmul_pallas(xb, jq.qweight, jq.scales, bits=bits, group_size=jq.group_size)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = quant.quantized_matmul(xt, pq)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 2.0**-7)


# ---------------------------------------------------------------------- (d)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_w8a8_matches_pallas_interpret(monkeypatch, bits, dtype):
    from atoma_infer_tpu.ops import quant_kernels as jkernels

    x, jq, pq = _case(bits, 256, 256, 128, 16, seed=bits)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)

    # The JAX package's activation quantization (quant_kernels.py:294-297).
    xf = xj.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=1, keepdims=True)
    j_scale = jnp.maximum(amax, 1e-8) / 127.0
    j_xq = jnp.clip(jnp.round(xf / j_scale), -127.0, 127.0).astype(jnp.int8)
    p_xq, p_scale = quant_kernels.quantize_activations(xt)
    np.testing.assert_array_equal(p_xq.numpy(), np.asarray(j_xq))
    np.testing.assert_array_equal(p_scale.numpy(), np.asarray(j_scale))

    monkeypatch.setattr(jkernels, "_W8A8", False)
    base = jkernels.quantized_matmul_pallas(
        xj, jq.qweight, jq.scales, bits=bits, group_size=128, interpret=True)
    monkeypatch.setattr(jkernels, "_W8A8", True)
    want = jkernels.quantized_matmul_pallas(
        xj, jq.qweight, jq.scales, bits=bits, group_size=128, interpret=True)
    monkeypatch.setattr(quant_kernels, "_W8A8", True)
    got = quant.quantized_matmul(xt, pq)
    assert got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           1e-5 if dtype == "float32" else 2.0**-6)
    # It really quantized the activations.
    assert not np.array_equal(np.asarray(want), np.asarray(base))
    monkeypatch.setattr(quant_kernels, "_W8A8", False)
    assert not torch.equal(quant.quantized_matmul(xt, pq), got)


def test_w8a8_plain_group_dots_are_exact():
    rng = np.random.default_rng(11)
    for bits in (8, 4):
        w = rng.standard_normal((512, 64)).astype(np.float32)
        pq = quant.quantize_weight(torch.from_numpy(w), bits, 512)
        xq = torch.from_numpy(rng.integers(-127, 128, size=(5, 512)).astype(np.int8))
        q = quant._unpack_int4(pq.qweight, 512) if bits == 4 else pq.qweight
        got = quant_kernels.w8a8_matmul_plain(
            xq, pq.qweight, torch.ones_like(pq.scales), torch.ones(5, 1), bits=bits,
            group_size=512, out_dtype=torch.float32,
        )
        want = xq.numpy().astype(np.int64) @ q.numpy().astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# ------------------------------------------------------------- CUDA wrappers
@pytest.mark.parametrize(
    "change, message",
    [
        ("x_dtype", "bfloat16, float16 or float32"),
        ("q_dtype", "int8"),
        ("group", "does not fit"),
        ("scales", "scales"),
        ("contiguous", "contiguous"),
        ("act_scale", "one scale per row"),
        ("cpu", "CUDA device"),
    ],
)
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(change, message):
    """On CPU tensors: the device is checked last, so each other fault is
    reported by name, and untouched CPU inputs fail the device check."""
    from atoma_infer_tpu_torch.ops.quant_kernels import quantized_matmul_cuda, w8a8_matmul_cuda

    _, _, pq = _case(8, 256, 128, 128, 4, seed=1)
    x, xq, act = torch.zeros(4, 256), torch.zeros(4, 256, dtype=torch.int8), torch.ones(4, 1)
    q, s = pq.qweight, pq.scales
    if change == "x_dtype":
        x = x.double()
    elif change == "q_dtype":
        q = q.to(torch.int16)
    elif change == "group":
        q = q[:200]
    elif change == "scales":
        s = s[:, :64]
    elif change == "contiguous":
        q = torch.zeros(128, 256, dtype=torch.int8).t()
    elif change == "act_scale":
        act = torch.ones(3, 1)
    if change != "act_scale":
        with pytest.raises(ValueError, match=message):
            quantized_matmul_cuda(x, q, s, bits=8, group_size=128)
    if change != "x_dtype":
        with pytest.raises(ValueError, match=message):
            w8a8_matmul_cuda(xq, q, s, act, bits=8, group_size=128, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("bits, group, message", [(8, 6, "multiple of 4"), (4, 12, "multiple of 8")])
def test_w8a8_wrapper_rejects_group_sizes_the_integer_dots_do_not_take(bits, group, message):
    pq = quant.quantize_weight(torch.randn(48, 16), bits, group)
    with pytest.raises(ValueError, match=message):
        quant_kernels.w8a8_matmul_cuda(
            torch.zeros(2, 48, dtype=torch.int8), pq.qweight, pq.scales, torch.ones(2, 1),
            bits=bits, group_size=group, out_dtype=torch.float32,
        )


@pytest.mark.parametrize(
    "M, N, groups, vec, want",
    [
        (8, 4096, 32, 8, (4, 2, 4, 8)),      # q/o at decode: rows split, K 8 ways
        (8, 1024, 32, 8, (4, 2, 2, 16)),     # k/v at decode
        (8, 14336, 32, 8, (1, 8, 16, 2)),    # gate/up at decode: enough chains
        (8, 4096, 112, 8, (1, 8, 16, 7)),    # down_proj at decode
        (8, 128256, 1, 8, (4, 1, 1, 1)),     # per-channel LM head: one group
        (64, 1024, 32, 8, (1, 8, 8, 4)),
        (256, 14336, 32, 8, (1, 8, 32, 1)),  # prefill: grid already full
        (3, 250, 2, 1, (4, 2, 2, 1)),        # ragged N, two groups
    ],
)
def test_launch_plan(M, N, groups, vec, want):
    rsplit, ks, gps, splits = quant_kernels.plan(M, N, groups, vec)
    assert (rsplit, ks, gps, splits) == want
    assert splits == -(-groups // gps) and gps % ks == 0


# ------------------------------------------------------------- (e), (f), (g)
def _untied_checkpoint(tmp_path):
    """tiny_trained with an untied LM head, written with safetensors."""
    from safetensors.numpy import load_file, save_file

    tensors = load_file(os.path.join(FIXTURE, "model.safetensors"))
    cfg = json.load(open(os.path.join(FIXTURE, "config.json")))
    cfg["tie_word_embeddings"] = False
    rng = np.random.default_rng(21)
    tensors["lm_head.weight"] = (
        rng.standard_normal((cfg["vocab_size"], cfg["hidden_size"])) * 0.05
    ).astype(np.float32)
    out = tmp_path / "tiny_untied"
    out.mkdir()
    save_file(tensors, str(out / "model.safetensors"))
    json.dump(cfg, open(out / "config.json", "w"))
    shutil.copy(os.path.join(FIXTURE, "tokenizer.json"), out / "tokenizer.json")
    return str(out)


def _load_both(model_dir, quantization):
    from atoma_infer_tpu.models.weights import load_hf_config as jcfg_load
    from atoma_infer_tpu.models.weights import load_llama_params as jload
    from atoma_infer_tpu_torch.models.weights import load_hf_config, load_llama_params

    jcfg = jcfg_load(model_dir)
    jparams = jload(model_dir, jcfg, dtype=jnp.float32, quantization=quantization)
    cfg = load_hf_config(model_dir)
    params = load_llama_params(model_dir, cfg, dtype=torch.float32, device="cpu",
                               quantization=quantization)
    return jcfg, jparams, cfg, params


def _assert_params_equal(jparams, params):
    assert set(jparams) == set(params) and set(jparams["layers"]) == set(params["layers"])
    for key, value in params["layers"].items():
        if isinstance(value, quant.QuantizedTensor):
            _assert_same_bytes(jparams["layers"][key], value)
        else:
            np.testing.assert_array_equal(value.numpy(), np.asarray(jparams["layers"][key]))
    for key in set(params) - {"layers"}:
        if isinstance(params[key], quant.QuantizedTensor):
            _assert_same_bytes(jparams[key], params[key])
        else:
            np.testing.assert_array_equal(params[key].numpy(), np.asarray(jparams[key]))


@pytest.mark.parametrize("quantization", ["int8", "int4"])
@pytest.mark.parametrize("untied", [False, True])
def test_quantize_on_load_gives_jax_bytes(tmp_path, quantization, untied):
    model_dir = _untied_checkpoint(tmp_path) if untied else FIXTURE
    _, jparams, cfg, params = _load_both(model_dir, quantization)
    _assert_params_equal(jparams, params)
    layers = params["layers"]
    assert isinstance(layers["down_proj"], quant.QuantizedTensor)
    assert layers["down_proj"].bits == (8 if quantization == "int8" else 4)
    assert layers["down_proj"].qweight.shape[0] == cfg.num_layers
    assert layers["input_norm"].dtype == torch.float32
    if untied:
        head = params["lm_head"]
        assert (head.bits, head.group_size, tuple(head.scales.shape)) == (
            8, cfg.hidden_size, (1, cfg.vocab_size))
    else:
        assert "lm_head" not in params


def test_params_from_numpy_keeps_int8_and_bf16(tmp_path):
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    _, jparams, _, own = _load_both(_untied_checkpoint(tmp_path), "int4")
    params = params_from_numpy(jparams, torch.bfloat16)
    for q in (params["layers"]["q_proj"], params["lm_head"]):
        assert q.qweight.dtype == torch.int8 and q.scales.dtype == torch.bfloat16
    assert params["layers"]["input_norm"].dtype == torch.bfloat16
    _assert_params_equal(jparams, params_from_numpy(jparams))
    assert torch.equal(params["lm_head"].scales, own["lm_head"].scales)


@pytest.mark.parametrize("quantization", ["int8", "int4"])
@pytest.mark.parametrize("untied", [False, True])
def test_quantized_logits_match_jax(tmp_path, quantization, untied):
    from atoma_infer_tpu.models.llama import Llama as JaxLlama
    from atoma_infer_tpu_torch.models.llama import Llama

    model_dir = _untied_checkpoint(tmp_path) if untied else FIXTURE
    jcfg, jparams, cfg, params = _load_both(model_dir, quantization)
    jmodel = JaxLlama(jcfg, dtype=jnp.float32)
    model = Llama(cfg, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    stream = [rng.integers(2, 1024, size=48).astype(np.int32) for _ in range(2)]
    tables = [[3, 9, 1], [12, 0, 7]]
    jcache = jnp.zeros(jmodel.kv_cache_shape(16, 16), jnp.float32)
    tcache = model.alloc_kv_cache(16, 16)
    for seq_lens, q_lens in (((21, 30), (21, 30)), ((22, 31), (1, 1)), ((40, 32), (18, 1))):
        case, positions, toks = model_step(seq_lens, q_lens, tables, stream)
        hidden_j, jcache = jmodel.forward(
            jparams, jnp.asarray(toks), jnp.asarray(positions), jcache, jax_meta(case))
        logits_j = np.asarray(jmodel.compute_logits(jparams, hidden_j))
        hidden_t = model.forward(
            params, torch.from_numpy(toks), torch.from_numpy(positions), tcache, torch_meta(case))
        logits_t = model.compute_logits(params, hidden_t)
        assert logits_t.dtype == torch.float32
        n = int(case["query_start_loc"][-1])
        np.testing.assert_allclose(logits_t.numpy()[:n], logits_j[:n], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------- (h)
PROMPTS = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]


def _serve_from_dir(pkg, quantization, blocks, prompts=PROMPTS, max_new=16):
    """``LlmService.start`` from ``tiny_trained``'s directory with weight
    quantization on load; greedy tokens, preemptions, and the free pool."""
    cfg = importlib.import_module(f"{pkg}.config")
    types = importlib.import_module(f"{pkg}.types")
    metrics = importlib.import_module(f"{pkg}.server.metrics")
    service_mod = importlib.import_module(f"{pkg}.engine.llm_service")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(model_name=FIXTURE, dtype="float32", quantization=quantization),
        cache=cfg.CacheConfig(
            block_size=16, num_device_blocks_override=blocks, num_host_blocks_override=64
        ),
        scheduler=cfg.SchedulerConfig(
            max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
            use_native_core=False,
        ),
        validation=cfg.ValidationConfig(max_input_tokens=128, max_total_tokens=256),
    )
    kw = dict(device="cpu") if pkg == PORT else {}
    service = service_mod.LlmService.start(config, model_dir=FIXTURE, **kw)
    preempt0 = metrics.PREEMPTIONS.value

    async def scenario():
        task = asyncio.create_task(service.engine.run())
        futs = [
            await service.handle_request(types.GenerateRequest(
                request_id=f"q-{i}", inputs=p,
                parameters=types.GenerateParameters(max_new_tokens=max_new),
            ))
            for i, p in enumerate(prompts)
        ]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
        service.stop()
        task.cancel()
        return results

    results = asyncio.run(scenario())
    free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
    tokens = [tuple(r.outputs[0].token_ids) for r in results]
    return tokens, metrics.PREEMPTIONS.value - preempt0, free


@pytest.mark.parametrize("quantization", ["int8", "int4"])
@pytest.mark.parametrize("blocks", [128, 5])
def test_quantized_service_greedy_tokens_match_jax(quantization, blocks):
    want, j_pre, j_free = _serve_from_dir(JAX, quantization, blocks)
    got, p_pre, p_free = _serve_from_dir(PORT, quantization, blocks)
    assert got == want
    assert j_free == p_free == blocks, "every block returns to the pool"
    assert all(len(t) > 0 for t in got)
    # The tight pool preempts by recompute on both sides; the wide one never.
    assert (p_pre > 0) == (j_pre > 0) == (blocks == 5)


def test_quantized_model_params_are_views_per_layer():
    from atoma_infer_tpu_torch.models.llama import _layer_params

    w = torch.randn(2, 256, 64)
    layers = {"q_proj": quant.quantize_weight(w, 4), "input_norm": torch.ones(2, 256)}
    lp = _layer_params(layers, 1)
    assert lp["q_proj"].qweight.data_ptr() == layers["q_proj"].qweight[1].data_ptr()
    assert dataclasses.replace(lp["q_proj"]).bits == 4
    assert lp["input_norm"].shape == (256,)
