"""The port's model families (Llama, Mistral, Qwen2, Phi-3, Gemma-2,
Mixtral) against the JAX package and against HF ``transformers``.

Each family is a tiny checkpoint built locally with ``transformers`` from a
seed (head_dim 16, as ``tests/test_model_families.py``; plus Phi-3 at head
dim 96 and Gemma-2 at 256, the shapes of Phi-3-mini and Gemma-2-9B) and
saved with ``save_pretrained``'s safetensors and ``config.json``, with
``tests/fixtures/tiny_trained``'s tokenizer beside them. Its weights use
``initializer_range`` 0.125 (HF's default 0.02 leaves the logits of so small
a model within a few hundredths of each other). What is held, in f32:
- both loaders give equal configs (``dataclasses.asdict``) and parameters,
  tensor for tensor (Phi-3's fused tensors split, Gemma-2's four norms,
  Qwen2's biases, Mixtral's router and experts), also with INT8 weights
  quantized on load (Qwen2, Gemma-2, Mixtral, whose router and experts stay
  dense) and with the port's ``quantize_params``;
- the JAX parameters carried into the port by ``params_from_numpy`` (any
  tree, Gemma-2's and Mixtral's included) give the JAX model's logits over
  prefill, decode and mixed steps within atol/rtol 1e-4 (the same f32
  arithmetic in another order), and the caches after the steps within
  rtol 1e-5 and atol 1e-5 of the caches' largest magnitude
  (``tests/test_torch_model.py``'s tolerances, whose fixture's K/V are of
  order 1: these weights make the later layers' K/V several times larger);
- the port, loading the checkpoint itself, gives HF's logits within 3e-4
  (``tests/test_model_families.py``'s tolerance: HF's attention sums in
  another order), through windows the sequences pass (Mistral, Phi-3,
  Gemma-2's local layers) and Gemma-2's soft caps;
- Gemma-2 hands each layer's attention its own window and the soft cap;
  Mixtral's dense mix equals each token's top-k experts renormalized;
- the port's ``LlmService`` and the JAX one, each loading the checkpoint
  from its directory, give identical greedy tokens.
"""

import asyncio
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu.models.registry import get_model_cls as jax_get_model_cls
from atoma_infer_tpu.models.weights import load_hf_config as jax_load_hf_config
from atoma_infer_tpu.models.weights import load_llama_params as jax_load_llama_params
from atoma_infer_tpu_torch.models import llama as port_llama
from atoma_infer_tpu_torch.models.registry import get_model_cls, list_models
from atoma_infer_tpu_torch.models.weights import (
    load_hf_config,
    load_llama_params,
    params_from_numpy,
    quantize_params,
)
from atoma_infer_tpu_torch.ops.quant import QuantizedTensor

from torch_parity import FIXTURE_TINY_TRAINED, jax_meta, model_step, to_numpy, torch_meta

torch.set_num_threads(2)

VOCAB = 659  # tiny_trained's tokenizer
BLOCK_SIZE = 16
NUM_BLOCKS = 16
LOGIT_TOL, CACHE_TOL, HF_TOL = 1e-4, 1e-5, 3e-4

_COMMON = dict(
    vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, rms_norm_eps=1e-5,
    rope_theta=10000.0, max_position_embeddings=512, tie_word_embeddings=False,
    bos_token_id=0, eos_token_id=1, initializer_range=0.125,
)
# name: (config.json, HF model class name)
CASES = {
    "llama": (dict(_COMMON, model_type="llama", rope_scaling=dict(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_max_position_embeddings=64)), "LlamaForCausalLM"),
    "mistral": (dict(_COMMON, model_type="mistral", sliding_window=24), "MistralForCausalLM"),
    "qwen2": (dict(_COMMON, model_type="qwen2"), "Qwen2ForCausalLM"),
    "phi3": (dict(_COMMON, model_type="phi3", num_key_value_heads=4, pad_token_id=0),
             "Phi3ForCausalLM"),
    # Phi-3-mini's head dim (hidden / heads = 96) and its kind of window.
    "phi3-d96": (dict(_COMMON, model_type="phi3", hidden_size=192, num_attention_heads=2,
                      num_key_value_heads=2, head_dim=96, sliding_window=24, pad_token_id=0),
                 "Phi3ForCausalLM"),
    "gemma2": (dict(_COMMON, model_type="gemma2", num_hidden_layers=4, rms_norm_eps=1e-6,
                    query_pre_attn_scalar=24, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0, sliding_window=16,
                    hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
                    bos_token_id=2, pad_token_id=0), "Gemma2ForCausalLM"),
    # Gemma-2's head dim (256, not hidden / heads) and its attention scale.
    "gemma2-d256": (dict(_COMMON, model_type="gemma2", num_attention_heads=2,
                         num_key_value_heads=1, head_dim=256, rms_norm_eps=1e-6,
                         query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
                         final_logit_softcapping=30.0, sliding_window=16,
                         hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
                         bos_token_id=2, pad_token_id=0), "Gemma2ForCausalLM"),
    "mixtral": (dict(_COMMON, model_type="mixtral", intermediate_size=96, num_local_experts=4,
                     num_experts_per_tok=2), "MixtralForCausalLM"),
}


def _build_checkpoint(name, model_dir):
    import transformers

    cfg_dict, cls_name = CASES[name]
    hf_cfg = getattr(transformers, cls_name).config_class(**cfg_dict)
    hf_cfg._attn_implementation = "eager"  # Gemma-2's soft cap needs it
    torch.manual_seed(sorted(CASES).index(name))
    hf_model = getattr(transformers, cls_name)(hf_cfg).eval().to(torch.float32)
    with torch.no_grad():
        if name == "qwen2":  # nonzero biases, so that the bias path counts
            for layer in hf_model.model.layers:
                for proj in ("q_proj", "k_proj", "v_proj"):
                    getattr(layer.self_attn, proj).bias.normal_(0.0, 0.5)
        if name.startswith("gemma2"):  # zero-centred norms: nonzero scales
            for key, w in hf_model.named_parameters():
                if "norm" in key:
                    w.normal_(0.0, 0.3)
    hf_model.save_pretrained(model_dir, safe_serialization=True)
    shutil.copy(os.path.join(FIXTURE_TINY_TRAINED, "tokenizer.json"), model_dir)
    return hf_model


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name → (directory, HF model), built once per module as needed."""
    built = {}

    def get(name):
        if name not in built:
            model_dir = str(tmp_path_factory.mktemp(name))
            built[name] = (model_dir, _build_checkpoint(name, model_dir))
        return built[name]

    return get


def _models(model_dir):
    """(JAX model, JAX params, port model, port params from JAX's), f32."""
    jcfg = jax_load_hf_config(model_dir)
    jmodel = jax_get_model_cls(jcfg.architecture)(jcfg, dtype=jnp.float32)
    jparams = jax_load_llama_params(model_dir, jcfg, dtype=jnp.float32)
    cfg = load_hf_config(model_dir)
    model = get_model_cls(cfg.architecture)(cfg, dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, params_from_numpy(jparams)


def _flat(params, prefix=""):
    for key, value in params.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _assert_same_params(port, jax_params):
    """Same keys; dense values equal; quantized bytes and scales equal."""
    port, jax_params = dict(_flat(port)), dict(_flat(jax_params))
    assert port.keys() == jax_params.keys()
    for key, value in port.items():
        want = jax_params[key]
        if isinstance(value, QuantizedTensor):
            assert (value.bits, value.group_size) == (want.bits, want.group_size), key
            np.testing.assert_array_equal(value.qweight.numpy(), np.asarray(want.qweight),
                                          err_msg=key)
            np.testing.assert_array_equal(to_numpy(value.scales), np.asarray(want.scales),
                                          err_msg=key)
        else:
            np.testing.assert_array_equal(value.numpy(), np.asarray(want), err_msg=key)


# --------------------------------------------------------------- the registry
def test_registry_resolves_every_family():
    from atoma_infer_tpu.models.registry import list_models as jax_list_models

    assert list_models() == jax_list_models()
    for name in list_models():
        cls = get_model_cls(name)
        assert cls.__module__.startswith("atoma_infer_tpu_torch.models.")
        assert cls.__name__ == jax_get_model_cls(name).__name__
        arch = {"phi3": "Phi3", "gemma2": "Gemma2", "qwen2": "Qwen2"}.get(name, name.title())
        assert get_model_cls(f"{arch}ForCausalLM") is cls
    with pytest.raises(ValueError, match="unsupported model type"):
        get_model_cls("gpt-neox")


# ----------------------------------------------------------------- the loader
@pytest.mark.parametrize("name", sorted(CASES))
def test_config_and_params_match_jax_loader(name, checkpoints):
    model_dir, _ = checkpoints(name)
    jcfg, cfg = jax_load_hf_config(model_dir), load_hf_config(model_dir)
    assert type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    params = load_llama_params(model_dir, cfg, dtype=torch.float32, device="cpu")
    _assert_same_params(params, jax_load_llama_params(model_dir, jcfg, dtype=jnp.float32))


@pytest.mark.parametrize("name", ["qwen2", "gemma2", "mixtral"])
def test_int8_params_match_jax_loader(name, checkpoints):
    """INT8 quantized on load, by both loaders and by the port's
    ``quantize_params`` on the dense parameters: the same bytes and scales;
    Qwen2's biases, Gemma-2's norms and Mixtral's router and experts dense."""
    model_dir, _ = checkpoints(name)
    cfg = load_hf_config(model_dir)
    params = load_llama_params(model_dir, cfg, dtype=torch.float32, device="cpu",
                               quantization="int8")
    want = jax_load_llama_params(model_dir, jax_load_hf_config(model_dir), dtype=jnp.float32,
                                 quantization="int8")
    _assert_same_params(params, want)
    dense = load_llama_params(model_dir, cfg, dtype=torch.float32, device="cpu")
    _assert_same_params(quantize_params(dense, "int8"), want)
    quantized = {k for k, v in params["layers"].items() if isinstance(v, QuantizedTensor)}
    moe = name == "mixtral"
    assert quantized == {"q_proj", "k_proj", "v_proj", "o_proj"} | (
        set() if moe else {"gate_proj", "up_proj", "down_proj"})


@pytest.mark.parametrize("name", ["gemma2", "mixtral"])
def test_params_from_numpy_carries_the_tree(name):
    """The JAX model's own random parameters (Gemma-2's four norms a layer,
    Mixtral's router and expert stacks) cross over key for key and value for
    value."""
    import jax

    cfg_dict, _ = CASES[name]
    jcfg = jax_get_model_cls(name).config_cls.from_hf_dict(cfg_dict)
    jparams = jax_get_model_cls(name)(jcfg, dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0))
    _assert_same_params(params_from_numpy(jparams), jparams)


# ------------------------------------------------------ logits against JAX
def _run_both(models, steps, stream):
    """The steps (seq_lens, q_lens) through both models on shared tables:
    per step (JAX logits, port logits) at the real rows; the final caches."""
    jmodel, jparams, model, params = models
    tables = [[3, 9, 1], [12, 0, 7]]
    jcache = jnp.zeros(jmodel.kv_cache_shape(NUM_BLOCKS, BLOCK_SIZE), jnp.float32)
    tcache = model.alloc_kv_cache(NUM_BLOCKS, BLOCK_SIZE)
    results = []
    for seq_lens, q_lens in steps:
        case, positions, toks = model_step(seq_lens, q_lens, tables[: len(seq_lens)], stream)
        hidden_j, jcache = jmodel.forward(jparams, jnp.asarray(toks), jnp.asarray(positions),
                                          jcache, jax_meta(case))
        logits_j = np.asarray(jmodel.compute_logits(jparams, hidden_j))
        hidden_t = model.forward(params, torch.from_numpy(toks), torch.from_numpy(positions),
                                 tcache, torch_meta(case))
        logits_t = model.compute_logits(params, hidden_t).numpy()
        n = int(case["query_start_loc"][-1])
        results.append((logits_j[:n], logits_t[:n]))
    return results, np.asarray(jcache), torch.stack(tcache).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_match_jax_prefill_decode_mixed(name, checkpoints):
    """Two prefills, a decode, a chunk beside a decode, a decode: the
    sequences pass the tiny windows (24 and 16 keys)."""
    model_dir, _ = checkpoints(name)
    rng = np.random.default_rng(1)
    stream = [rng.integers(2, VOCAB, size=48).astype(np.int32) for _ in range(2)]
    steps = [((30, 21), (30, 21)), ((31, 22), (1, 1)), ((40, 32), (9, 10)), ((41, 33), (1, 1))]
    results, jcache, tcache = _run_both(_models(model_dir), steps, stream)
    for logits_j, logits_t in results:
        assert np.isfinite(logits_t).all()
        np.testing.assert_allclose(logits_t, logits_j, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(tcache, jcache, atol=CACHE_TOL * np.abs(jcache).max(),
                               rtol=CACHE_TOL)


# ------------------------------------------------------- logits against HF
@pytest.mark.parametrize("name", sorted(CASES))
def test_logits_match_hf(name, checkpoints):
    """The port's own loader and forward against the HF model that wrote
    the checkpoint: one 40-token prompt (past the windows) in one step."""
    model_dir, hf_model = checkpoints(name)
    cfg = load_hf_config(model_dir)
    model = get_model_cls(cfg.architecture)(cfg, dtype=torch.float32, device="cpu")
    params = load_llama_params(model_dir, cfg, dtype=torch.float32, device="cpu")
    T = 40
    tokens = np.random.default_rng(2).integers(0, VOCAB, size=T).astype(np.int32)
    case, positions, toks = model_step([T], [T], [[3, 1, 6]], [tokens])
    cache = model.alloc_kv_cache(8, BLOCK_SIZE)
    with torch.no_grad():
        hidden = model.forward(params, torch.from_numpy(toks), torch.from_numpy(positions),
                               cache, torch_meta(case))
        got = model.compute_logits(params, hidden[:T]).numpy()
        want = hf_model(torch.from_numpy(tokens).long()[None]).logits[0].numpy()
    np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=HF_TOL)


# ------------------------------------------------- Gemma-2 and Mixtral parts
@pytest.mark.parametrize("name", ["gemma2", "gemma2-d256"])
def test_gemma2_layer_windows_and_soft_cap(name, checkpoints, monkeypatch):
    """Each layer's attention gets its own window (even layers local, odd
    global), the attention soft cap and query_pre_attn_scalar's scale; the
    engine-level window stays None."""
    model_dir, _ = checkpoints(name)
    cfg = load_hf_config(model_dir)
    assert cfg.sliding_window is None
    L = cfg.num_layers
    assert [cfg.layer_sliding_window(i) for i in range(L)] == [16, None] * (L // 2)
    calls = []
    real = port_llama.paged_attention_layer

    def spy(*args, **kw):
        calls.append((kw["sliding_window"], kw["soft_cap"], kw["scale"]))
        return real(*args, **kw)

    monkeypatch.setattr(port_llama, "paged_attention_layer", spy)
    model = get_model_cls("gemma2")(cfg, dtype=torch.float32, device="cpu")
    params = load_llama_params(model_dir, cfg, dtype=torch.float32, device="cpu")
    case, positions, toks = model_step([20], [20], [[0, 1]], [np.arange(2, 22)])
    model.forward(params, torch.from_numpy(toks), torch.from_numpy(positions),
                  model.alloc_kv_cache(4, BLOCK_SIZE), torch_meta(case))
    scale = cfg.query_pre_attn_scalar**-0.5
    assert calls == [(cfg.layer_sliding_window(i), 50.0, scale) for i in range(L)]


def test_mixtral_mix_is_the_top_k_experts(checkpoints):
    """The dense [T, E] mix equals, token by token, the chosen k experts'
    SwiGLU outputs weighted by their router probabilities renormalized over
    the k; and the JAX block's output."""
    model_dir, _ = checkpoints("mixtral")
    jmodel, jparams, model, params = _models(model_dir)
    lp = port_llama._layer_params(params["layers"], 1)
    x = np.random.default_rng(3).standard_normal((9, 64)).astype(np.float32)
    got = model._mlp_block(torch.from_numpy(x), lp).numpy()
    jlp = {k: v[1] for k, v in jparams["layers"].items()}
    np.testing.assert_allclose(got, np.asarray(jmodel._mlp_block(jnp.asarray(x), jlp)),
                               atol=1e-5, rtol=1e-5)
    router, w1, w3, w2 = (lp[k].double().numpy() for k in ("router", "w1", "w3", "w2"))
    k = model.config.num_experts_per_tok
    for t in range(x.shape[0]):
        logits = x[t].astype(np.float64) @ router
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        chosen = np.argsort(-probs)[:k]
        want = np.zeros(64)
        for e in chosen:
            g, u = x[t] @ w1[e], x[t] @ w3[e]
            want += probs[e] / probs[chosen].sum() * ((g / (1 + np.exp(-g)) * u) @ w2[e])
        np.testing.assert_allclose(got[t], want, atol=1e-5, rtol=1e-4)


# -------------------------------------------------------------- the services
def _serve_dir(pkg, model_dir, prompts, kv_cache_dtype=None):
    """Greedy tokens of ``pkg``'s ``LlmService`` loading ``model_dir`` in f32
    on the CPU (the JAX service's platform here), 16 new tokens a prompt,
    over a KV cache of ``kv_cache_dtype`` (None: f32; "int8" or "fp8")."""
    import importlib

    cfg = importlib.import_module(f"{pkg}.config")
    service_mod = importlib.import_module(f"{pkg}.engine.llm_service")
    types = importlib.import_module(f"{pkg}.types")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(model_name=model_dir, dtype="float32",
                              kv_cache_dtype=kv_cache_dtype),
        cache=cfg.CacheConfig(block_size=BLOCK_SIZE, num_device_blocks_override=96,
                              num_host_blocks_override=16),
        scheduler=cfg.SchedulerConfig(max_num_batched_tokens=64, max_num_sequences=8,
                                      max_model_len=256, enable_chunked_prefill=True,
                                      use_native_core=False),
        validation=cfg.ValidationConfig(max_input_tokens=128, max_total_tokens=256),
    )
    kw = dict(device="cpu") if pkg == "atoma_infer_tpu_torch" else {}
    service = service_mod.LlmService.start(config, model_dir=model_dir, **kw)

    async def scenario():
        task = asyncio.create_task(service.engine.run())
        futs = [await service.handle_request(types.GenerateRequest(
            request_id=f"req-{i}", inputs=p,
            parameters=types.GenerateParameters(max_new_tokens=16)))
            for i, p in enumerate(prompts)]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
        service.stop()
        task.cancel()
        return results

    results = asyncio.run(scenario())
    assert service.engine.scheduler.block_manager.get_num_free_device_blocks() == 96
    return [tuple(r.outputs[0].token_ids) for r in results]


SERVICE_PROMPTS = [f"the {i}th family prompt, " * (1 + 2 * (i % 3)) for i in range(5)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_service_greedy_tokens_match_jax(name, checkpoints):
    """Both services from the same directory (chunked prefill of 64-token
    budgets, prompts of 8 to 60 tokens, so that decodes pass the windows):
    identical greedy tokens."""
    model_dir, _ = checkpoints(name)
    want = _serve_dir("atoma_infer_tpu", model_dir, SERVICE_PROMPTS)
    got = _serve_dir("atoma_infer_tpu_torch", model_dir, SERVICE_PROMPTS)
    assert got == want
    assert all(len(t) == 16 or t[-1] == 1 for t in got)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["phi3-d96", "gemma2-d256"])
def test_service_greedy_tokens_match_jax_over_1byte_caches(name, kv, checkpoints):
    """Phi-3-mini's head dim (96) and Gemma-2's (256) over an INT8 and an
    e4m3 KV cache, the shapes the card's kernels D and E now take: both
    services from the same directory give identical greedy tokens."""
    model_dir, _ = checkpoints(name)
    want = _serve_dir("atoma_infer_tpu", model_dir, SERVICE_PROMPTS, kv)
    got = _serve_dir("atoma_infer_tpu_torch", model_dir, SERVICE_PROMPTS, kv)
    assert got == want
    assert all(len(t) == 16 or t[-1] == 1 for t in got)
