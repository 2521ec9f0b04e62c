"""Pipeline parallelism in the port, against the JAX package's.

Mirrors ``tests/test_pipeline.py``: the layer split and the per-stage
parameter dicts (``parallel/pipeline.py``, tied and untied, INT8 weights
split as views); the stage chain (embed → stage 0 → stage 1 → logits)
against the port's whole forward and against JAX's chain of
``split_params`` stages on the same numpy weights (f32, within 1e-5);
``LlmService`` at ``pipeline_parallel_size`` 2 against JAX's at pp 2 (the
conftest's virtual CPU devices) and the port at pp 1, greedy tokens
identical — f32, over an INT8 cache (each stage's cache within one INT8
step of JAX's stage cache, its scales bit for bit), over an e4m3 cache, at
pp 2 × tp 2 with spawned gloo ranks, and a 5-layer Gemma-2 whose stage 1
starts on the odd layer 3 (``layer_offset``: each layer keeps its window);
the cohorts' shared block pool whole after the traffic, an abort while its
cohort's step is in flight, the step metrics under PP; and
``CacheEngine.swap_blocks_to`` against JAX's, scales included
(``tests/test_cache_engine.py:224-245``).
"""

import asyncio
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_parity as tpar
from test_torch_tp import PROMPTS, WIDTHS, jax_generate, jax_params, port_factory, port_service

torch.set_num_threads(2)


def _jax_pp_service(tp, pp, widths, *, kv_cache_dtype=None):
    """The JAX ``LlmService`` of ``tests/test_pipeline.py`` at ``tp`` × ``pp``,
    with the native block manager as there. Its cohorts share that one
    manager, which allocates block ids as the port's one shared Python
    manager does. (With ``use_native_core`` off, JAX's ``_start_pipelined``
    gets None from ``_build_block_manager`` and every cohort's ``Scheduler``
    builds a pool of its own, so two cohorts take the same blocks and the
    tokens part from pp = 1: a fault of the reference, ROADMAP.md.)"""
    from atoma_infer_tpu.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu.engine.llm_service import LlmService
    from atoma_infer_tpu.entrypoints.offline import ByteTokenizer

    model, params = jax_params(widths)
    config = EngineConfig(
        model=ModelConfig(model_name="tiny-random", dtype="float32", tensor_parallel_size=tp,
                          pipeline_parallel_size=pp, kv_cache_dtype=kv_cache_dtype),
        cache=CacheConfig(block_size=16, num_device_blocks_override=128,
                          num_host_blocks_override=32),
        scheduler=SchedulerConfig(max_num_batched_tokens=512, max_num_sequences=16,
                                  max_model_len=512, enable_chunked_prefill=False),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    service = LlmService.start(config, model=model, params=params,
                               tokenizer=ByteTokenizer(widths["vocab_size"]))
    managers = {id(s.block_manager) for s in service.engine.schedulers}
    assert len(service.engine.schedulers) == pp and len(managers) == 1
    return service


# ------------------------------------------------------------- the split
@pytest.mark.parametrize("num_layers, pp", [(7, 2), (8, 4), (2, 2), (5, 2), (32, 2), (42, 2),
                                            (9, 4), (3, 3)])
def test_stage_layer_bounds_match_jax(num_layers, pp):
    from atoma_infer_tpu.parallel.pipeline import stage_layer_bounds as jax_bounds

    from atoma_infer_tpu_torch.parallel.pipeline import stage_layer_bounds

    got = stage_layer_bounds(num_layers, pp)
    assert got == [tuple(b) for b in jax_bounds(num_layers, pp)]
    assert got[0][0] == 0 and got[-1][1] == num_layers
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("num_layers, pp", [(2, 3), (4, 0)])
def test_stage_layer_bounds_refuse_bad_sizes(num_layers, pp):
    from atoma_infer_tpu_torch.parallel.pipeline import stage_layer_bounds

    with pytest.raises(ValueError, match="pipeline_parallel_size"):
        stage_layer_bounds(num_layers, pp)


@pytest.mark.parametrize("pp, device, local_ranks, cards, want", [
    (2, "cpu", 1, 1, ["cpu", "cpu"]),
    (2, "cuda:0", 1, 1, ["cuda:0", "cuda:0"]),   # the one-card machine
    (2, "cuda:0", 1, 2, ["cuda:0", "cuda:1"]),   # a card a stage
    (2, "cuda:1", 2, 4, ["cuda:1", "cuda:3"]),   # rank 1 of tp 2 over 4 cards
    (2, "cuda:1", 2, 2, ["cuda:1", "cuda:1"]),   # each rank keeps its card
    (4, "cuda:0", 2, 8, ["cuda:0", "cuda:2", "cuda:4", "cuda:6"]),
], ids=["cpu", "one-card", "card-a-stage", "tp2-4cards", "tp2-2cards", "pp4-tp2-8cards"])
def test_stage_devices(pp, device, local_ranks, cards, want):
    from atoma_infer_tpu_torch.parallel.pipeline import stage_devices

    got = stage_devices(pp, torch.device(device), local_ranks, cards)
    assert got == [torch.device(d) for d in want]


def test_place_stage_params_keeps_views_on_one_device_and_copies_when_spread():
    """Stages on one device hold views of the whole tensors; stages spread
    over devices hold copies, so that the whole tensors can be freed (the
    meta device stands in for a second card)."""
    from atoma_infer_tpu_torch.parallel.pipeline import place_stage_params, split_params

    _, (_, params) = _tiny()
    whole = params["layers"]["q_proj"].untyped_storage().data_ptr()
    one = place_stage_params(split_params(params, 2), [None, None],
                             [torch.device("cpu")] * 2, 2)
    assert all(st["layers"]["q_proj"].untyped_storage().data_ptr() == whole for st in one)
    spread = place_stage_params(split_params(params, 2), [None, None],
                                [torch.device("cpu"), torch.device("meta")], 2)
    assert spread[0]["layers"]["q_proj"].untyped_storage().data_ptr() != whole
    assert torch.equal(spread[0]["layers"]["q_proj"], params["layers"]["q_proj"][:2])
    assert spread[1]["layers"]["q_proj"].device.type == "meta"


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_stage_groups(backend, monkeypatch):
    """A rank's stage group: stage 0 on its own device is the group itself;
    another stage shares its ranks, payload group and collectives count,
    and under NCCL has a tensor process group of its own over the stage's
    store prefix, bound to the stage's device."""
    from atoma_infer_tpu_torch.parallel import group as group_mod

    made = []
    monkeypatch.setattr(group_mod, "_process_group",
                        lambda *a: made.append((a[0], a[1], a[2], a[3], a[5])) or "stage-pg")
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.distributed, "PrefixStore", lambda prefix, store: prefix)
    g = group_mod.TpGroup(2, 1, "cuda:1", backend=backend, tensor_pg="pg", payload_pg="payload")
    assert g.for_stage(0, "cuda:1") is g
    s1 = g.for_stage(1, "cuda:3")
    assert (s1.tp, s1.rank, s1.device, s1._payload_pg) == (2, 1, torch.device("cuda", 3),
                                                           "payload")
    s1.collectives += 2
    assert g.collectives == 2
    if backend == "nccl":
        assert s1._tensor_pg == "stage-pg"
        assert made == [("nccl", "atoma/tensor/stage1", 1, 2, torch.device("cuda", 3))]
    else:
        assert s1._tensor_pg == "pg" and not made


def _tiny(num_layers=4, tie=True):
    widths = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=num_layers, num_attention_heads=4, num_key_value_heads=2,
                  head_dim=16, max_position_embeddings=512, rope_theta=10000.0,
                  rope_scaling=None, tie_word_embeddings=tie, eos_token_ids=(1,),
                  bos_token_id=0)
    from atoma_infer_tpu.models.llama import Llama as JLlama, LlamaConfig as JConfig

    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    jmodel = JLlama(JConfig(**widths), dtype=jnp.float32)
    jparams = jmodel.init_params(jax.random.PRNGKey(7))
    model = Llama(LlamaConfig(**widths), dtype=torch.float32, device="cpu")
    return (jmodel, jparams), (model, params_from_numpy(jparams, torch.float32, "cpu"))


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_split_params_keys_and_views(tie):
    from atoma_infer_tpu.parallel.pipeline import split_params as jax_split

    from atoma_infer_tpu_torch.parallel.pipeline import split_params

    (_, jparams), (_, params) = _tiny(tie=tie)
    stages = split_params(params, 2)
    jstages = jax_split(jparams, 2)
    assert [sorted(s) for s in stages] == [sorted(s) for s in jstages]
    assert "embed" in stages[0] and "final_norm" in stages[1] and "final_norm" not in stages[0]
    assert ("lm_head" in stages[1]) != tie and ("embed" in stages[1]) == tie
    for s, lo in ((0, 0), (1, 2)):
        for key, value in stages[s]["layers"].items():
            whole = params["layers"][key]
            assert value.shape[0] == 2
            assert value.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
            assert torch.equal(value, whole[lo:lo + 2])
            assert np.array_equal(value.numpy(), np.asarray(jstages[s]["layers"][key]))


def test_quantized_params_split_as_views():
    """An INT8 stacked weight splits ``qweight`` and ``scales`` together, as
    views holding the same bytes as JAX's split of the same weight."""
    from atoma_infer_tpu.ops.quant import QuantizedTensor as JQ, quantize_weight as jax_quantize
    from atoma_infer_tpu.parallel.pipeline import split_params as jax_split

    from atoma_infer_tpu_torch.ops.quant import quantize_weight
    from atoma_infer_tpu_torch.parallel.pipeline import split_params

    (_, jparams), (_, params) = _tiny()
    qt = quantize_weight(params["layers"]["gate_proj"], bits=8, group_size=32)
    params["layers"]["gate_proj"] = qt
    per_layer = [jax_quantize(w, bits=8, group_size=32) for w in jparams["layers"]["gate_proj"]]
    jparams["layers"]["gate_proj"] = JQ(qweight=jnp.stack([q.qweight for q in per_layer]),
                                        scales=jnp.stack([q.scales for q in per_layer]),
                                        bits=8, group_size=32)
    stages, jstages = split_params(params, 2), jax_split(jparams, 2)
    for s in range(2):
        q, jq = stages[s]["layers"]["gate_proj"], jstages[s]["layers"]["gate_proj"]
        assert q.bits == 8 and q.group_size == 32
        assert q.qweight.shape[0] == 2 and q.scales.shape[0] == 2
        assert q.qweight.untyped_storage().data_ptr() == qt.qweight.untyped_storage().data_ptr()
        assert q.scales.untyped_storage().data_ptr() == qt.scales.untyped_storage().data_ptr()
        assert np.array_equal(q.qweight.numpy(), np.asarray(jq.qweight))
        assert np.array_equal(tpar.to_numpy(q.scales).view(np.int16),
                              np.asarray(jq.scales).view(np.int16))


def _decode_case(num_seqs=3, bs=16, pages=4):
    tables = np.arange(num_seqs * pages, dtype=np.int32).reshape(num_seqs, pages)
    return dict(tables=tables, seq_lens=np.full(num_seqs, 3, np.int32),
                slots=(tables[:, 0] * bs + 2).astype(np.int32),
                qsl=np.arange(num_seqs + 1, dtype=np.int32), bs=bs)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_stage_chain_matches_full_forward_and_jax(tie):
    """embed → stage 0 (layers 0-1) → stage 1 (layers 2-3) → logits: the
    port's chain equals its whole forward, and JAX's chain of split stages
    on the same weights, within 1e-5 (f32)."""
    from atoma_infer_tpu.ops.attention import AttentionMetadata as JMeta
    from atoma_infer_tpu.parallel.pipeline import split_params as jax_split

    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata
    from atoma_infer_tpu_torch.parallel.pipeline import split_params

    (jmodel, jparams), (model, params) = _tiny(tie=tie)
    c = _decode_case()
    S, P = c["tables"].shape
    meta = AttentionMetadata(
        slot_mapping=torch.from_numpy(c["slots"]), block_tables=torch.from_numpy(c["tables"]),
        seq_lens=torch.from_numpy(c["seq_lens"]), query_start_loc=torch.from_numpy(c["qsl"]),
        num_seqs=torch.tensor([S], dtype=torch.int32), block_size=c["bs"])
    jmeta = JMeta(slot_mapping=jnp.asarray(c["slots"]), block_tables=jnp.asarray(c["tables"]),
                  seq_lens=jnp.asarray(c["seq_lens"]), query_start_loc=jnp.asarray(c["qsl"]),
                  num_seqs=jnp.asarray(S, jnp.int32), block_size=c["bs"])
    tokens, positions = np.asarray([5, 9, 250], np.int32), np.asarray([2, 2, 2], np.int32)
    row = 2 * 2 * 16

    def caches(n):
        return [torch.zeros((S * P, c["bs"], row)) for _ in range(n)]

    full = model.compute_logits(params, model.forward(
        params, torch.from_numpy(tokens), torch.from_numpy(positions), caches(4), meta))
    stages = split_params(params, 2)
    h = model.embed_tokens(stages[0], torch.from_numpy(tokens))
    h = model.forward_hidden(stages[0], h, torch.from_numpy(positions), caches(2), meta)
    h = model.forward_hidden(stages[1], h, torch.from_numpy(positions), caches(2), meta,
                             layer_offset=2)
    chain = model.compute_logits(stages[1], h)

    jstages = jax_split(jparams, 2)
    jcaches = tuple(jnp.zeros((S * P, c["bs"], row), jnp.float32) for _ in range(2))
    jh = jmodel.embed_tokens(jstages[0], jnp.asarray(tokens))
    jh, _ = jmodel.forward_hidden(jstages[0], jh, jnp.asarray(positions), jcaches, jmeta)
    jh, _ = jmodel.forward_hidden(jstages[1], jh, jnp.asarray(positions), jcaches, jmeta,
                                  layer_offset=2)
    jchain = np.asarray(jmodel.compute_logits(jstages[1], jh))
    np.testing.assert_allclose(chain.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chain.numpy(), jchain, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the service
@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async-config"])
def test_pp2_tokens_match_jax_and_pp1(async_scheduling, tmp_path):
    """pp = 2 (f32): greedy tokens as JAX's ``LlmService`` at pp = 2 and the
    port at pp = 1. ``async_scheduling`` is off with two cohorts, as in
    JAX: the service with it configured serves the same tokens."""
    factory = port_factory(tmp_path, WIDTHS)
    want = jax_generate(_jax_pp_service(1, 2, WIDTHS), PROMPTS)
    one = tpar.generate(port_service(1, tmp_path, factory), PROMPTS)
    service = port_service(1, tmp_path, factory, pipeline_parallel_size=2,
                           async_scheduling=async_scheduling)
    engine = service.engine
    assert len(engine.schedulers) == 2 and not engine._async_scheduling
    assert [ce.num_layers for ce in engine.worker.cache_engines] == [1, 1]
    assert engine.worker.graphs is None
    got = tpar.generate(service, PROMPTS)
    assert got == want == one


def test_pp2_int8_kv_stage_caches_match_jax(tmp_path):
    """pp = 2 over INT8 KV: tokens as JAX's and the port's pp = 1; each
    stage's cache within one INT8 step of JAX's stage cache, its scales
    bit for bit (JAX's in 128-lane pages)."""
    factory = port_factory(tmp_path, WIDTHS)
    jsvc = _jax_pp_service(1, 2, WIDTHS, kv_cache_dtype="int8")
    want = jax_generate(jsvc, PROMPTS[:2])
    one = tpar.generate(port_service(1, tmp_path, factory, kv_cache_dtype="int8"), PROMPTS[:2])
    service = port_service(1, tmp_path, factory, kv_cache_dtype="int8", pipeline_parallel_size=2)
    assert tpar.generate(service, PROMPTS[:2]) == want == one
    jces, ces = jsvc.engine.worker.cache_engines, service.engine.worker.cache_engines
    assert len(jces) == len(ces) == 2
    for jce, ce in zip(jces, ces):
        assert ce.num_layers == jce.num_layers == 1
        for cache, scales, jcache, jscales in zip(ce.kv_cache, ce.kv_scales, jce.kv_cache,
                                                  jce.kv_scales):
            got, ref = cache.numpy().astype(np.int32), np.asarray(jcache).astype(np.int32)
            assert got.shape == ref.shape and (got != 0).any()
            assert np.abs(got - ref).max() <= 1
            pages = tpar.jax_scale_pages(tpar.to_numpy(scales))
            assert np.array_equal(pages.view(np.int16), np.asarray(jscales).view(np.int16))


def test_pp2_fp8_kv_matches_pp1(tmp_path):
    factory = port_factory(tmp_path, WIDTHS)
    one = tpar.generate(port_service(1, tmp_path, factory, kv_cache_dtype="fp8"), PROMPTS)
    service = port_service(1, tmp_path, factory, kv_cache_dtype="fp8", pipeline_parallel_size=2)
    assert service.engine.worker.cache_engines[1].kv_cache[0].dtype == torch.float8_e4m3fn
    assert tpar.generate(service, PROMPTS) == one


def test_pp2_tp2_tokens_match_jax_and_pp1(tmp_path):
    """pp = 2 × tp = 2: two spawned gloo ranks, each holding its shard of
    both stages; tokens as JAX's at pp = 2 × tp = 2 (4 virtual devices) and
    the port at pp = 1, tp = 1."""
    factory = port_factory(tmp_path, WIDTHS)
    want = jax_generate(_jax_pp_service(2, 2, WIDTHS), PROMPTS[:2])
    one = tpar.generate(port_service(1, tmp_path, factory), PROMPTS[:2])
    service = port_service(2, tmp_path, factory, pipeline_parallel_size=2)
    followers = list(service.followers)
    assert len(followers) == 1
    worker = service.engine.worker
    assert [s.model.local_q_heads for s in worker.stages] == [4, 4]
    assert [s.model.group.rank for s in worker.stages] == [0, 0]
    assert tuple(worker.stages[0].params["layers"]["q_proj"].shape) == (1, 128, 128)
    got = tpar.generate(service, PROMPTS[:2])
    assert got == want == one
    assert [p.exitcode for p in followers] == [0]


GEMMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=5,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             max_position_embeddings=512, rope_theta=10000.0, rope_scaling=None,
             tie_word_embeddings=True, eos_token_ids=(1,), bos_token_id=0, sliding_window=None,
             local_sliding_window=8, attn_logit_softcapping=50.0,
             final_logit_softcapping=30.0, query_pre_attn_scalar=16.0)


def _gemma_params():
    """A 5-layer Gemma-2's JAX model and weights (its zero-centred norms
    drawn nonzero from a seed)."""
    from atoma_infer_tpu.models.gemma import Gemma2, GemmaConfig

    model = Gemma2(GemmaConfig(**GEMMA), dtype=jnp.float32)
    params = model.init_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    for key in ("input_norm", "post_norm", "pre_ffw_norm", "post_ffw_norm"):
        shape = params["layers"][key].shape
        params["layers"][key] = jnp.asarray(0.1 * rng.standard_normal(shape), jnp.float32)
    return model, params


def test_gemma2_five_layers_pp2_keeps_each_layers_window(monkeypatch):
    """A 5-layer Gemma-2 at pp = 2: stage 1 starts at layer 3, which is odd
    (global), so a stage-local index would swap local and global windows.
    Every step's five attention calls take the windows of layers 0-4
    (local, global, …), and the greedy tokens equal the service's at
    pp = 1 and JAX's ``LlmService`` at pp = 2 on the same weights."""
    from atoma_infer_tpu.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu.engine.llm_service import LlmService as JaxService
    from atoma_infer_tpu.entrypoints.offline import ByteTokenizer as JaxTokenizer

    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.models import llama as llama_mod
    from atoma_infer_tpu_torch.models.gemma import Gemma2, GemmaConfig
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    prompts = ["a prompt longer than the eight-key local window", "short one"]
    jmodel, jparams = _gemma_params()
    jconfig = EngineConfig(
        model=ModelConfig(model_name="tiny-random", dtype="float32", pipeline_parallel_size=2),
        cache=CacheConfig(block_size=16, num_device_blocks_override=128,
                          num_host_blocks_override=32),
        scheduler=SchedulerConfig(max_num_batched_tokens=512, max_num_sequences=16,
                                  max_model_len=512, enable_chunked_prefill=False),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    want = jax_generate(JaxService.start(jconfig, model=jmodel, params=jparams,
                                         tokenizer=JaxTokenizer(GEMMA["vocab_size"])), prompts)
    windows = []
    inner = llama_mod.paged_attention_layer

    def spy(*args, **kw):
        windows.append(kw["sliding_window"])
        return inner(*args, **kw)

    monkeypatch.setattr(llama_mod, "paged_attention_layer", spy)
    got = {}
    for pp in (1, 2):
        windows.clear()
        model = Gemma2(GemmaConfig(**GEMMA), dtype=torch.float32, device="cpu")
        config = tpar.tp_engine_config(1, pipeline_parallel_size=pp)
        service = LlmService.start(config, model=model, device="cpu",
                                   params=params_from_numpy(jparams, torch.float32, "cpu"),
                                   tokenizer=ByteTokenizer(GEMMA["vocab_size"]))
        if pp == 2:
            assert [s.layer_offset for s in service.engine.worker.stages] == [0, 3]
        got[pp] = (tpar.generate(service, prompts), list(windows))
    for _, calls in got.values():
        assert len(calls) % 5 == 0
        assert [calls[i: i + 5] for i in range(0, len(calls), 5)] == \
            [[8, None, 8, None, 8]] * (len(calls) // 5)
    assert got[2][0] == got[1][0] == want


# ------------------------------------------------------------- the engine
def _pp_service(tmp_path, **kw):
    return port_service(1, tmp_path, port_factory(tmp_path, WIDTHS), pipeline_parallel_size=2,
                        **kw)


def test_cohorts_share_one_pool_without_leaks(tmp_path):
    service = _pp_service(tmp_path)
    engine = service.engine
    assert engine.schedulers[0].block_manager is engine.schedulers[1].block_manager
    cohorts = []
    admit = engine._scheduler_for

    def spy(group):
        cohorts.append(group.cohort)
        return admit(group)

    engine._scheduler_for = spy
    tpar.generate(service, PROMPTS * 2)
    assert sorted(set(cohorts)) == [0, 1]
    assert not engine._pending
    bm = engine.schedulers[0].block_manager
    assert bm.get_num_free_device_blocks() == service.config.cache.num_device_blocks


def test_request_added_when_the_last_resolves_joins_cohort_zero(tmp_path, monkeypatch):
    """A request added as soon as the one before it resolves (nothing else
    in flight) joins cohort 0: the finished group's future resolves only
    after its cohort's scheduler has dropped it, so ``add_request`` never
    counts a finished group. The removal is slowed down, which used to let
    the awaiter add its next request first and send it to cohort 1."""
    from atoma_infer_tpu_torch.core.scheduler import Scheduler
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    remove = Scheduler.remove_finished_sequences

    def slow_remove(self):
        if any(g.is_finished() for g in self.running):
            time.sleep(0.2)
        return remove(self)

    monkeypatch.setattr(Scheduler, "remove_finished_sequences", slow_remove)
    service = _pp_service(tmp_path)
    engine = service.engine
    cohorts = []
    add = engine.add_request

    def spy(group, *args):
        add(group, *args)
        cohorts.append(group.cohort)

    engine.add_request = spy

    async def run():
        task = asyncio.create_task(engine.run())
        for i in range(3):
            fut = await service.handle_request(GenerateRequest(
                request_id=f"one-{i}", inputs=PROMPTS[i % len(PROMPTS)],
                parameters=GenerateParameters(max_new_tokens=3, do_sample=False)))
            await asyncio.wait_for(fut, timeout=60)
        service.stop()
        task.cancel()

    asyncio.run(run())
    assert cohorts == [0, 0, 0]


def test_abort_while_its_cohorts_step_is_in_flight(tmp_path):
    """An abort applied while the aborted group's cohort has a step in
    flight: the step completes without it, the other requests serve the
    tokens they serve without the abort, and the pool is whole again."""
    want = tpar.generate(_pp_service(tmp_path), PROMPTS)
    service = _pp_service(tmp_path)
    engine = service.engine
    in_flight = []
    drain = engine._drain_aborts

    def spy():
        if not engine._pending_aborts.empty():
            group = engine._groups["req-1"]
            in_flight.append(any(c == group.cohort for c, _, _ in engine._pending))
        return drain()

    engine._drain_aborts = spy
    got = tpar.generate(service, PROMPTS, abort_at=(6, "req-1"))
    assert in_flight == [True]
    assert got["req-0"] == want["req-0"] and got["req-2"] == want["req-2"]
    assert len(got["req-1"]) < len(want["req-1"])
    assert got["req-1"] == want["req-1"][: len(got["req-1"])]
    bm = engine.schedulers[0].block_manager
    assert bm.get_num_free_device_blocks() == service.config.cache.num_device_blocks


def test_step_metrics_are_counted_under_pp(tmp_path):
    """Every pipelined step counts an engine step and its scheduled tokens
    (the JAX engine returns before counting them)."""
    from atoma_infer_tpu_torch.server import metrics

    service = _pp_service(tmp_path)
    engine = service.engine
    tokens = []
    for scheduler in engine.schedulers:
        schedule = scheduler.schedule

        def counted(schedule=schedule):
            metas, outs = schedule()
            tokens.append(outs.num_batched_tokens)
            return metas, outs

        scheduler.schedule = counted
    steps0, tokens0 = metrics.ENGINE_STEPS.value, metrics.SCHEDULED_TOKENS.value
    tpar.generate(service, PROMPTS)
    assert metrics.ENGINE_STEPS.value - steps0 == len(tokens) > 0
    assert metrics.SCHEDULED_TOKENS.value - tokens0 == sum(tokens) > 0


def test_warmup_under_pp_runs_its_waves(tmp_path):
    """``warmup`` at pp = 2, tp = 1: nothing to capture on the CPU (a CPU
    stage steps eagerly), the waves run through the cohorts and leave the
    pool whole."""
    service = _pp_service(tmp_path)

    async def run():
        task = asyncio.create_task(service.engine.run())
        dt = await service.warmup(num_seqs=3, prompt_len=8, max_new=3, waves=1)
        service.stop()
        task.cancel()
        return dt

    assert asyncio.run(run()) > 0
    bm = service.engine.schedulers[0].block_manager
    assert bm.get_num_free_device_blocks() == service.config.cache.num_device_blocks


@pytest.mark.parametrize("pp, heads, match", [(3, 4, "num_layers"), (2, 3, "incompatible")],
                         ids=["more-stages-than-layers", "heads"])
def test_pp_refuses_bad_sizes(pp, heads, match, tmp_path):
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    widths = dict(WIDTHS, num_key_value_heads=heads, num_attention_heads=heads * 2)
    config = tpar.tp_engine_config(2 if heads == 3 else 1, pipeline_parallel_size=pp,
                                   coordinator_address=tpar.rendezvous_file(tmp_path))
    with pytest.raises(ValueError, match=match):
        LlmService.start(config, model_factory=port_factory(tmp_path, widths), device="cpu")


# ------------------------------------------------------------- swap_blocks_to
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_swap_blocks_to_matches_jax(kv):
    from atoma_infer_tpu.engine.cache_engine import CacheEngine as JCacheEngine

    from atoma_infer_tpu_torch.engine.cache_engine import CacheEngine

    dtype, jdtype = (torch.int8, jnp.int8) if kv == "int8" else (torch.float32, jnp.float32)
    shape = dict(num_layers=2, num_kv_heads=2, head_dim=16, block_size=4, num_device_blocks=8,
                 num_host_blocks=0)
    src, dst = CacheEngine(dtype=dtype, **shape), CacheEngine(dtype=dtype, **shape)
    jsrc, jdst = JCacheEngine(dtype=jdtype, **shape), JCacheEngine(dtype=jdtype, **shape)
    rng = np.random.default_rng(5)
    for eng, jeng in ((src, jsrc), (dst, jdst)):
        data = [rng.integers(-100, 100, size=c.shape) if kv == "int8"
                else rng.standard_normal(c.shape) for c in eng.kv_cache]
        for layer, d in enumerate(data):
            eng.kv_cache[layer].copy_(torch.from_numpy(d.astype(np.int8 if kv == "int8"
                                                                 else np.float32)))
        jeng.kv_cache = tuple(jnp.asarray(c.numpy()) for c in eng.kv_cache)
        if kv == "int8":
            for layer, scales in enumerate(eng.kv_scales):
                s = rng.uniform(0.01, 1.0, size=scales.shape).astype(ml_dtypes.bfloat16)
                scales.copy_(tpar.to_torch(s))
            jeng.kv_scales = tuple(jnp.asarray(tpar.jax_scale_pages(tpar.to_numpy(s)))
                                   for s in eng.kv_scales)
    before = [c.clone() for c in src.kv_cache]
    mapping = [(2, 3), (5, 1), (7, 7)]
    src.swap_blocks_to(dst, mapping)
    jsrc.swap_blocks_to(jdst, mapping)
    for cache, jcache in zip(dst.kv_cache, jdst.kv_cache):
        assert np.array_equal(cache.numpy(), np.asarray(jcache))
    assert all(torch.equal(a, b) for a, b in zip(before, src.kv_cache))
    if kv == "int8":
        for layer, (scales, jscales) in enumerate(zip(dst.kv_scales, jdst.kv_scales)):
            pages = tpar.jax_scale_pages(tpar.to_numpy(scales))
            assert np.array_equal(pages.view(np.int16), np.asarray(jscales).view(np.int16))
            assert torch.equal(scales[3], src.kv_scales[layer][2])
