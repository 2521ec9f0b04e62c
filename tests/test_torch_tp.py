"""Tensor parallelism through the port's service, against the JAX service.

Mirrors ``tests/test_engine_tp.py``: the same tiny Llama (f32, 2 layers,
8 q heads, head dim 32), its JAX weights carried across
(``params_from_numpy``, then every rank's ``shard_params``), served by the
port at ``tensor_parallel_size`` 2 and 4 — one process per rank, gloo on the
CPU — against the JAX ``LlmService`` at the same tp (a mesh of the
conftest's virtual CPU devices) and against the port at tp = 1: greedy tokens
identical, sync and async, with the f32 and the INT8 KV caches, under chunked
prefill, and with tp wider than the kv heads (``kv_repeat``). At tp = 2 over
an INT8 cache each rank's cache equals the JAX sharded cache's shard within
one INT8 step and its scales bit for bit. Mixtral at tp = 2, with expert
parallelism (4 experts) and without it (3 experts: the intermediate dim is
split), serves the port's tp = 1 tokens. A follower that fails while it
builds its service fails rank 0's start. Bad head divisibility is
refused. ``warmup`` under TP runs its waves (eagerly on the CPU, through
stub step graphs from the factory), and the service then serves JAX's tokens (``tiny_trained`` from its directory, sync and async;
pipeline parallelism beside TP: ``tests/test_torch_pipeline.py``).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tpar

torch.set_num_threads(2)

WIDTHS = dict(
    vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=4, head_dim=32,
    max_position_embeddings=2048, rope_theta=10000.0, rope_scaling=None,
    tie_word_embeddings=True, eos_token_ids=(1,), bos_token_id=0,
)
PROMPTS = [
    "tensor parallel serving test",
    "a second, rather longer prompt that spans multiple KV blocks " * 3,
    "short",
]


def jax_params(widths, family="llama"):
    if family == "mixtral":
        from atoma_infer_tpu.models.mixtral import Mixtral, MixtralConfig

        model = Mixtral(MixtralConfig(**widths), dtype=jnp.float32)
    else:
        from atoma_infer_tpu.models.llama import Llama, LlamaConfig

        model = Llama(LlamaConfig(**widths), dtype=jnp.float32)
    return model, model.init_params(jax.random.PRNGKey(0))


def jax_service(tp, widths, *, kv_cache_dtype=None, **sched):
    """The JAX ``LlmService`` of ``tests/test_engine_tp.py`` (Python block
    manager, so block ids line up with the port's)."""
    from atoma_infer_tpu.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu.engine.llm_service import LlmService
    from atoma_infer_tpu.entrypoints.offline import ByteTokenizer

    model, params = jax_params(widths)
    kw = dict(max_num_batched_tokens=512, max_num_sequences=16, max_model_len=512,
              enable_chunked_prefill=False, use_native_core=False)
    kw.update(sched)
    config = EngineConfig(
        model=ModelConfig(model_name="tiny-random", dtype="float32", tensor_parallel_size=tp,
                          kv_cache_dtype=kv_cache_dtype),
        cache=CacheConfig(block_size=16, num_device_blocks_override=128,
                          num_host_blocks_override=32),
        scheduler=SchedulerConfig(**kw),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    return LlmService.start(config, model=model, params=params,
                            tokenizer=ByteTokenizer(widths["vocab_size"]))


def jax_generate(service, prompts):
    from atoma_infer_tpu.types import GenerateParameters, GenerateRequest

    async def run():
        task = asyncio.create_task(service.engine.run())
        futs = [await service.handle_request(GenerateRequest(
            request_id=f"req-{i}", inputs=p,
            parameters=GenerateParameters(max_new_tokens=12, do_sample=False)))
            for i, p in enumerate(prompts)]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=180)
        service.stop()
        task.cancel()
        return {r.request_id: list(r.outputs[0].token_ids) for r in results}

    return asyncio.run(run())


def port_service(tp, tmp_path, factory, **kw):
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    config = tpar.tp_engine_config(tp, coordinator_address=tpar.rendezvous_file(tmp_path),
                                   **kw)
    return LlmService.start(config, model_factory=factory, device="cpu")


def port_factory(tmp_path, widths, family="llama"):
    _, params = jax_params(widths, family)
    path = tpar.save_params(tmp_path / f"{family}.npz", params)
    return tpar.npz_factory(path, family, widths)


@pytest.mark.parametrize("tp, async_scheduling", [(2, False), (4, False), (2, True), (4, True)],
                         ids=["tp2-sync", "tp4-sync", "tp2-async", "tp4-async"])
def test_tp_tokens_match_jax_and_tp1(tp, async_scheduling, tmp_path):
    sched = dict(async_scheduling=async_scheduling)
    factory = port_factory(tmp_path, WIDTHS)
    want = jax_generate(jax_service(tp, WIDTHS, **sched), PROMPTS)
    one = tpar.generate(port_service(1, tmp_path, factory, **sched), PROMPTS)
    service = port_service(tp, tmp_path, factory, **sched)
    followers = list(service.followers)
    assert len(followers) == tp - 1
    assert service.group.tp == tp and service.engine.worker.model.local_q_heads == 8 // tp
    got = tpar.generate(service, PROMPTS)
    assert got == want
    assert got == one
    assert [p.exitcode for p in followers] == [0] * (tp - 1)


def test_tp_int8_kv_cache_and_scales_match_jax_shards(tmp_path):
    """tp = 2 over INT8 KV: tokens as JAX's and the port's tp = 1; each
    rank's cache within one INT8 step of the JAX sharded cache's shard, its
    scales bit for bit (JAX keeps them replicated, in 128-lane pages)."""
    from torch_parity import jax_scale_pages

    prompts = PROMPTS[:2]
    factory = port_factory(tmp_path, WIDTHS)
    jsvc = jax_service(2, WIDTHS, kv_cache_dtype="int8")
    want = jax_generate(jsvc, prompts)
    jce = jsvc.engine.worker.cache_engine
    one = tpar.generate(port_service(1, tmp_path, factory, kv_cache_dtype="int8"), prompts)
    ranks = tpar.spawn_ranks(tpar.lockstep_rank, 2, tmp_path, factory.args[0], "llama", WIDTHS,
                             prompts, {}, "int8")
    assert ranks[0]["outputs"] == want == one
    for layer, (jcache, jscales) in enumerate(zip(jce.kv_cache, jce.kv_scales)):
        shards = sorted(jcache.addressable_shards, key=lambda s: s.index[2].start)
        assert len(shards) == 2
        pages = np.asarray(jscales)
        for rank, shard in enumerate(shards):
            got = ranks[rank]["kv_cache"][layer].astype(np.int32)
            ref = np.asarray(shard.data).astype(np.int32)
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() <= 1
            assert (got != 0).any()
            scales = jax_scale_pages(ranks[rank]["kv_scales"][layer])
            assert np.array_equal(scales.view(np.int16), pages.view(np.int16))


def test_tp_chunked_prefill(tmp_path):
    sched = dict(enable_chunked_prefill=True, max_num_batched_tokens=64)
    factory = port_factory(tmp_path, WIDTHS)
    want = jax_generate(jax_service(2, WIDTHS, **sched), PROMPTS[:2])
    one = tpar.generate(port_service(1, tmp_path, factory, **sched), PROMPTS[:2])
    got = tpar.generate(port_service(2, tmp_path, factory, **sched), PROMPTS[:2])
    assert got == want == one


def test_tp_wider_than_kv_heads_copies_them(tmp_path):
    """kv heads 2 at tp = 4 (the 70B-on-16-chips shape): each kv head on
    tp // Hk = 2 ranks; each rank's cache rows hold one kv head."""
    widths = dict(WIDTHS, num_key_value_heads=2)
    factory = port_factory(tmp_path, widths)
    want = jax_generate(jax_service(4, widths), PROMPTS[:2])
    one = tpar.generate(port_service(1, tmp_path, factory), PROMPTS[:2])
    service = port_service(4, tmp_path, factory)
    assert service.engine.worker.cache_engine.kv_cache[0].shape[2] == 2 * 1 * 32
    assert service.engine.worker.model.kv_repeat == 2
    got = tpar.generate(service, PROMPTS[:2])
    assert got == want == one


def test_tp_rejects_bad_head_divisibility(tmp_path, monkeypatch):
    """tp = 3 over 8 q heads: ``ValueError`` before any rank starts."""
    from atoma_infer_tpu_torch.engine import llm_service

    started = []
    monkeypatch.setattr(llm_service, "_follower_main", lambda *a: started.append(a))
    with pytest.raises(ValueError, match="incompatible"):
        port_service(3, tmp_path, tpar.npz_factory(tmp_path / "none.npz", "llama", WIDTHS))
    assert not started


def test_a_failing_follower_fails_the_start(tmp_path):
    """A follower that dies while it builds its service fails rank 0's
    start (within the follower join timeout), and no rank is left alive."""
    import dataclasses
    import multiprocessing

    factory = dataclasses.replace(port_factory(tmp_path, WIDTHS),
                                  build=tpar.npz_model_failing_on_followers)
    before = set(multiprocessing.active_children())
    with pytest.raises(RuntimeError):
        port_service(2, tmp_path, factory)
    assert not [p for p in multiprocessing.active_children() if p not in before]


MIXTRAL = dict(WIDTHS, intermediate_size=96, num_local_experts=4, num_experts_per_tok=2)


@pytest.mark.parametrize("experts", [4, 3], ids=["expert-parallel", "intermediate-split"])
def test_mixtral_tp2_serves_the_tp1_tokens(experts, tmp_path):
    widths = dict(MIXTRAL, num_local_experts=experts)
    factory = port_factory(tmp_path, widths, "mixtral")
    one = tpar.generate(port_service(1, tmp_path, factory), PROMPTS)
    service = port_service(2, tmp_path, factory)
    w1 = service.engine.worker.params["layers"]["w1"]
    assert tuple(w1.shape) == ((2, 2, 128, 96) if experts == 4 else (2, 3, 128, 48))
    assert tpar.generate(service, PROMPTS) == one


def warm_then_generate(service, prompts, **warm):
    """``service.warmup(**warm)`` with the engine loop running, then greedy
    ``prompts`` through the same loop → (warmup seconds, warmup groups left
    in the engine, free device blocks after warmup, {request id: token
    ids}); the service is stopped."""
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    async def run():
        task = asyncio.create_task(service.engine.run())
        try:
            dt = await asyncio.wait_for(service.warmup(**warm), timeout=tpar.RANK_TIMEOUT_S)
            left = [rid for rid in service.engine._groups if rid.startswith("_warmup")]
            free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
            futs = [await service.handle_request(GenerateRequest(
                request_id=f"req-{i}", inputs=p,
                parameters=GenerateParameters(max_new_tokens=12, do_sample=False)))
                for i, p in enumerate(prompts)]
            results = await asyncio.wait_for(asyncio.gather(*futs), timeout=tpar.RANK_TIMEOUT_S)
        finally:
            service.stop()
            task.cancel()
        return dt, left, free, {r.request_id: list(r.outputs[0].token_ids) for r in results}

    return asyncio.run(run())


@pytest.mark.parametrize("graphs", [False, True], ids=["cpu-eager", "stub-graphs"])
def test_warmup_under_tp_names_its_queue_item(graphs, tmp_path):
    """``warmup`` under TP: a CPU rank steps its waves eagerly (no CUDA
    graph on the CPU; on the card every rank captures in segments); with a
    factory's own step graphs (``torch_parity.StubStepGraphs``, replaying by
    recomputing) every step is captured or replayed. Either way it
    completes, leaves no warmup group and every block free, the followers
    exit cleanly, and the service then serves the port's tp = 1 tokens."""
    factory = port_factory(tmp_path, WIDTHS)
    want = tpar.generate(port_service(1, tmp_path, factory), PROMPTS)
    if graphs:
        factory = tpar.npz_factory(factory.args[0], "llama", WIDTHS,
                                   step_graphs=tpar.StubStepGraphs)
    service = port_service(2, tmp_path, factory)
    followers = list(service.followers)
    step_graphs = service.engine.worker.graphs
    assert (step_graphs is not None) == graphs
    dt, left, free, got = warm_then_generate(service, PROMPTS, num_seqs=4, prompt_len=16)
    assert dt > 0 and not left and free == 128
    assert got == want
    if graphs:
        assert step_graphs.graphs and step_graphs.replays
        assert step_graphs.group is service.group
    assert not service.followers
    assert [p.exitcode for p in followers] == [0]


@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_warmup_under_tp_then_serves_jax_tokens(async_scheduling, tmp_path):
    """``tiny_trained`` from its directory at tp = 2 over gloo, each rank
    loading its shard: ``warmup()`` completes, and the requests after it
    get the greedy tokens of JAX's ``LlmService`` at tp = 2 on the same
    directory."""
    from atoma_infer_tpu.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu.engine.llm_service import LlmService as JaxService
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    sched = dict(async_scheduling=async_scheduling)
    jconfig = EngineConfig(
        model=ModelConfig(model_name=tpar.FIXTURE_TINY_TRAINED, dtype="float32",
                          tensor_parallel_size=2),
        cache=CacheConfig(block_size=16, num_device_blocks_override=128,
                          num_host_blocks_override=32),
        scheduler=SchedulerConfig(max_num_batched_tokens=512, max_num_sequences=16,
                                  max_model_len=512, enable_chunked_prefill=False,
                                  use_native_core=False, **sched),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    want = jax_generate(JaxService.start(jconfig, model_dir=tpar.FIXTURE_TINY_TRAINED), PROMPTS)
    config = tpar.tp_engine_config(2, coordinator_address=tpar.rendezvous_file(tmp_path),
                                   **sched)
    config.model.model_name = tpar.FIXTURE_TINY_TRAINED
    service = LlmService.start(config, device="cpu")
    dt, left, free, got = warm_then_generate(service, PROMPTS, num_seqs=4, prompt_len=16)
    assert dt > 0 and not left and free == 128
    assert got == want
