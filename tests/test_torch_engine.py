"""The port's engine stack vs the JAX package's, on the same request streams.

- Scheduler: the port's copy makes the same decisions step for step.
- Worker: per-step sampled tokens and post-step KV caches match the JAX
  ``ModelWorker`` (tokens exact, logprobs atol 1e-4 and caches atol 1e-5:
  the same f32 arithmetic in another order).
- Service: greedy outputs are token-identical to the JAX ``LlmService`` on
  ``tiny_trained`` and on tiny-random (JAX weights carried across), also
  under preemption by recompute and by swap; swaps are bit-exact and every
  block returns to the pool.

Both packages use the Python block manager here, so physical block ids (and
therefore cache contents) line up one to one.
"""

import asyncio
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FIXTURE_TINY_TRAINED as FIXTURE

torch.set_num_threads(2)

JAX, PORT = "atoma_infer_tpu", "atoma_infer_tpu_torch"


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def make_group(pkg, request_id, prompt_tokens, *, max_new_tokens, seq_ids, block_size=16, **params):
    seq_mod = mod(pkg, "sequence")
    sp = mod(pkg, "sampling_params")
    seqs = [
        seq_mod.Sequence(
            seq_id=sid, prompt="", prompt_token_ids=list(prompt_tokens),
            block_size=block_size, eos_token_id=None,
        )
        for sid in seq_ids
    ]
    return seq_mod.SequenceGroup(
        request_id=request_id,
        sequences=seqs,
        next_token_chooser_params=sp.NextTokenChooserParameters(**params),
        stopping_criteria=sp.StoppingCriteriaParameters(max_new_tokens=max_new_tokens),
        best_of=len(seq_ids),
    )


def make_scheduler(pkg, *, blocks, host_blocks, chunked, budget=64, max_seqs=8, spec_tokens=0):
    cfg = mod(pkg, "config")
    sched_cfg = cfg.SchedulerConfig(
        max_num_batched_tokens=budget, max_num_sequences=max_seqs,
        max_model_len=256 if chunked else budget, enable_chunked_prefill=chunked,
        use_native_core=False, num_speculative_tokens=spec_tokens,
    )
    cache_cfg = cfg.CacheConfig.new_from_blocks(16, blocks, host_blocks)
    return mod(pkg, "core.scheduler").Scheduler(sched_cfg, cache_cfg), sched_cfg, cache_cfg


def _request_stream(pkg):
    rng = np.random.default_rng(5)
    groups = []
    for i in range(6):
        prompt = rng.integers(3, 1000, size=int(rng.integers(10, 70))).tolist()
        n = 2 if i % 3 == 2 else 1
        groups.append(
            make_group(
                pkg, f"r{i}", prompt, max_new_tokens=12 + 3 * i,
                seq_ids=[100 * i + j for j in range(n)],
                do_sample=n > 1, top_k=1 if n > 1 else 0, seed=i,
            )
        )
    return groups


def _summary(metadata, outputs):
    return (
        [
            (m.request_id, m.is_prompt, m.token_chunk_size, m.do_sample,
             {k: list(v) for k, v in m.block_tables.items()},
             {k: d.get_num_computed_tokens() for k, d in m.seq_data.items()},
             m.spec_token_ids)
            for m in metadata
        ],
        outputs.num_batched_tokens, list(outputs.blocks_to_swap_in),
        list(outputs.blocks_to_swap_out), list(outputs.blocks_to_copy), outputs.preempted,
    )


def _advance(pkg, scheduler, groups, metadata, tokens):
    """Apply one step's sampled tokens (``tokens[seq_id] = (tok, logprob)``)
    the way the engine does, finishing sequences at their length cap."""
    status = mod(pkg, "sequence").SequenceStatus
    for meta in metadata:
        group = groups[meta.request_id]
        group.update_num_computed_tokens(meta.token_chunk_size)
        if not meta.do_sample:
            continue
        for sid in meta.seq_data:
            seq = group.sequences[sid]
            seq.append_token_id(*tokens[sid])
            if seq.get_output_len() >= group.stopping_criteria.max_new_tokens:
                seq.status = status.FINISHED_LENGTH_CAPPED
                scheduler.free_seq(seq)
    scheduler.remove_finished_sequences()


@pytest.mark.parametrize("spec_tokens", [0, 3])
def test_scheduler_outputs_match_jax_under_pressure(spec_tokens):
    """Tight pool + chunked prefill + best_of groups: preemption by
    recompute AND by swap, same decisions step for step; with n-gram drafts
    scheduled too (the port's copy of the proposer; every draft rejected)."""
    runs = {}
    for pkg in (JAX, PORT):
        sched, _, _ = make_scheduler(
            pkg, blocks=14, host_blocks=32, chunked=True, spec_tokens=spec_tokens
        )
        groups = {g.request_id: g for g in _request_stream(pkg)}
        for g in groups.values():
            sched.add_sequence_group(g)
        trace = []
        for step in range(400):
            if not sched.has_unfinished_seqs():
                break
            metadata, outputs = sched.schedule()
            trace.append(_summary(metadata, outputs))
            # With drafts on, each sequence repeats one token, so its
            # trailing n-gram recurs and the proposer has drafts to offer.
            toks = {
                sid: ((sid if spec_tokens else step * 7 + sid) % 997 + 3, -0.5)
                for m in metadata for sid in m.seq_data
            }
            _advance(pkg, sched, groups, metadata, toks)
        assert not sched.has_unfinished_seqs()
        runs[pkg] = (trace, sched.block_manager.get_num_free_device_blocks())
    assert runs[PORT][0] == runs[JAX][0]
    assert runs[PORT][1] == runs[JAX][1] == 14
    swapped = [t for t in runs[PORT][0] if t[3]]
    preempted = [t for t in runs[PORT][0] if t[5]]
    assert swapped and preempted, "the stream must exercise swap and recompute"
    drafted = [m for t in runs[PORT][0] for m in t[0] if m[-1]]
    assert bool(drafted) == (spec_tokens > 0)


def _jax_worker(blocks, host_blocks):
    from atoma_infer_tpu.engine.cache_engine import CacheEngine
    from atoma_infer_tpu.engine.worker import ModelWorker
    from atoma_infer_tpu.models.llama import Llama
    from atoma_infer_tpu.models.weights import load_hf_config, load_llama_params

    cfg = load_hf_config(FIXTURE)
    model = Llama(cfg, dtype=jnp.float32)
    params = load_llama_params(FIXTURE, cfg, dtype=jnp.float32)
    sched, sched_cfg, cache_cfg = make_scheduler(JAX, blocks=blocks, host_blocks=host_blocks, chunked=True)
    ce = CacheEngine(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        block_size=16, num_device_blocks=blocks, num_host_blocks=host_blocks, dtype=jnp.float32,
    )
    return sched, ModelWorker(model, params, ce, sched_cfg, cache_cfg), params


def _port_worker(blocks, host_blocks, jax_params):
    from atoma_infer_tpu_torch.engine.cache_engine import CacheEngine
    from atoma_infer_tpu_torch.engine.worker import ModelWorker
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import load_hf_config, params_from_numpy

    cfg = load_hf_config(FIXTURE)
    model = Llama(cfg, dtype=torch.float32, device="cpu")
    sched, sched_cfg, cache_cfg = make_scheduler(PORT, blocks=blocks, host_blocks=host_blocks, chunked=True)
    ce = CacheEngine(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        block_size=16, num_device_blocks=blocks, num_host_blocks=host_blocks,
        dtype=torch.float32, device="cpu",
    )
    return sched, ModelWorker(model, params_from_numpy(jax_params), ce, sched_cfg, cache_cfg)


def test_worker_steps_match_jax_worker():
    """Both stacks step through the same stream (tight pool: swaps happen);
    each step's tokens, logprobs and resulting caches agree."""
    blocks, host_blocks = 14, 32
    jsched, jworker, jparams = _jax_worker(blocks, host_blocks)
    psched, pworker = _port_worker(blocks, host_blocks, jparams)
    groups = {pkg: {g.request_id: g for g in _request_stream(pkg)} for pkg in (JAX, PORT)}
    for pkg, sched in ((JAX, jsched), (PORT, psched)):
        for g in groups[pkg].values():
            sched.add_sequence_group(g)
    ExecuteJ = mod(JAX, "sequence").ExecuteModelRequest
    ExecuteP = mod(PORT, "sequence").ExecuteModelRequest
    swaps = 0
    for _ in range(200):
        if not jsched.has_unfinished_seqs():
            break
        jmeta, jout = jsched.schedule()
        pmeta, pout = psched.schedule()
        assert _summary(pmeta, pout) == _summary(jmeta, jout)
        swaps += len(pout.blocks_to_swap_out)
        step_out = []
        for req_cls, worker, meta, out in (
            (ExecuteJ, jworker, jmeta, jout), (ExecuteP, pworker, pmeta, pout)
        ):
            step_out.append(
                worker.execute_model(
                    req_cls(
                        sequence_groups_metadata=meta,
                        blocks_to_swap_in=out.blocks_to_swap_in,
                        blocks_to_swap_out=out.blocks_to_swap_out,
                        blocks_to_copy=out.blocks_to_copy,
                    )
                )
            )
        jres, pres = step_out
        toks = {}
        for rid, gout in jres.items():
            for sid, o in gout.outputs.items():
                p = pres[rid].outputs[sid]
                assert p.output_token == o.output_token
                assert abs(p.logprob - o.logprob) < 1e-4
                toks[sid] = (o.output_token, o.logprob)
        jcache = np.stack([np.asarray(c) for c in jworker.cache_engine.kv_cache])
        pcache = torch.stack(pworker.cache_engine.kv_cache).numpy()
        np.testing.assert_allclose(pcache, jcache, atol=1e-5, rtol=1e-5)
        _advance(JAX, jsched, groups[JAX], jmeta, toks)
        _advance(PORT, psched, groups[PORT], pmeta, toks)
    assert not jsched.has_unfinished_seqs() and not psched.has_unfinished_seqs()
    assert swaps > 0
    assert psched.block_manager.get_num_free_device_blocks() == blocks


def test_swap_round_trip_is_bit_exact():
    from atoma_infer_tpu_torch.engine.cache_engine import CacheEngine

    for dtype in (torch.float32, torch.bfloat16):
        ce = CacheEngine(
            num_layers=2, num_kv_heads=2, head_dim=8, block_size=4,
            num_device_blocks=6, num_host_blocks=4, dtype=dtype, device="cpu",
        )
        gen = torch.Generator().manual_seed(0)
        for c in ce.kv_cache:
            c.copy_(torch.randn(c.shape, generator=gen) * 1e3)
        before = [c.clone() for c in ce.kv_cache]
        assert ce.host_cache.dtype == dtype
        ce.execute([], [(1, 0), (4, 3)], [])
        for c in ce.kv_cache:
            c.zero_()
        ce.execute([(0, 5), (3, 2)], [], [])
        for c, b in zip(ce.kv_cache, before):
            assert torch.equal(c[5], b[1]) and torch.equal(c[2], b[4])
        ce.execute([], [], [(5, 0)])
        for c, b in zip(ce.kv_cache, before):
            assert torch.equal(c[0], b[1])


# ----------------------------------------------------------------- services
def _service(pkg, model, params, tokenizer, *, blocks, best_of, block_size=16):
    cfg = mod(pkg, "config")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(model_name="injected", dtype="float32"),
        cache=cfg.CacheConfig(
            block_size=block_size, num_device_blocks_override=blocks, num_host_blocks_override=64
        ),
        scheduler=cfg.SchedulerConfig(
            max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
            use_native_core=False,
        ),
        validation=cfg.ValidationConfig(best_of=best_of, max_input_tokens=128, max_total_tokens=256),
    )
    service_mod = mod(pkg, "engine.llm_service")
    kw = dict(device="cpu") if pkg == PORT else {}
    return service_mod.LlmService.start(config, model=model, params=params, tokenizer=tokenizer, **kw)


def _serve(pkg, model, params, tokenizer, prompts, *, blocks, best_of=1, max_new=20,
           block_size=16):
    types = mod(pkg, "types")
    service = _service(pkg, model, params, tokenizer, blocks=blocks, best_of=best_of,
                       block_size=block_size)
    ce = service.engine.worker.cache_engine
    swaps = {"out": 0}
    orig_out = ce.swap_out

    def spy_out(mapping):
        swaps["out"] += len(mapping)
        return orig_out(mapping)

    ce.swap_out = spy_out
    metrics = mod(pkg, "server.metrics")
    preempt0 = metrics.PREEMPTIONS.value

    async def scenario():
        task = asyncio.create_task(service.engine.run())
        futs = []
        for i, prompt in enumerate(prompts):
            params_kw = dict(max_new_tokens=max_new)
            if best_of > 1:
                # do_sample with top_k=1: greedy tokens, but a 2-sequence
                # group — the kind the scheduler preempts by swap.
                params_kw.update(best_of=best_of, do_sample=True, top_k=1, seed=i)
            futs.append(
                await service.handle_request(
                    types.GenerateRequest(
                        request_id=f"req-{i}", inputs=prompt,
                        parameters=types.GenerateParameters(**params_kw),
                    )
                )
            )
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
        service.stop()
        task.cancel()
        return results

    results = asyncio.run(scenario())
    free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
    assert free == blocks, "every block returns to the pool"
    tokens = [[tuple(o.token_ids) for o in r.outputs] for r in results]
    return tokens, swaps["out"], metrics.PREEMPTIONS.value - preempt0


def _tiny_trained():
    from atoma_infer_tpu.models.llama import Llama as JaxLlama
    from atoma_infer_tpu.models.weights import load_hf_config, load_llama_params
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import load_hf_config as port_cfg

    class Tok:  # tiny_trained's vocab is 1024: bytes + 3
        def encode(self, text):
            return type("E", (), {"ids": [b + 3 for b in text.encode("latin-1")]})()

        def decode(self, ids, skip_special_tokens=True):
            return bytes(min(255, max(0, i - 3)) for i in ids).decode("latin-1")

    jcfg = load_hf_config(FIXTURE)
    jmodel = JaxLlama(jcfg, dtype=jnp.float32)
    jparams = load_llama_params(FIXTURE, jcfg, dtype=jnp.float32)
    pmodel = Llama(port_cfg(FIXTURE), dtype=torch.float32, device="cpu")
    return (jmodel, jparams, Tok()), (pmodel, Tok())


def _tiny_random():
    from atoma_infer_tpu.entrypoints.offline import build_tiny_random as jax_build
    from atoma_infer_tpu_torch.entrypoints.offline import build_tiny_random

    jmodel, jparams, jtok = jax_build()
    pmodel, _, ptok = build_tiny_random("cpu")
    return (jmodel, jparams, jtok), (pmodel, ptok)


def _group3_random():
    """A random 2-layer Llama with 3 query heads per kv head (Hq 6, Hk 2,
    D 32), Llama-3.2-3B's grouping at a tiny width; JAX's weights are
    carried across to the port."""
    import jax

    from atoma_infer_tpu.entrypoints.offline import ByteTokenizer as JaxByteTokenizer
    from atoma_infer_tpu.models.llama import Llama as JaxLlama
    from atoma_infer_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig

    widths = dict(
        vocab_size=512, hidden_size=192, intermediate_size=384, num_hidden_layers=2,
        num_attention_heads=6, num_key_value_heads=2, head_dim=32,
        max_position_embeddings=2048, rope_theta=10000.0, rope_scaling=None,
        tie_word_embeddings=True, eos_token_ids=(1,), bos_token_id=0,
    )
    jmodel = JaxLlama(JaxLlamaConfig(**widths), dtype=jnp.float32)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    pmodel = Llama(LlamaConfig(**widths), dtype=torch.float32, device="cpu")
    return (jmodel, jparams, JaxByteTokenizer(512)), (pmodel, ByteTokenizer(512))


PROMPTS = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]

SERVICE_CASES = {
    # name: (model builder, device blocks, best_of, expect swap, expect
    # recompute, block size)
    "tiny_trained": (_tiny_trained, 128, 1, False, False, 16),
    "tiny_trained_recompute": (_tiny_trained, 9, 1, False, True, 16),
    "tiny_random": (_tiny_random, 128, 1, False, False, 16),
    "tiny_random_swap": (_tiny_random, 12, 2, True, True, 16),
    # Pages of 64 slots: the ragged kernel stages them in key tiles.
    "tiny_trained_block64": (_tiny_trained, 32, 1, False, False, 64),
    # 3 query heads per kv head: the fused decode kernel's G = 3.
    "group3_random": (_group3_random, 128, 1, False, False, 16),
}


@pytest.mark.parametrize("name", sorted(SERVICE_CASES))
def test_service_greedy_tokens_match_jax(name):
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    build, blocks, best_of, want_swap, want_preempt, block_size = SERVICE_CASES[name]
    (jmodel, jparams, jtok), (pmodel, ptok) = build()
    kw = dict(blocks=blocks, best_of=best_of, block_size=block_size)
    want, _, _ = _serve(JAX, jmodel, jparams, jtok, PROMPTS, **kw)
    got, swapped, preempted = _serve(
        PORT, pmodel, params_from_numpy(jparams), ptok, PROMPTS, **kw
    )
    assert got == want
    assert (swapped > 0) == want_swap
    assert (preempted > 0) == want_preempt


@pytest.mark.parametrize("raw, item", [
    # Pipeline parallelism is served: alone, beside tensor parallelism, and
    # with the ranks spread over hosts, each case starts (item None) and
    # serves the tokens of the service without stages.
    ({"inference": {"tensor_parallel_size": 2, "pipeline_parallel_size": 2}}, None),
    ({"inference": {"pipeline_parallel_size": 2}}, None),
    ({"inference": {"num_hosts": 2, "tensor_parallel_size": 2, "pipeline_parallel_size": 2}},
     None),
    # Prefix caching and float16, refused here until they were ported,
    # start and serve too (tiny-random is an f32 model whatever the dtype,
    # in both packages; fp16 serving itself: tests/test_torch_float16.py).
    ({"cache": {"enable_prefix_caching": True}}, None),
    ({"inference": {"dtype": "float16"}}, None),
], ids=["tp", "pp", "multihost", "prefix_caching", "float16"])
def test_service_rejects_unported_features(raw, item, tmp_path):
    """A feature the port lacks is refused at start, naming its Queue 1
    item. Pipeline parallelism, prefix caching and float16, refused here
    until they were ported, start: pipeline stages cover the layers, and
    each case serves ``tiny-random``'s greedy tokens of the service at
    pp = 1, tp = 1 (over two hosts, each a spawned process started from its
    configuration alone)."""
    import torch_parity as tpar
    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    raw = {key: dict(section) for key, section in raw.items()}
    raw.setdefault("inference", {})["model_name"] = "tiny-random"
    raw.setdefault("scheduler", {})["max_model_len"] = 2048
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, Queue 1: {item}"):
            LlmService.start(EngineConfig.from_dict(raw), device="cpu")
        return
    prompts = PROMPTS[:2]
    m = raw["inference"]
    if m.get("num_hosts", 1) > 1:
        ranks = tpar.spawn_ranks(tpar.host_rank, m["num_hosts"], tmp_path, raw, prompts)
        assert ranks[1]["outputs"] == ranks[0]["outputs"]
        got, stages = ranks[0]["outputs"], ranks[0]["stages"]
    else:
        if m.get("tensor_parallel_size", 1) > 1:
            m["coordinator_address"] = tpar.rendezvous_file(tmp_path)
        service = LlmService.start(EngineConfig.from_dict(raw), device="cpu")
        workers = getattr(service.engine.worker, "cache_engines", None)
        stages = [1, 1] if workers is None else [ce.num_layers for ce in workers]
        assert service.config.cache.enable_prefix_caching == bool(raw.get("cache"))
        got = tpar.generate(service, prompts)
    one = {"inference": {"model_name": "tiny-random"}, "scheduler": {"max_model_len": 2048}}
    assert stages == [1, 1]
    assert got == tpar.generate(LlmService.start(EngineConfig.from_dict(one), device="cpu"),
                                prompts)


def test_async_service_with_speculation_serves_like_jax():
    """Async scheduling beside speculative decoding (K = 3) starts and
    serves ``tiny_trained`` token-identical to the JAX async service with
    the same K; every step that carries drafts runs synchronously: nothing
    is in flight when it is dispatched, and it takes no feed."""
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    (jmodel, jparams, jtok), (pmodel, ptok) = _tiny_trained()
    prompts = ["the cat sat on the mat. the cat sat on the", "one two three one two three"]
    results, dispatched = {}, []
    for pkg in (JAX, PORT):
        cfg, types = mod(pkg, "config"), mod(pkg, "types")
        config = cfg.EngineConfig(
            model=cfg.ModelConfig(model_name="injected", dtype="float32"),
            cache=cfg.CacheConfig(block_size=16, num_device_blocks_override=64,
                                  num_host_blocks_override=0),
            scheduler=cfg.SchedulerConfig(
                max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
                use_native_core=False, async_scheduling=True, num_speculative_tokens=3,
                spec_ngram_min=1),
            validation=cfg.ValidationConfig(max_input_tokens=128, max_total_tokens=256),
        )
        service_mod = mod(pkg, "engine.llm_service")
        if pkg == JAX:
            service = service_mod.LlmService.start(config, model=jmodel, params=jparams,
                                                   tokenizer=jtok)
        else:
            service = service_mod.LlmService.start(
                config, model=pmodel, params=params_from_numpy(jparams), tokenizer=ptok,
                device="cpu")
            engine, dispatch = service.engine, service.engine.worker.dispatch

            def spy(request, feed=None, engine=engine, dispatch=dispatch):
                drafts = any(m.spec_token_ids for m in request.sequence_groups_metadata)
                dispatched.append((drafts, feed is not None, len(engine._async_queue)))
                return dispatch(request, feed=feed)

            engine.worker.dispatch = spy

        async def scenario(service=service, types=types):
            task = asyncio.create_task(service.engine.run())
            futs = [await service.handle_request(types.GenerateRequest(
                request_id=f"req-{i}", inputs=p,
                parameters=types.GenerateParameters(max_new_tokens=30)))
                for i, p in enumerate(prompts)]
            out = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
            service.stop()
            task.cancel()
            return [(tuple(r.outputs[0].token_ids), r.outputs[0].output_text) for r in out]

        results[pkg] = asyncio.run(scenario())
    assert results[PORT] == results[JAX]
    verify = [(feed, in_flight) for drafts, feed, in_flight in dispatched if drafts]
    assert verify and all(step == (False, 0) for step in verify)
    assert any(feed for drafts, feed, _ in dispatched if not drafts), "no step ran ahead"


def test_float16_model_directory_is_refused_before_loading():
    """A float16 service from a model directory (the loader's path), once
    refused before any weight was read, loads the weights in fp16 over an
    fp16 KV cache and serves: its greedy tokens those of the same service
    in f32 up to fp16 rounding (the first token identical; the comparison
    with JAX's fp16 service is ``tests/test_torch_float16.py``)."""
    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    import torch_parity as tpar

    out = {}
    for dtype in ("float16", "float32"):
        config = EngineConfig.from_dict({
            "inference": {"model_name": FIXTURE, "dtype": dtype},
            "scheduler": {"max_model_len": 256},
        })
        service = LlmService.start(config, model_dir=FIXTURE, device="cpu")
        assert service.engine.worker.model.dtype == getattr(torch, dtype)
        assert service.engine.worker.cache_engine.kv_cache[0].dtype == getattr(torch, dtype)
        out[dtype] = tpar.generate(service, PROMPTS[:2], max_new_tokens=8)
    assert all(len(t) == 8 for t in out["float16"].values())
    assert [t[0] for t in out["float16"].values()] == [t[0] for t in out["float32"].values()]
