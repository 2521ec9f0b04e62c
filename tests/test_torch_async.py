"""Async scheduling in the port: the engine dispatches step N+1 before step
N's sampled tokens reach the host, and decode rows read their input token
from step N's device output (the worker's feed).

- The eight scenarios of ``tests/test_async_scheduling.py`` on the port's
  ``LlmService`` on the CPU: the async service (depth 2) gives the tokens of
  the port's synchronous service.
- The port's async service against the JAX package's async service on
  ``tiny_trained`` and tiny-random (JAX weights carried across): identical
  tokens and text, greedy and seeded.
- ``prev_map`` and the feed gather against the JAX worker's on the same
  metadata.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from test_torch_engine import (
    JAX,
    PORT,
    _jax_worker,
    _port_worker,
    _tiny_random,
    _tiny_trained,
    make_group,
    make_scheduler,
    mod,
)

from atoma_infer_tpu_torch.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
    ValidationConfig,
)
from atoma_infer_tpu_torch.engine.llm_service import LlmService
from atoma_infer_tpu_torch.entrypoints.offline import build_tiny_random
from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

torch.set_num_threads(2)


def make_service(async_scheduling: bool, **scheduler_overrides) -> LlmService:
    model, params, tokenizer = build_tiny_random("cpu")
    sched = dict(
        max_num_batched_tokens=512,
        max_num_sequences=16,
        max_model_len=512,
        async_scheduling=async_scheduling,
    )
    sched.update(scheduler_overrides)
    config = EngineConfig(
        model=ModelConfig(model_name="tiny-random", dtype="float32"),
        cache=CacheConfig(
            block_size=16,
            num_device_blocks_override=128,
            num_host_blocks_override=32,
        ),
        scheduler=SchedulerConfig(**sched),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    return LlmService.start(
        config, model=model, params=params, tokenizer=tokenizer, device="cpu"
    )


def run_batch(async_scheduling: bool, requests, **scheduler_overrides):
    """Run a list of GenerateRequests through a fresh service; return the
    results in request order. Every block must return to the pool."""

    async def scenario():
        service = make_service(async_scheduling, **scheduler_overrides)
        task = asyncio.create_task(service.engine.run())
        futs = [await service.handle_request(r) for r in requests]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=120)
        service.stop()
        task.cancel()
        free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
        assert free == 128, "every block returns to the pool"
        return results

    return asyncio.run(scenario())


def greedy_requests(n=12, max_new=10, seed_text="the quick brown fox"):
    return [
        GenerateRequest(
            request_id=f"req-{i}",
            inputs=f"{seed_text} {i} " * (1 + i % 4),
            parameters=GenerateParameters(max_new_tokens=max_new),
        )
        for i in range(n)
    ]


class TestAsyncScheduling:
    def test_greedy_token_identical_to_sync(self):
        reqs = greedy_requests()
        sync = run_batch(False, reqs)
        asy = run_batch(True, reqs)
        for s, a in zip(sync, asy):
            assert a.outputs[0].token_ids == s.outputs[0].token_ids
            assert a.outputs[0].output_text == s.outputs[0].output_text
            assert a.outputs[0].finish_reason == s.outputs[0].finish_reason
            assert a.outputs[0].logprobs == pytest.approx(
                s.outputs[0].logprobs, abs=1e-5
            )

    def test_seeded_sampling_identical_to_sync(self):
        reqs = [
            GenerateRequest(
                request_id=f"samp-{i}",
                inputs=f"sample prompt {i}",
                parameters=GenerateParameters(
                    max_new_tokens=8,
                    do_sample=True,
                    seed=1234 + i,
                    temperature=0.9,
                    top_k=40,
                ),
            )
            for i in range(8)
        ]
        sync = run_batch(False, reqs)
        asy = run_batch(True, reqs)
        for s, a in zip(sync, asy):
            assert a.outputs[0].token_ids == s.outputs[0].token_ids

    def test_penalties_fall_back_to_sync_path(self):
        # Repetition penalty needs real token values on the host each step —
        # the engine must run these synchronously and still be correct.
        reqs = [
            GenerateRequest(
                request_id=f"pen-{i}",
                inputs=f"penalized prompt {i}",
                parameters=GenerateParameters(
                    max_new_tokens=8, repetition_penalty=1.3
                ),
            )
            for i in range(4)
        ]
        sync = run_batch(False, reqs)
        asy = run_batch(True, reqs)
        for s, a in zip(sync, asy):
            assert a.outputs[0].token_ids == s.outputs[0].token_ids

    def test_depth2_split_prefill_wave_identical(self):
        """Depth-2 hazard: after a prefill wave splits across two steps, the
        first wave's decode rows read a token sampled by an in-flight step
        OLDER than the feed source — the engine must drop to the sync path
        for that step (llm_engine._async_eligible) to stay token-identical."""
        reqs = greedy_requests(n=12, max_new=10)
        overrides = dict(max_num_batched_tokens=256, max_model_len=256)
        sync = run_batch(False, reqs, **overrides)
        asy = run_batch(True, reqs, async_depth=2, **overrides)
        for s, a in zip(sync, asy):
            assert a.outputs[0].token_ids == s.outputs[0].token_ids
            assert a.outputs[0].logprobs == pytest.approx(
                s.outputs[0].logprobs, abs=1e-5
            )

    def test_depth2_staggered_finish_truncation(self):
        """Sequences finishing while newer steps are in flight must not leak
        trailing placeholder tokens into their outputs (depth-2 cleanup in
        _patch_sequence)."""
        reqs = [
            GenerateRequest(
                request_id=f"stag-{i}",
                inputs=f"staggered prompt {i}",
                parameters=GenerateParameters(max_new_tokens=3 + 2 * i),
            )
            for i in range(6)
        ]
        sync = run_batch(False, reqs)
        asy = run_batch(True, reqs, async_depth=2)
        for s, a in zip(sync, asy):
            want = len(s.outputs[0].token_ids)
            assert len(a.outputs[0].token_ids) == want
            assert len(a.outputs[0].logprobs) == want
            assert a.outputs[0].token_ids == s.outputs[0].token_ids
            assert a.outputs[0].output_text == s.outputs[0].output_text

    def test_streaming_chunks_match_final(self):
        async def scenario():
            service = make_service(True)
            task = asyncio.create_task(service.engine.run())
            fut, queue = await service.handle_request(
                GenerateRequest(
                    request_id="stream-async",
                    inputs="stream me asynchronously",
                    parameters=GenerateParameters(max_new_tokens=6),
                ),
                stream=True,
            )
            chunks = []
            while True:
                chunk = await asyncio.wait_for(queue.get(), timeout=60)
                if chunk is None:
                    break
                chunks.append(chunk)
            result = await asyncio.wait_for(fut, timeout=60)
            service.stop()
            task.cancel()
            return chunks, result

        chunks, result = asyncio.run(scenario())
        assert 1 <= len(chunks) <= 6
        assert chunks[-1].finished
        assert [c.token_id for c in chunks] == result.outputs[0].token_ids
        assert "".join(c.text for c in chunks) == result.outputs[0].output_text

    def test_chunked_prefill_async(self):
        reqs = greedy_requests(n=6, max_new=6, seed_text="long " * 12)
        sync = run_batch(
            False, reqs, enable_chunked_prefill=True, max_num_batched_tokens=64
        )
        asy = run_batch(
            True, reqs, enable_chunked_prefill=True, max_num_batched_tokens=64
        )
        for s, a in zip(sync, asy):
            assert a.outputs[0].token_ids == s.outputs[0].token_ids

    def test_abort_mid_flight_async(self):
        async def scenario():
            service = make_service(True)
            task = asyncio.create_task(service.engine.run())
            fut = await service.handle_request(
                GenerateRequest(
                    request_id="abort-async",
                    inputs="a long request " * 8,
                    parameters=GenerateParameters(max_new_tokens=200),
                )
            )
            await asyncio.sleep(0.4)
            assert service.engine.abort_request("abort-async")
            result = await asyncio.wait_for(fut, timeout=60)
            service.stop()
            task.cancel()
            free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
            return result, free

        result, free = asyncio.run(scenario())
        tokens = result.outputs[0].token_ids
        assert len(tokens) < 200
        # The in-flight steps were resolved before the abort: no placeholder
        # (token 0, never sampled by this model's byte vocabulary here)
        # survives, and the logprobs are real.
        assert len(result.outputs[0].logprobs) == len(tokens)
        assert all(lp < 0 for lp in result.outputs[0].logprobs)
        assert free == 128


def test_service_from_config_starts_async():
    """``async_scheduling`` from a configuration reaches the engine (the
    service no longer refuses it); the depth defaults to 2."""
    raw = {
        "inference": {"model_name": "tiny-random"},
        "scheduler": {"max_model_len": 2048, "async_scheduling": True},
    }
    service = LlmService.start(EngineConfig.from_dict(raw), device="cpu")
    assert service.engine._async_scheduling
    assert service.engine._async_depth == 2
    service.stop()


def test_finished_group_is_forgotten_before_its_future_resolves():
    """The engine finishes groups on its executor thread while the loop
    thread resumes whoever awaits the response: by the time an awaiter sees
    the result, the engine must no longer hold the group (a warmup that
    returned with its groups still registered made the warmup-then-serve
    check fail under load). The step thread is held inside ``_finish_group``
    until the awaiter's callback has run, so the order is the only thing
    that decides."""
    service = make_service(True)
    engine = service.engine

    async def scenario():
        loop = asyncio.get_running_loop()
        fut = await service.handle_request(GenerateRequest(
            request_id="finish-order", inputs="hi",
            parameters=GenerateParameters(max_new_tokens=2)))
        group = engine._groups["finish-order"]
        seen = []
        fut.add_done_callback(lambda f: seen.append("finish-order" in engine._groups))

        class HeldPop(dict):
            def pop(self, key, default=None):
                deadline = time.monotonic() + 10
                while not seen and time.monotonic() < deadline:
                    time.sleep(0.005)
                return super().pop(key, default)

        engine._stream_queues = HeldPop()
        await loop.run_in_executor(None, engine._finish_group, group)
        await asyncio.wait_for(fut, timeout=10)
        service.stop()
        return seen

    assert asyncio.run(scenario()) == [False]


# ------------------------------------------------------ against the JAX one
def _serve_async(pkg, model, params, tokenizer, prompts, *, sampled):
    cfg = mod(pkg, "config")
    types = mod(pkg, "types")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(model_name="injected", dtype="float32"),
        cache=cfg.CacheConfig(
            block_size=16, num_device_blocks_override=128, num_host_blocks_override=32
        ),
        scheduler=cfg.SchedulerConfig(
            max_num_batched_tokens=128, max_num_sequences=8, max_model_len=256,
            enable_chunked_prefill=True, use_native_core=False,
            async_scheduling=True, async_depth=2,
        ),
        validation=cfg.ValidationConfig(max_input_tokens=128, max_total_tokens=256),
    )
    kw = dict(device="cpu") if pkg == PORT else {}
    service = mod(pkg, "engine.llm_service").LlmService.start(
        config, model=model, params=params, tokenizer=tokenizer, **kw
    )

    async def scenario():
        task = asyncio.create_task(service.engine.run())
        futs = []
        for i, prompt in enumerate(prompts):
            params_kw = dict(max_new_tokens=6 + 3 * i)
            if sampled:
                # The sampled path (Gumbel noise, masks) with top_k=1: the two
                # packages draw different noise by design (threefry against a
                # torch.Generator), so only a one-token nucleus compares.
                params_kw.update(do_sample=True, temperature=0.7, top_k=1, seed=100 + i)
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
    assert free == 128, "every block returns to the pool"
    return [(r.outputs[0].token_ids, r.outputs[0].output_text) for r in results]


ASYNC_PROMPTS = [f"async prompt {i} " * (1 + i) for i in range(5)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("name", ["tiny_trained", "tiny_random"])
def test_async_service_matches_jax_async_service(name, sampled):
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    build = {"tiny_trained": _tiny_trained, "tiny_random": _tiny_random}[name]
    (jmodel, jparams, jtok), (pmodel, ptok) = build()
    want = _serve_async(JAX, jmodel, jparams, jtok, ASYNC_PROMPTS, sampled=sampled)
    got = _serve_async(PORT, pmodel, params_from_numpy(jparams), ptok, ASYNC_PROMPTS,
                       sampled=sampled)
    assert got == want


# ------------------------------------------------- the feed, step by step
def test_feed_map_and_gather_match_jax_worker():
    """Step 1 prefills three groups; step 2 decodes them with placeholder
    host tokens and the feed (step 1's device tokens, one sequence left
    out). Both workers build the same ``prev_map`` and, gathering through
    it, sample the same tokens as a step that was given the real ones."""
    blocks, host_blocks = 32, 8
    jsched, jworker, jparams = _jax_worker(blocks, host_blocks)
    psched, pworker = _port_worker(blocks, host_blocks, jparams)
    scheds = {JAX: jsched, PORT: psched}
    workers = {JAX: jworker, PORT: pworker}
    groups = {}
    for pkg in (JAX, PORT):
        groups[pkg] = {}
        rng = np.random.default_rng(11)
        for i in range(3):
            prompt = rng.integers(3, 1000, size=10 + 7 * i).tolist()
            g = make_group(pkg, f"g{i}", prompt, max_new_tokens=8, seq_ids=[10 + i])
            groups[pkg][g.request_id] = g
            scheds[pkg].add_sequence_group(g)

    spied = {JAX: [], PORT: []}  # each dispatch's prev_map (None: no feed)
    jax_invoke = jworker._invoke

    def spy(model_input, sampling_arrays, sample_steps, sampling, prev=None):
        spied[JAX].append(None if prev is None else np.asarray(prev[1]))
        return jax_invoke(model_input, sampling_arrays, sample_steps, sampling, prev=prev)

    jworker._invoke = spy
    port_invoke = pworker._invoke

    def port_spy(model_input, sampling_arrays, sample_steps, sampling, prev=None):
        spied[PORT].append(None if prev is None else prev[1].copy())
        return port_invoke(model_input, sampling_arrays, sample_steps, sampling, prev)

    pworker._invoke = port_spy

    def request(pkg, metadata, out):
        return mod(pkg, "sequence").ExecuteModelRequest(
            sequence_groups_metadata=metadata,
            blocks_to_swap_in=out.blocks_to_swap_in,
            blocks_to_swap_out=out.blocks_to_swap_out,
            blocks_to_copy=out.blocks_to_copy,
        )

    results = {}
    for pkg in (JAX, PORT):
        sched, worker = scheds[pkg], workers[pkg]
        meta1, out1 = sched.schedule()
        assert all(m.is_prompt for m in meta1)
        step1 = worker.dispatch(request(pkg, meta1, out1))
        real = {
            sid: o.output_token
            for g in step1.complete().values() for sid, o in g.outputs.items()
        }
        # Book step 1 as the async engine does: computed counts advance and
        # each sequence gets a placeholder token in place of its sample.
        for m in meta1:
            groups[pkg][m.request_id].update_num_computed_tokens(m.token_chunk_size)
            for sid in m.seq_data:
                groups[pkg][m.request_id].sequences[sid].append_token_id(0, 0.0)
        rows = {sid: r for r, sid in enumerate(s for m in meta1 for s in m.seq_data)}
        del rows[11]  # one sequence is read from the host (its placeholder)
        meta2, out2 = sched.schedule()
        assert all(not m.is_prompt for m in meta2)
        fed = worker.dispatch(request(pkg, meta2, out2), feed=(step1.tokens_device, rows)).complete()
        # The same step with the real tokens on the host and no feed.
        for m in meta2:
            for sid in m.seq_data:
                seq = groups[pkg][m.request_id].sequences[sid]
                if sid != 11:
                    seq.sequence_data.output_token_ids[-1] = real[sid]
        plain = worker.execute_model(request(pkg, meta2, out2))
        results[pkg] = (fed, plain, real)

    assert spied[PORT][0] is None and spied[JAX][0] is None
    assert spied[PORT][2] is None and spied[JAX][2] is None
    prev_map = spied[PORT][1]
    np.testing.assert_array_equal(prev_map, spied[JAX][1])
    assert sorted(prev_map[prev_map >= 0].tolist()) == [0, 2]
    (jfed, jplain, jreal), (pfed, pplain, preal) = results[JAX], results[PORT]
    assert preal == jreal
    for rid in jfed:
        for sid, o in jfed[rid].outputs.items():
            assert pfed[rid].outputs[sid].output_token == o.output_token
            assert abs(pfed[rid].outputs[sid].logprob - o.logprob) < 1e-4
            if sid != 11:
                # Fed from the device = given the real token on the host.
                assert o.output_token == jplain[rid].outputs[sid].output_token
                assert pfed[rid].outputs[sid].output_token == (
                    pplain[rid].outputs[sid].output_token)
