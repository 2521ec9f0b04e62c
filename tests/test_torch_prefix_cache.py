"""Prefix caching in the port, against the JAX package's.

Mirrors ``tests/test_prefix_cache.py`` (the ``CachedBlockAllocator``: hash
hits, revival, LRU eviction, exhaustion) and
``tests/test_prefix_cache_e2e.py`` (the block manager's cached allocation,
the cap at ``prompt_len - 1``, eviction without a leak, and the service:
fewer prefill tokens for a shared prefix, the same tokens with caching and
without) on the port. Then the port's ``LlmService`` with
``enable_prefix_caching`` against JAX's on ``tiny_trained`` (f32, from its
directory), over waves of requests that share prefixes — a wave admitted
after the one before it finished, so that it finds computed blocks; under a
small pool, the third wave finds some of the first one's blocks evicted —
in each setup: synchronous and async, the native and the Python block
manager, an INT8 KV cache, tp 2 under eviction pressure, pp 2. In each, the
greedy tokens are identical, and so is every scheduling pass's work: which
request takes a prefill chunk, its size, and the tokens already computed
when it is scheduled (the cached prefix right after admission).
"""

import asyncio
import importlib
import itertools

import pytest
import torch

import torch_parity as tpar
from torch_parity import FIXTURE_TINY_TRAINED as FIXTURE

from atoma_infer_tpu_torch.core.block import BlockDevice
from atoma_infer_tpu_torch.core.block_allocator import BlockAllocatorError, CachedBlockAllocator
from atoma_infer_tpu_torch.core.block_manager import BlockSpaceManager
from atoma_infer_tpu_torch.sampling_params import (
    NextTokenChooserParameters,
    StoppingCriteriaParameters,
)
from atoma_infer_tpu_torch.sequence import Sequence, SequenceGroup

torch.set_num_threads(2)

JAX, PORT = "atoma_infer_tpu", "atoma_infer_tpu_torch"
BS = 16
_ids = itertools.count()


# ------------------------------------------------ the cached allocator
def make_alloc(n=4):
    return CachedBlockAllocator(BlockDevice.DEVICE, 16, n)


class TestCachedBlockAllocator:
    def test_hash_hit_shares_block(self):
        a = make_alloc()
        b1, b2 = a.allocate(block_hash=42), a.allocate(block_hash=42)
        assert b1 is b2 and b1.ref_count == 2

    def test_revive_after_free(self):
        a = make_alloc()
        b1 = a.allocate(block_hash=7)
        num = b1.block_number
        a.free(b1)
        assert a.get_num_free_blocks() == 4  # evictable counts as free
        b2 = a.allocate(block_hash=7)
        assert b2.block_number == num and b2.ref_count == 1

    def test_eviction_lru_order(self):
        a = make_alloc(n=2)
        b1, b2 = a.allocate(block_hash=1), a.allocate(block_hash=2)
        a.free(b1)
        a.free(b2)
        b1.last_accessed, b2.last_accessed = 1.0, 2.0
        assert a.allocate().block_number == b1.block_number  # the LRU block
        assert a.allocate(block_hash=2).block_number == b2.block_number

    def test_exhaustion(self):
        a = make_alloc(n=1)
        a.allocate(block_hash=1)
        with pytest.raises(BlockAllocatorError):
            a.allocate(block_hash=2)

    def test_unhashed_blocks_not_cached(self):
        a = make_alloc()
        a.free(a.allocate())
        assert a.evictor.num_blocks == 0  # a plain free list, no LRU entry


# -------------------------------------------------------- the block manager
def dummy_prompt(request_id, prompt_length, first=None):
    tokens = list(range(prompt_length))
    if first is not None:
        tokens[0] = first
    seq = Sequence(seq_id=next(_ids), prompt="", prompt_token_ids=tokens, block_size=BS)
    group = SequenceGroup(request_id=request_id, sequences=[seq],
                          next_token_chooser_params=NextTokenChooserParameters(),
                          stopping_criteria=StoppingCriteriaParameters(max_new_tokens=16))
    return seq, group


def make_manager(blocks=64, native=False):
    if native:
        from atoma_infer_tpu_torch.native.block_manager import NativeBlockSpaceManager as cls
    else:
        cls = BlockSpaceManager
    return cls(BS, blocks, 8, enable_prefix_caching=True)


def complete_prefill(bm, seq, group):
    remaining = seq.sequence_data.get_num_uncomputed_tokens()
    if remaining:
        group.update_num_computed_tokens(remaining)
    bm.compute_full_blocks_in_sequence(seq)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
class TestManagerPrefixReuse:
    def test_second_request_hits_cached_prefix(self, native):
        bm = make_manager(native=native)
        seq1, g1 = dummy_prompt("r1", 4 * BS + 3)
        bm.allocate(g1)
        assert seq1.sequence_data.get_num_computed_tokens() == 0
        complete_prefill(bm, seq1, g1)
        table1 = bm.get_block_table_ids(seq1.seq_id)
        seq2, g2 = dummy_prompt("r2", 4 * BS + 3)
        bm.allocate(g2)
        assert seq2.sequence_data.get_num_computed_tokens() == 4 * BS
        table2 = bm.get_block_table_ids(seq2.seq_id)
        assert table2[:4] == table1[:4] and table2[4] != table1[4]

    def test_revive_after_free(self, native):
        bm = make_manager(native=native)
        seq1, g1 = dummy_prompt("r1", 3 * BS)
        bm.allocate(g1)
        complete_prefill(bm, seq1, g1)
        bm.free(seq1)  # the blocks go to the evictor, revivable
        seq2, g2 = dummy_prompt("r2", 3 * BS)
        bm.allocate(g2)
        assert seq2.sequence_data.get_num_computed_tokens() == 3 * BS - 1  # prompt_len - 1

    def test_different_prefix_no_hit(self, native):
        bm = make_manager(native=native)
        seq1, g1 = dummy_prompt("r1", 2 * BS)
        bm.allocate(g1)
        complete_prefill(bm, seq1, g1)
        seq2, g2 = dummy_prompt("r2", 2 * BS, first=9999)  # diverges at token 0
        bm.allocate(g2)
        assert seq2.sequence_data.get_num_computed_tokens() == 0

    def test_eviction_under_pressure_no_leak(self, native):
        bm = make_manager(blocks=8, native=native)
        for r in range(4):
            seq, g = dummy_prompt(f"r{r}", 3 * BS, first=1000 + r)
            bm.allocate(g)
            complete_prefill(bm, seq, g)
            bm.free(seq)
        assert bm.get_num_free_device_blocks() == 8  # free or evictable: the pool whole

    def test_partial_block_prompt_not_hashed(self, native):
        bm = make_manager(native=native)
        seq1, g1 = dummy_prompt("r1", BS - 1)
        bm.allocate(g1)
        complete_prefill(bm, seq1, g1)
        seq2, g2 = dummy_prompt("r2", BS - 1)
        bm.allocate(g2)
        assert seq2.sequence_data.get_num_computed_tokens() == 0


# ------------------------------------------------------------ the service
PREFIX = "shared prefix " * 24  # 336 bytes: 21 full blocks of 16 tokens


def tiny_random_service(enable_prefix_caching):
    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    raw = {"inference": {"model_name": "tiny-random", "dtype": "float32"},
           "cache": {"block_size": BS, "num_device_blocks_override": 128,
                     "num_host_blocks_override": 16,
                     "enable_prefix_caching": enable_prefix_caching},
           "scheduler": {"max_num_batched_tokens": 512, "max_num_sequences": 16,
                         "max_model_len": 512},
           "validation": {"max_input_tokens": 400, "max_total_tokens": 512}}
    return LlmService.start(EngineConfig.from_dict(raw), device="cpu")


def prefill_tokens(service):
    """A spy on the scheduler: prefill tokens scheduled per request."""
    chunks = {}
    inner = service.engine.scheduler.schedule

    def spy():
        metadata, outputs = inner()
        for m in metadata:
            if m.is_prompt:
                chunks[m.request_id] = chunks.get(m.request_id, 0) + m.token_chunk_size
        return metadata, outputs

    service.engine.scheduler.schedule = spy
    return chunks


class TestServicePrefixCaching:
    def test_second_request_computes_fewer_tokens(self):
        service = tiny_random_service(True)
        chunks = prefill_tokens(service)
        waves = [[PREFIX + "tail one"], [PREFIX + "tail two"]]
        got = serve_waves(PORT, service, waves, max_new=8)
        assert all(len(t) == 8 for t in got.values())
        assert chunks["w1-0"] <= chunks["w0-0"] - 128, chunks

    def test_outputs_identical_with_and_without_caching(self):
        waves = [[PREFIX + "tail one"], [PREFIX + "tail two", "something unrelated"]]
        assert serve_waves(PORT, tiny_random_service(True), waves) == \
            serve_waves(PORT, tiny_random_service(False), waves)

    def test_concurrent_identical_prompts(self):
        got = serve_waves(PORT, tiny_random_service(True), [[PREFIX + "same tail"] * 4])
        assert len({tuple(t) for t in got.values()}) == 1  # greedy: identical


def serve_waves(pkg, service, waves, *, max_new=12):
    """Greedy ``waves`` of prompts through a running-loop service of package
    ``pkg``: each wave's requests reach the engine together (held until the
    whole wave is validated, so that no scheduling pass sees part of a
    wave), once the wave before it has finished and every scheduler of the
    service has dropped it (JAX's engine resolves a finished request before
    its cohort's scheduler drops it, so at pp 2 a wave released at once
    could see a stale count and join another cohort). Returns {request id:
    token ids} and stops the service."""
    types = importlib.import_module(f"{pkg}.types")
    engine = service.engine
    add, held = engine.add_request, []
    engine.add_request = lambda *args: held.append(args)

    async def run():
        task = asyncio.create_task(engine.run())
        out = {}
        for w, prompts in enumerate(waves):
            futs = [await service.handle_request(types.GenerateRequest(
                request_id=f"w{w}-{i}", inputs=p,
                parameters=types.GenerateParameters(max_new_tokens=max_new, do_sample=False)))
                for i, p in enumerate(prompts)]
            deadline = asyncio.get_running_loop().time() + 60
            while any(s.get_num_unfinished_seq_groups() for s in engine.schedulers):
                assert asyncio.get_running_loop().time() < deadline, "a wave never drained"
                await asyncio.sleep(0.001)
            for args in held:
                add(*args)
            held.clear()
            for r in await asyncio.wait_for(asyncio.gather(*futs), timeout=180):
                out[r.request_id] = list(r.outputs[0].token_ids)
        service.stop()
        task.cancel()
        return out

    return asyncio.run(run())


def spy_schedules(service):
    """Record every scheduling pass of every cohort's scheduler: (cohort,
    [(request, is_prompt, chunk, tokens computed when scheduled)]), and
    each request's prompt tokens."""
    log, lens = [], {}
    for c, scheduler in enumerate(service.engine.schedulers):
        inner = scheduler.schedule

        def spy(inner=inner, c=c):
            metadata, outputs = inner()
            log.append((c, [(m.request_id, m.is_prompt, m.token_chunk_size,
                             [d.get_num_computed_tokens() for d in m.seq_data.values()])
                            for m in metadata]))
            for m in metadata:
                lens[m.request_id] = next(iter(m.seq_data.values())).get_prompt_len()
            return metadata, outputs

        scheduler.schedule = spy
    return log, lens


def admitted(log):
    """{request: tokens computed at its first prefill pass}: the prefix the
    cache gave it at admission."""
    out = {}
    for _, passes in log:
        for rid, is_prompt, _, computed in passes:
            if is_prompt and rid not in out:
                out[rid] = computed
    return out


def tiny_trained_config(pkg, *, tp=1, pp=1, kv=None, blocks=96, coordinator_address=None,
                        **sched):
    cfg = importlib.import_module(f"{pkg}.config")
    kw = dict(max_num_batched_tokens=96, max_num_sequences=8, max_model_len=256,
              enable_chunked_prefill=True)
    kw.update(sched)
    model = dict(model_name=FIXTURE, dtype="float32", tensor_parallel_size=tp,
                 pipeline_parallel_size=pp, kv_cache_dtype=kv)
    if coordinator_address:
        model["coordinator_address"] = coordinator_address
    return cfg.EngineConfig(
        model=cfg.ModelConfig(**model),
        cache=cfg.CacheConfig(block_size=BS, num_device_blocks_override=blocks,
                              num_host_blocks_override=16, enable_prefix_caching=True),
        scheduler=cfg.SchedulerConfig(**kw),
        validation=cfg.ValidationConfig(max_input_tokens=200, max_total_tokens=256),
    )


# Prompts that share prefixes: wave 1 computes them, wave 2 finds them
# computed (a whole prompt cached recomputes its last token), wave 3 brings
# a long prompt of another prefix, and wave 4 the first prefix again, which
# a pool of EVICTING_POOL blocks has evicted for wave 3 (184 prompt tokens).
A, B = "the quick brown fox jumps over the lazy dog. " * 3, "pack my box with five dozen jugs. " * 9
WAVES = [[A + "one", A + "two"], [A + "three", A + "one", "unrelated"], [B + "x"], [A + "four"]]
EVICTING_POOL = 13

SETUPS = {
    # name: (tp, pp, kv, use_native_core, async_scheduling, device blocks)
    "sync-native": (1, 1, None, True, False, 96),
    "async-native": (1, 1, None, True, True, 96),
    "sync-python": (1, 1, None, False, False, 96),
    "async-python": (1, 1, None, False, True, 96),
    "int8kv-native": (1, 1, "int8", True, False, 96),
    "tp2-eviction-native": (2, 1, None, True, False, EVICTING_POOL),
    "pp2-native": (1, 2, None, True, False, 96),
}


@pytest.mark.parametrize("name", list(SETUPS))
def test_prefix_caching_service_matches_jax(name, tmp_path):
    """The port's service with prefix caching against JAX's: the same
    greedy tokens, the same prefill chunks scheduled pass by pass, the same
    tokens already computed when each request is first scheduled (and a
    cache hit in waves 2 and 3); every block back in the pool afterwards."""
    from atoma_infer_tpu.engine.llm_service import LlmService as JaxService

    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    tp, pp, kv, native_core, async_scheduling, blocks = SETUPS[name]
    sched = dict(use_native_core=native_core, async_scheduling=async_scheduling)
    jax_service = JaxService.start(tiny_trained_config(JAX, tp=tp, pp=pp, kv=kv, blocks=blocks,
                                                       **sched), model_dir=FIXTURE)
    jax_log, _ = spy_schedules(jax_service)
    want = serve_waves(JAX, jax_service, WAVES)
    service = LlmService.start(
        tiny_trained_config(PORT, tp=tp, pp=pp, kv=kv, blocks=blocks,
                            coordinator_address=tpar.rendezvous_file(tmp_path), **sched),
        model_dir=FIXTURE, device="cpu")
    assert service.native_core is native_core
    log, lens = spy_schedules(service)
    got = serve_waves(PORT, service, WAVES)
    assert got == want
    assert admitted(log) == admitted(jax_log)
    assert [p for p in log if p[1]] == [p for p in jax_log if p[1]]
    cached = admitted(log)
    assert cached["w1-1"] == [lens["w1-1"] - 1]  # a whole prompt cached: one token recomputed
    assert cached["w1-0"][0] >= BS and cached["w2-0"] == [0]
    # Wave 4's prefix: cached, unless wave 3 evicted it.
    assert (cached["w3-0"] == [0]) == (blocks == EVICTING_POOL), cached
    assert service.block_manager.get_num_free_device_blocks() == blocks


def test_caching_serves_the_tokens_of_no_caching():
    """``tiny_trained`` through the port's service with prefix caching and
    without: the same greedy tokens, fewer prefill tokens computed."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    results, computed = [], []
    for caching in (True, False):
        config = tiny_trained_config(PORT)
        config.cache.enable_prefix_caching = caching
        service = LlmService.start(config, model_dir=FIXTURE, device="cpu")
        log, _ = spy_schedules(service)
        results.append(serve_waves(PORT, service, WAVES))
        computed.append(sum(chunk for _, passes in log for _, is_prompt, chunk, _ in passes
                            if is_prompt))
    assert results[0] == results[1]
    assert computed[0] < computed[1] - 2 * BS, computed
