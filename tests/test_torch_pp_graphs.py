"""Pipeline stages replayed as CUDA graphs (``engine/pp_worker.py`` on
``engine/cuda_graphs.py``), the host side on the CPU.

- Stage keys: a stage before the last is keyed by its forward's static
  arguments alone (``StageKey``), whatever the sampling flags; the last
  stage by ``step_graph_key``.
- The widest step the scheduler can make fits every stage's static inputs,
  the hidden state after stage 0 included.
- ``LlmService`` from ``tiny_trained`` (f32) at pp 2, with chunked prefill,
  a penalty request and a seeded sampled request, every stage's step through
  ``StepGraphs`` whose capture is a stub replaying by recomputing into the
  captured outputs: the greedy tokens are the JAX pp 2 service's and the
  port's eager pp 2's exactly, the seeded request's the eager one's; every
  stage's keys replay; two cohorts replay one key each with their own
  tokens; a graph's outputs are read (the next stage's fill, the host copy
  of the tokens) before its next replay.
- The graph reserve a device: both stages, the LM head and sampler once and
  each stage's layers on one device; each device its own stages' share
  when spread.
- Which workers have stage graphs: CUDA stages at any tp (PP × TP: in
  segments between the stage group's collectives), never CPU stages.
- ``warmup`` at pp 2 captures stage graphs, and the traffic after it
  replays them.

Capture and replay on the card run in ``chip_smoke.py`` (``run_pp_services``).
"""

import asyncio

import numpy as np
import pytest
import torch

from atoma_infer_tpu_torch.engine import cuda_graphs
from atoma_infer_tpu_torch.engine import worker as worker_mod
from atoma_infer_tpu_torch.engine.cuda_graphs import (
    MAX_GRAPHS, StageKey, StepGraphs, page_capacity, packed_capacity, stage_graph_key,
    step_graph_key, token_capacity,
)
from atoma_infer_tpu_torch.engine.input_prep import bucket
from atoma_infer_tpu_torch.engine.worker import ModelWorker

from test_torch_engine import JAX, PORT, _tiny_trained, mod
from test_torch_step_graphs import BS, _metas, _step

torch.set_num_threads(2)


# --------------------------------------------------------------- stage keys
LAYOUTS = {
    # name: (prompt chunks, decode rows)
    "decode": ((), 3),
    "wide-decode": ((), 13),
    "mixed": ((30,), 3),
    "prefill": ((50, 7), 0),
}
SAMPLING = [
    dict(),
    dict(do_sample=True, seed=3, temperature=0.7, top_p=0.9),
    dict(repetition_penalty=1.3, frequency_penalty=0.4),
    dict(do_sample=True, seed=5, typical_p=0.8),
]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stage_keys_ignore_sampling_before_the_last_stage(layout):
    """The same batch under four sampling options: a stage before the last
    has one key, its forward's (T, S, P, decode_only, max_q_len); the last
    stage's is ``step_graph_key`` without a feed, one a sampling option."""
    chunks, decodes = LAYOUTS[layout]
    firsts, lasts = set(), set()
    for params in SAMPLING:
        model_input, sampling, _ = _step(_metas(chunks, decodes, **params))
        T = model_input.token_ids.shape[0]
        S, P = model_input.block_tables.shape
        first = stage_graph_key(model_input, sampling, last=False)
        assert type(first) is StageKey
        assert first == (T, S, P, model_input.decode_only, model_input.max_q_len)
        last = stage_graph_key(model_input, sampling, last=True)
        assert last == step_graph_key(model_input, sampling, feed=False)
        assert type(last) is type(step_graph_key(model_input, sampling, feed=False))
        firsts.add(first)
        lasts.add(last)
    assert len(firsts) == 1
    assert len(lasts) == len(SAMPLING)


# ------------------------------------------------- the widest step fits
PP_SCHEDULERS = {
    # name: (token budget, sequences, max_model_len)
    "budget256": (256, 64, 2048),
    "budget32": (32, 8, 512),
    "unchunked": (2048, 256, 2048),
}
HIDDEN = 24


def _stage_graphs(budget, seqs, max_len):
    return StepGraphs(bucket(seqs), page_capacity(max_len, BS), token_capacity(budget))


def _stage_views(graphs, metas, max_pages, *, last):
    """Take a stage's views of one step as the pipelined worker fills
    them: the packed metadata, the sampling tensors and noise on the last
    stage only, the hidden state [T, HIDDEN]."""
    model_input, sampling, _ = _step(metas, max_pages=max_pages)
    packed = ModelWorker._pack_metadata(model_input, np.zeros(model_input.seq_lens.shape[0]))
    S = model_input.seq_lens.shape[0]
    T = model_input.token_ids.shape[0]
    arrays = sampling.to_device("cpu", model_input.sample_mask) if last else {}
    views = graphs._views(packed, arrays, torch.zeros(S, 4) if last else None, None,
                          torch.zeros(T, HIDDEN))
    assert views[4].shape == (T, HIDDEN)
    return T


@pytest.mark.parametrize("name", sorted(PP_SCHEDULERS))
def test_widest_step_fits_every_stage(name):
    """The budget in chunks over every slot, and a budget chunk beside
    every other sequence decoding, fit a middle stage's and the last
    stage's static inputs, hidden state included; one token past the
    budget's bucket does not."""
    budget, seqs, max_len = PP_SCHEDULERS[name]
    pages = page_capacity(max_len, BS)
    context = max(max_len - 1 - budget, 1)
    widest = [_metas([budget // seqs] * seqs, 0, context=context, pages=pages),
              _metas([budget - seqs + 1], seqs - 1, context=context, pages=pages)]
    for last in (False, True):
        graphs = _stage_graphs(budget, seqs, max_len)
        for metas in widest:
            assert _stage_views(graphs, metas, pages, last=last) <= graphs.max_tokens
        assert graphs._static["hidden"].shape == (token_capacity(budget), HIDDEN)
        over = _metas([token_capacity(budget) + 1 - (seqs - 1)], seqs - 1, context=context,
                      pages=pages)
        with pytest.raises(ValueError, match="does not fit"):
            _stage_views(_stage_graphs(budget, seqs, max_len), over, pages, last=last)


def test_hidden_fill_copies_in_place():
    """A stage's hidden input is one buffer for every key, filled by a
    copy before each run; a wider hidden state, or another width, is
    refused."""
    graphs = StepGraphs(8, 8, 64)
    packed = torch.arange(10, dtype=torch.int32)
    h = torch.randn(16, HIDDEN)
    views = graphs._views(packed, {}, None, None, h)
    graphs._fill(views, packed, {}, 1, None, None, h)
    assert torch.equal(views[4], h)
    assert views[4].data_ptr() == graphs._static["hidden"].data_ptr()
    h8 = torch.randn(8, HIDDEN)
    views8 = graphs._views(packed, {}, None, None, h8)
    graphs._fill(views8, packed, {}, 1, None, None, h8)
    assert torch.equal(graphs._static["hidden"][:8], h8)
    with pytest.raises(ValueError, match="does not fit"):
        graphs._views(packed, {}, None, None, torch.zeros(65, HIDDEN))
    with pytest.raises(ValueError, match="does not fit"):
        graphs._views(packed, {}, None, None, torch.zeros(8, HIDDEN + 1))


# ---------------------------------------------------------- the services
BUDGET = 32
REQUESTS = [
    ("the cat sat on the mat " * 8, dict(max_new_tokens=20)),
    ("abc abc abc abc abc", dict(max_new_tokens=24, repetition_penalty=1.3,
                                 frequency_penalty=0.4)),
    ("one two three one two three one " * 4, dict(max_new_tokens=16)),
    ("hello world. hello world. hello", dict(max_new_tokens=20)),
    ("a seeded request, sampled", dict(max_new_tokens=16, do_sample=True, seed=11,
                                       temperature=0.8, top_p=0.9)),
]
SEEDED = 4
GREEDY = [i for i in range(len(REQUESTS)) if i != SEEDED]
# Greedy requests whose decode steps take one key in either cohort.
ALIKE = [(p, dict(max_new_tokens=n)) for p, n in (
    ("hello world. hello", 14), ("abc abc abc", 18), ("one two three", 12), ("the cat sat", 16))]


def _pp_service(pkg, pp=2):
    """``tiny_trained`` (f32) at ``pp`` stages on the CPU, chunked prefill
    at a BUDGET-token budget, on the native block manager (JAX's cohorts
    share one pool only on it: ``tests/test_torch_pipeline.py``)."""
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    (jmodel, jparams, jtok), (pmodel, ptok) = _tiny_trained()
    cfg = mod(pkg, "config")
    config = cfg.EngineConfig(
        model=cfg.ModelConfig(model_name="injected", dtype="float32",
                              pipeline_parallel_size=pp),
        cache=cfg.CacheConfig(block_size=BS, num_device_blocks_override=128,
                              num_host_blocks_override=64),
        scheduler=cfg.SchedulerConfig(max_num_batched_tokens=BUDGET, max_num_sequences=8,
                                      max_model_len=512, enable_chunked_prefill=True),
        validation=cfg.ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    service_mod = mod(pkg, "engine.llm_service")
    if pkg == JAX:
        return service_mod.LlmService.start(config, model=jmodel, params=jparams, tokenizer=jtok)
    return service_mod.LlmService.start(config, model=pmodel, params=params_from_numpy(jparams),
                                        tokenizer=ptok, device="cpu")


def _serve(service, requests, *, late=(2, 3, 4), warmup=None):
    """Serve ``requests``; those in ``late`` are admitted just before engine
    step 4, so that the first ones fill cohort 0 and the late ones cohort 1.
    ``warmup``: ``service.warmup`` keywords, run first. Returns the tokens
    by request. Every block returns to the pool."""
    pkg = PORT if type(service).__module__.startswith("atoma_infer_tpu_torch") else JAX
    types = mod(pkg, "types")
    engine = service.engine

    async def scenario():
        task = asyncio.create_task(engine.run())
        if warmup is not None:
            await service.warmup(**warmup)
            while engine._has_unfinished():
                await asyncio.sleep(0.01)
        held = []
        engine.add_request, add = (lambda *a: held.append(a)), engine.add_request
        futs = [await service.handle_request(types.GenerateRequest(
            request_id=f"req-{i}", inputs=prompt, parameters=types.GenerateParameters(**kw)))
            for i, (prompt, kw) in enumerate(requests)]
        engine.add_request = add
        step, count = engine.step, [0]

        def counted():
            count[0] += 1
            if count[0] == 4:
                for i in late:
                    add(*held[i])
            return step()

        engine.step = counted
        for i, args in enumerate(held):
            if i not in late:
                add(*args)
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=180)
        service.stop()
        task.cancel()
        return results

    results = asyncio.run(scenario())
    bm = engine.schedulers[0].block_manager
    assert bm.get_num_free_device_blocks() == service.config.cache.num_device_blocks
    return [tuple(r.outputs[0].token_ids) for r in results]


def _copy_into(old, new):
    if isinstance(old, torch.Tensor):
        old.copy_(new)
    elif old is not None:
        for o, n in zip(old, new):
            _copy_into(o, n)


class _Record:
    """What the stub stage graphs saw: every graph run (stage, cohort, key,
    captured before, replayed), and the graph outputs a replay handed out
    that nothing has read yet (by data pointer)."""

    def __init__(self):
        self.runs = []
        self.unread = set()
        self.cohort = None
        self.warm = None   # the run count when warmup ended


def _stub_stage_graphs(monkeypatch, record):
    """Every stage's step through ``StepGraphs`` (one a stage, sharing one
    pool dict), whose capture is a stub replaying by recomputing into the
    captured outputs. A replay first asserts that the outputs of its
    previous replay were read — by the next stage's fill (a hidden state) or
    the host copy of the tokens (the packed outputs) —, as the card's stream
    order needs; then it hands its outputs out."""

    class Replay:
        def __init__(self, step, views, outputs, watched):
            self.step, self.views, self.outputs, self.watched = step, views, outputs, watched

        @torch.inference_mode()
        def replay(self):
            ptr = self.watched.data_ptr()
            assert ptr not in record.unread, "a graph replayed before its outputs were read"
            _copy_into(self.outputs, self.step(*self.views))
            record.unread.add(ptr)

    def capture(self, step, views):
        outputs = step(*views)
        # A stage before the last hands out its hidden state, the last its
        # packed tokens and logprobs.
        watched = outputs[0] if len(outputs) == 1 else outputs[2]
        return cuda_graphs._Graph(Replay(step, views, outputs, watched), views, outputs, {})

    monkeypatch.setattr(cuda_graphs.StepGraphs, "_capture", capture)
    fill = cuda_graphs.StepGraphs._fill

    def read_fill(self, views, packed, sampling, version, gumbel, prev, hidden=None):
        if hidden is not None:
            record.unread.discard(hidden.data_ptr())
        return fill(self, views, packed, sampling, version, gumbel, prev, hidden)

    monkeypatch.setattr(cuda_graphs.StepGraphs, "_fill", read_fill)

    def to_host(t):
        record.unread.discard(t.data_ptr())
        return t.clone(), None

    # On the CPU the host copy is the tensor itself, which a later replay of
    # the same graph overwrites; the card copies to pinned memory.
    monkeypatch.setattr(worker_mod, "_to_host", to_host)

    def watch(service):
        engine, worker, cfg = service.engine, service.engine.worker, service.config.scheduler
        assert worker.graphs is None and all(st.graphs is None for st in worker.stages)
        pools = {}
        for s, stage in enumerate(worker.stages):
            stage.graphs = StepGraphs(bucket(cfg.max_num_sequences),
                                      page_capacity(cfg.max_model_len, BS),
                                      token_capacity(cfg.max_num_batched_tokens), pools=pools)
            run = stage.graphs.run

            def spy(key, *args, s=s, graphs=stage.graphs, run=run):
                before, replays = key in graphs.graphs, graphs.replays
                out = run(key, *args)
                record.runs.append((s, record.cohort, key, before, graphs.replays > replays))
                return out

            stage.graphs.run = spy
        dispatch = worker.dispatch

        def dispatched(request, feed=None):
            # The engine turns to its next cohort before it dispatches.
            record.cohort = (engine._next_cohort - 1) % len(engine.schedulers)
            return dispatch(request, feed=feed)

        worker.dispatch = dispatched

    return watch


def test_pp2_stage_graphs_serve_like_jax_and_eager(monkeypatch):
    """Chunked prompts, a penalty request and a seeded sampled one at pp 2:
    through stub stage graphs the greedy tokens are the JAX pp 2 service's
    and the port's eager pp 2's, the seeded request's the eager one's.
    Every stage's keys replay: decode, mixed and penalty steps; a stage
    before the last replays one graph for steps the last stage keys apart
    by their sampling."""
    want = _serve(_pp_service(JAX), REQUESTS)
    eager = _serve(_pp_service(PORT), REQUESTS)
    record = _Record()
    service = _pp_service(PORT)
    _stub_stage_graphs(monkeypatch, record)(service)
    graphed = _serve(service, REQUESTS)
    assert [eager[i] for i in GREEDY] == [want[i] for i in GREEDY]
    assert graphed == eager
    assert len(graphed[SEEDED]) == REQUESTS[SEEDED][1]["max_new_tokens"]
    for s in (0, 1):
        replayed = {key for st, _, key, _, again in record.runs if st == s and again}
        assert any(k.decode_only if s == 0 else type(k) is cuda_graphs.DecodeKey
                   for k in replayed), s
        assert any(not k.decode_only for k in replayed if hasattr(k, "decode_only")), s
    last_keys = {key for st, _, key, _, _ in record.runs if st == 1}
    assert any(getattr(k, "needs_penalties", False) for k in last_keys)
    assert any(k.needs_sampling for k in last_keys)
    # Each step ran both stages, stage 0 first.
    assert [st for st, *_ in record.runs] == [0, 1] * (len(record.runs) // 2)
    firsts = {record.runs[i][2] for i in range(0, len(record.runs), 2)}
    assert len(firsts) < len(last_keys)


@pytest.mark.parametrize("requests, late", [(REQUESTS, (2, 3, 4)), (ALIKE, (2, 3))],
                         ids=["mixed-options", "alike"])
def test_two_cohorts_share_a_stage_graph(monkeypatch, requests, late):
    """Cohorts 0 and 1 step the same keys in turn: every stage replays one
    graph for both, each cohort gets its own tokens (those of the eager
    pp 2 service), and no replay overwrites outputs that were not read."""
    eager = _serve(_pp_service(PORT), requests, late=late)
    record = _Record()
    service = _pp_service(PORT)
    _stub_stage_graphs(monkeypatch, record)(service)
    assert _serve(service, requests, late=late) == eager
    for s in (0, 1):
        cohorts = {}
        for st, cohort, key, _, again in record.runs:
            if st == s and again:
                cohorts.setdefault(key, set()).add(cohort)
        assert any(c == {0, 1} for c in cohorts.values()), s
    assert not record.unread


def test_warmup_at_pp2_captures_and_traffic_replays(monkeypatch):
    """``warmup`` at pp 2 captures both stages' graphs; the traffic after
    it replays them, and its tokens are the eager service's. Every key of
    the traffic's greedy pure-decode steps at the smallest page bucket was
    captured in the warmup on both stages: its first wave reaches them
    whatever the cohorts its requests join (which keys of the larger
    buckets the waves reach depends on how their steps interleave)."""
    eager = _serve(_pp_service(PORT), REQUESTS)
    record = _Record()
    service = _pp_service(PORT)
    _stub_stage_graphs(monkeypatch, record)(service)
    warm_at = []
    warmup = service.warmup

    async def counted(**kw):
        dt = await warmup(**kw)
        warm_at.append(len(record.runs))
        return dt

    service.warmup = counted
    assert _serve(service, REQUESTS, warmup=dict(num_seqs=4, prompt_len=16, max_new=18)) == eager
    (n,) = warm_at
    warm, traffic = record.runs[:n], record.runs[n:]
    for s in (0, 1):
        captured = {key for st, _, key, before, _ in warm if st == s and not before}
        assert captured, s
        assert any(again for st, *_, again in traffic if st == s), s
    decode = {(st, key) for st, _, key, _, _ in traffic
              if (type(key) is cuda_graphs.DecodeKey and not key.needs_sampling
                  or type(key) is StageKey and key.decode_only) and key.P == 8}
    warmed = {(st, key) for st, _, key, _, _ in warm}
    assert {st for st, _ in decode} == {0, 1}
    assert decode <= warmed


# ----------------------------------------------------------- the reserve
def _reserve_case():
    from atoma_infer_tpu_torch.config import SchedulerConfig
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=1000, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=5, num_attention_heads=4, num_key_value_heads=2,
                      head_dim=16)
    sched = SchedulerConfig(max_num_batched_tokens=200, max_num_sequences=48,
                            max_model_len=2048, enable_chunked_prefill=True)
    return cfg, sched


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_stage_reserve_on_one_device_counts_both_stages(quantized):
    """pp 2 on one device: the single-stage reserve (the LM head and sampler
    once, every layer's graphs), plus stage 1's packed metadata and hidden
    input, plus stage 0's graphs' hidden outputs; one pool."""
    from atoma_infer_tpu_torch.engine.llm_service import (
        GRAPH_BYTES_PER_LAYER, graph_pool_bytes, graph_reserve_bytes,
        stage_graph_reserve_bytes,
    )
    from atoma_infer_tpu_torch.engine.sampler import PENALTY_WINDOW

    cfg, sched = _reserve_case()
    dev = torch.device("cuda", 0)
    S, T, P = 64, 256, 128   # the buckets of 48 sequences, the budget 200, 2,048 keys
    hidden = T * 64 * 2
    (got,) = stage_graph_reserve_bytes(cfg, sched, 16, [(0, 3), (3, 5)], [dev, dev],
                                       hidden_bytes=2, quantized=quantized).values()
    one = graph_reserve_bytes(cfg, sched, 16, quantized=quantized)
    assert got == one + 4 * packed_capacity(S, P, T) + hidden + (MAX_GRAPHS + 1) * hidden
    # Against pp 1: the layers' graphs are counted once a layer, the pool
    # (the last stage's, the widest) once.
    assert graph_pool_bytes(cfg, sched, 16, quantized=quantized) > graph_pool_bytes(
        cfg, sched, 16, quantized=quantized, sampler=False)
    assert one - graph_pool_bytes(cfg, sched, 16, quantized=quantized) - \
        (MAX_GRAPHS + 1) * GRAPH_BYTES_PER_LAYER * 5 == 4 * (
            S * 1000 + packed_capacity(S, P, T) + S * (8 + PENALTY_WINDOW))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
def test_stage_reserve_spread_over_two_devices(quantized):
    """A card a stage: each takes its own stages' share — stage 0 its
    packed metadata, its graphs' hidden outputs, its layers' graphs and a
    pool without the sampler; stage 1 the rest, the sampler's rows and
    tensors with it. Together they are the one-device reserve and one more
    pool."""
    from atoma_infer_tpu_torch.engine.llm_service import (
        GRAPH_BYTES_PER_LAYER, graph_pool_bytes, stage_graph_reserve_bytes,
    )
    from atoma_infer_tpu_torch.engine.sampler import PENALTY_WINDOW

    cfg, sched = _reserve_case()
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    S, T, P = 64, 256, 128
    hidden = T * 64 * 4
    spread = stage_graph_reserve_bytes(cfg, sched, 16, [(0, 3), (3, 5)], [d0, d1],
                                       hidden_bytes=4, quantized=quantized)
    packed = 4 * packed_capacity(S, P, T)
    layer = (MAX_GRAPHS + 1) * GRAPH_BYTES_PER_LAYER
    forward = graph_pool_bytes(cfg, sched, 16, quantized=quantized, sampler=False)
    pool = graph_pool_bytes(cfg, sched, 16, quantized=quantized)
    assert spread[d0] == packed + (MAX_GRAPHS + 1) * hidden + 3 * layer + forward
    assert spread[d1] == (packed + hidden + 4 * (S * 1000 + S * (8 + PENALTY_WINDOW))
                          + 2 * layer + pool)
    (one,) = stage_graph_reserve_bytes(cfg, sched, 16, [(0, 3), (3, 5)], [d0, d0],
                                       hidden_bytes=4, quantized=quantized).values()
    assert spread[d0] + spread[d1] == one + forward


def test_stage_static_inputs_stay_within_their_reserve(monkeypatch):
    """After a pp 2 service through stub stage graphs, each stage's static
    inputs are within its share of the reserve: stage 0 its packed
    metadata, stage 1 the packed metadata, the hidden input and the
    sampler's tensors."""
    from atoma_infer_tpu_torch.engine.sampler import PENALTY_WINDOW

    record = _Record()
    service = _pp_service(PORT)
    _stub_stage_graphs(monkeypatch, record)(service)
    _serve(service, REQUESTS)
    cfg, sched = service.engine.worker.model.config, service.config.scheduler
    S, T = bucket(sched.max_num_sequences), token_capacity(sched.max_num_batched_tokens)
    P = page_capacity(sched.max_model_len, BS)
    packed = 4 * packed_capacity(S, P, T)
    first, last = (st.graphs for st in service.engine.worker.stages)
    assert "hidden" not in first._static and "noise" not in first._static
    assert 0 < first.static_bytes <= packed
    assert last._static["hidden"].shape == (T, cfg.hidden_size)
    assert first.static_bytes < last.static_bytes <= packed + 4 * T * cfg.hidden_size + 4 * (
        S * cfg.vocab_size + S * (8 + PENALTY_WINDOW))


# ----------------------------------------- which workers have graphs
class _StubCache:
    def __init__(self, device):
        self.device = torch.device(device)


class _StubGroup:
    def __init__(self, tp):
        self.tp = tp


class _StubModel:
    def __init__(self, tp):
        self.tp = tp
        self.group = _StubGroup(tp) if tp > 1 else None


@pytest.mark.parametrize("devices, tp, flag, want", [
    (("cuda:0", "cuda:0"), 1, True, True),
    (("cuda:0", "cuda:1"), 1, True, True),
    (("cuda:0", "cuda:0", "cuda:0"), 1, True, True),
    (("cuda:0", "cuda:0"), 2, True, True),      # PP x TP: segments between the collectives
    (("cuda:0", "cuda:0"), 1, False, False),    # the caller asked for none
    (("cpu", "cpu"), 1, True, False),           # no CUDA graph on the CPU
    (("cpu", "cpu"), 2, True, False),
], ids=["one-card", "two-cards", "pp3", "pp-x-tp", "off", "cpu", "cpu-pp-x-tp"])
def test_stage_graphs_only_on_cuda_at_tp1(devices, tp, flag, want, monkeypatch):
    """A graph set a stage, sharing one pool dict, when every stage is on
    the card, whatever the rank's tp (under TP each stage's graphs cut at
    the collectives of its own group); on the CPU every stage steps
    eagerly. The single-stage ``graphs`` is None either way."""
    from atoma_infer_tpu_torch.config import CacheConfig, SchedulerConfig
    from atoma_infer_tpu_torch.engine.pp_worker import PipelinedModelWorker

    zeros = torch.zeros
    # The worker's null feed on a device this CPU has not: allocate it here.
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(*a, **k))
    n = len(devices)
    worker = PipelinedModelWorker(
        [_StubModel(tp) for _ in devices], [{} for _ in devices],
        [_StubCache(d) for d in devices], [(i, i + 1) for i in range(n)],
        SchedulerConfig(max_num_batched_tokens=64, max_num_sequences=8, max_model_len=256,
                        enable_chunked_prefill=True),
        CacheConfig(block_size=BS), cuda_graphs=flag)
    monkeypatch.undo()
    assert worker.graphs is None
    graphs = [st.graphs for st in worker.stages]
    if not want:
        assert graphs == [None] * n
        return
    assert all(isinstance(g, StepGraphs) for g in graphs)
    assert len({id(g) for g in graphs}) == n
    assert all(g._pools is graphs[0]._pools for g in graphs)
    assert all(g.max_tokens == 64 and g.max_rows == 8 for g in graphs)
    assert [g.group for g in graphs] == [st.model.group for st in worker.stages]


def test_cpu_pp2_service_has_no_stage_graphs():
    service = _pp_service(PORT)
    worker = service.engine.worker
    assert worker.graphs is None and all(st.graphs is None for st in worker.stages)
    service.stop()
