"""Every single-stage step as a CUDA graph (``engine/cuda_graphs.py``), the
host side on the CPU: prefill, mixed, penalty and verify-with-prefill steps.

- A key fixes the ragged kernels' plan: every step of one key gets one
  ``rpa_mma_plan`` (hypothesis-drawn chunk lengths), and the key's bucketed
  ``max_q_len`` covers the longest chunk and stays within T.
- The packed metadata of the widest step the scheduler can make fits the
  static inputs (``packed_capacity``), hand-built and from a scheduler
  driven past its token budget.
- A mixed key captures, then replays, and takes its place in the LRU
  (``_StubGraph``, which replays by recomputing into the captured outputs).
- The reserve's pool is at least the pool computed at every token bucket,
  the ragged split workspace at the plan's own splits there.
- Services from ``tiny_trained`` with chunked prefill and a penalty request
  give the JAX service's greedy tokens (exactly: the same f32 greedy
  choices), eager and with every step through stub graphs.

Capture and replay on the card run in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from atoma_infer_tpu_torch.config import SchedulerConfig
from atoma_infer_tpu_torch.engine import cuda_graphs
from atoma_infer_tpu_torch.engine.cuda_graphs import (
    DecodeKey, StepGraphs, StepKey, VerifyKey, packed_capacity, page_capacity, step_graph_key,
    token_capacity,
)
from atoma_infer_tpu_torch.engine.input_prep import bucket, prepare_model_input
from atoma_infer_tpu_torch.engine.sampler import SamplingTensors
from atoma_infer_tpu_torch.engine.worker import ModelWorker, feed_map
from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.sampling_params import (
    NextTokenChooserParameters, StoppingCriteriaParameters,
)
from atoma_infer_tpu_torch.sequence import SequenceData, SequenceGroupMetadata

from test_torch_cuda_graphs import _StubGraph, _stub_capture
from test_torch_spec_decode import JAX, PORT, PROMPT, _serve

# An H100's blocks of one ragged instantiation at once (132 SMs, two blocks
# an SM; ``tests/test_torch_rpa_mma.py``), for the plans' splits.
H100_SLOTS = 132 * 2
BS = 16


def _metas(chunks, decodes, *, drafts=(), context=40, pages=None, **params):
    """Prompt chunks first (each the last ``chunk`` tokens of a ``context``
    + chunk prompt), then ``decodes`` decode rows of ``context`` tokens, the
    first ``len(drafts)`` of them carrying those drafts."""
    metas = []
    sid = 0
    for chunk in chunks:
        data = SequenceData([(5 * sid + j) % 900 + 3 for j in range(context + chunk)])
        data.update_num_computed_tokens(context)
        n = pages or -(-(context + chunk) // BS)
        metas.append(SequenceGroupMetadata(
            request_id=f"p{sid}", is_prompt=True, seq_data={sid: data},
            next_token_chooser_params=NextTokenChooserParameters(**params),
            block_tables={sid: list(range(sid * n, (sid + 1) * n))},
            stopping_criteria=StoppingCriteriaParameters(), do_sample=True,
            token_chunk_size=chunk,
        ))
        sid += 1
    for j in range(decodes):
        data = SequenceData([(7 * sid + i) % 900 + 3 for i in range(context)])
        data.update_num_computed_tokens(context - 1)
        d = list(drafts[j]) if j < len(drafts) else []
        n = pages or -(-(context + len(d)) // BS)
        metas.append(SequenceGroupMetadata(
            request_id=f"d{sid}", is_prompt=False, seq_data={sid: data},
            next_token_chooser_params=NextTokenChooserParameters(**params),
            block_tables={sid: list(range(sid * n, (sid + 1) * n))},
            stopping_criteria=StoppingCriteriaParameters(), do_sample=True,
            token_chunk_size=1, spec_token_ids=d or None,
        ))
        sid += 1
    return metas


def _step(metas, *, k=0, feed=False, max_pages=64):
    model_input = prepare_model_input(metas, block_size=BS, max_pages_per_seq=max_pages,
                                      num_spec_tokens=k)
    params = [m.next_token_chooser_params for m in metas]
    sampling = SamplingTensors.build(params, [[] for _ in params],
                                     model_input.seq_lens.shape[0], [0] * len(params))
    return model_input, sampling, step_graph_key(model_input, sampling, feed)


def _plan(S, T, max_q_len, P):
    """The tensor-core ragged plan at Llama-3.1-8B's heads (32 q, 8 kv)."""
    return pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=max_q_len,
                           max_keys=P * BS, group=4, num_kv_heads=8, slots=H100_SLOTS)


# --------------------------------------------------- one plan per key
@settings(max_examples=150, deadline=None)
@given(chunks=st.lists(st.integers(1, 120), min_size=1, max_size=4),
       decodes=st.integers(0, 9), other=st.lists(st.integers(1, 120), min_size=1, max_size=4),
       k=st.sampled_from([0, 2, 4]), drafted=st.integers(0, 3))
def test_every_step_of_a_key_gets_one_ragged_plan(chunks, decodes, other, k, drafted):
    """Two steps with the same number of rows and tokens, their chunks
    drawn apart: the plan each launches is a function of its key alone (the
    worker's ``max_q_len`` is the key's), and the key's ``max_q_len`` covers
    the step's longest chunk (the CUDA-core kernel's grid) within T."""
    drafts = [[5] * k] * min(drafted, decodes) if k else []
    keys = {}
    for cs in (chunks, other):
        model_input, _, key = _step(_metas(cs, decodes, drafts=drafts), k=k)
        T = model_input.token_ids.shape[0]
        S, P = model_input.block_tables.shape
        q_lens = np.diff(model_input.query_start_loc)[: int(model_input.num_seqs)]
        assert type(key) is StepKey and key.max_q_len == model_input.max_q_len
        assert max(q_lens) <= key.max_q_len <= T
        assert key.max_q_len in {bucket(n) for n in range(1, T + 1)} | {T}
        keys.setdefault(key, set()).add(_plan(S, T, model_input.max_q_len, P))
    assert all(len(plans) == 1 for plans in keys.values())


def test_pure_decode_and_verify_keys_are_unchanged():
    """The kinds measured before every step had a graph keep their keys:
    a pure-decode step (T, S, P, sampling, typical, top-n, feed) and a
    verify step (T, S, P, 1+K, sampling, typical, top-n, True)."""
    _, _, key = _step(_metas((), 3))
    assert key == (8, 8, 8, False, False, 0, False) and type(key) is DecodeKey
    _, _, key = _step(_metas((), 3), feed=True)
    assert key == (8, 8, 8, False, False, 0, True) and type(key) is DecodeKey
    _, _, key = _step(_metas((), 3, drafts=[[5, 6, 7, 8]] * 3), k=4)
    assert key == (16, 8, 8, 5, False, False, 0, True) and type(key) is VerifyKey
    # A verify step beside a prefill chunk: the general key, its max_q_len
    # the chunk's bucket.
    _, _, key = _step(_metas((30,), 3, drafts=[[5, 6, 7, 8]] * 3), k=4)
    assert key == StepKey(64, 8, 8, False, False, False, False, 0, 5, False, 32)


# ------------------------------------------ the widest step fits
SCHEDULERS = {
    # name: (token budget, sequences, drafts a sequence, max_model_len)
    "budget256": (256, 64, 0, 2048),
    "budget256_spec": (256, 8, 4, 2048),
    "budget512_spec": (512, 8, 4, 512),
    "unchunked": (2048, 256, 0, 2048),
}


def _graphs(budget, seqs, k, max_len):
    return StepGraphs(bucket(seqs), page_capacity(max_len, BS), token_capacity(budget), k)


def _fits(graphs, metas, k, feed, max_pages):
    """Pack one step as the worker does (with the feed's ``prev_map``) and
    take the graphs' views of it: ``_buffer`` raises on a step that does
    not fit."""
    model_input, sampling, _ = _step(metas, k=k, feed=feed, max_pages=max_pages)
    prev_map = feed_map(model_input, {}) if feed else None
    packed = ModelWorker._pack_metadata(model_input, np.zeros(model_input.seq_lens.shape[0]),
                                        prev_map)
    arrays = sampling.to_device("cpu", model_input.sample_mask)
    S = model_input.seq_lens.shape[0]
    graphs._views(packed, arrays, torch.zeros(S, 4),
                  torch.zeros(S, dtype=torch.int32) if feed else None)
    return packed.shape[0]


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_widest_step_the_scheduler_can_make_fits_the_static_inputs(name):
    budget, seqs, k, max_len = SCHEDULERS[name]
    graphs = _graphs(budget, seqs, k, max_len)
    pages = page_capacity(max_len, BS)
    context = max(max_len - 1 - budget, 1)
    widest = [
        # The budget in prompt chunks over every sequence slot.
        (_metas([budget // seqs] * seqs, 0, context=context, pages=pages), True),
        # A chunk filling the budget beside every other sequence decoding.
        (_metas([budget - seqs + 1], seqs - 1, context=context, pages=pages), True),
    ]
    if k:
        # Every sequence drafted K, within the budget; and beside a chunk.
        rows = min(seqs, budget // (1 + k))
        widest.append((_metas((), rows, drafts=[[5] * k] * rows, context=context,
                              pages=pages), False))
        widest.append((_metas([budget - (seqs - 1) * (1 + k)], seqs - 1,
                              drafts=[[5] * k] * (seqs - 1), context=context, pages=pages),
                       False))
    for metas, feed in widest:
        assert _fits(graphs, metas, k, feed, pages) <= graphs.packed_capacity
    # One token more than the budget's bucket, at the most sequences, does
    # not fit: the static inputs are no larger than the scheduler needs.
    over = _metas([token_capacity(budget) + 1 - (seqs - 1)], seqs - 1, context=context,
                  pages=pages)
    with pytest.raises(ValueError, match="does not fit"):
        _fits(graphs, over, k, True, pages)


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_every_step_of_a_busy_scheduler_fits_the_static_inputs(chunked):
    """A scheduler driven with more prompts than its budget and sequence
    slots hold: every step it makes, each row fed, fits."""
    from atoma_infer_tpu_torch.config import CacheConfig
    from atoma_infer_tpu_torch.core.scheduler import Scheduler
    from atoma_infer_tpu_torch.sequence import Sequence, SequenceGroup, SequenceStatus

    budget, seqs, max_len = (128, 16, 512) if chunked else (512, 16, 512)
    sched_cfg = SchedulerConfig(max_num_batched_tokens=budget, max_num_sequences=seqs,
                                max_model_len=max_len, enable_chunked_prefill=chunked,
                                use_native_core=False)
    scheduler = Scheduler(sched_cfg, CacheConfig.new_from_blocks(BS, 600, 0))
    graphs = _graphs(budget, seqs, 0, max_len)
    rng = np.random.default_rng(0)
    groups = {}
    for i in range(40):
        prompt = rng.integers(3, 900, size=int(rng.integers(5, 300))).tolist()
        seq = Sequence(seq_id=i, prompt="", prompt_token_ids=prompt, block_size=BS,
                       eos_token_id=None)
        group = SequenceGroup(
            request_id=f"r{i}", sequences=[seq],
            next_token_chooser_params=NextTokenChooserParameters(),
            stopping_criteria=StoppingCriteriaParameters(max_new_tokens=6))
        groups[group.request_id] = group
        scheduler.add_sequence_group(group)
    widest = 0
    for _ in range(400):
        metadata, _ = scheduler.schedule()
        if not metadata:
            break
        widest = max(widest, _fits(graphs, metadata, 0, True, page_capacity(max_len, BS)))
        for meta in metadata:
            group = groups[meta.request_id]
            group.update_num_computed_tokens(meta.token_chunk_size)
            if not meta.do_sample:
                continue
            seq = group.get_first_seq()
            seq.append_token_id(7, -1.0)
            if seq.get_output_len() >= 6:
                seq.status = SequenceStatus.FINISHED_LENGTH_CAPPED
                scheduler.free_seq(seq)
        scheduler.remove_finished_sequences()
    assert not scheduler.has_unfinished_seqs()
    assert 0 < widest <= graphs.packed_capacity


# ------------------------------------------------------- LRU
def test_mixed_key_captures_replays_and_takes_its_place_in_the_lru(monkeypatch):
    monkeypatch.setattr(cuda_graphs, "MAX_GRAPHS", 2)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (0, 0))
    eager = []

    def make_step(name):
        def step(packed, sampling, gumbel, prev):
            if not _StubGraph.capturing:
                eager.append(name)
                return (packed[:2] * 2,)
            out = (packed[:2] * 2,)
            _StubGraph.capturing[-1].recompute = lambda: out[0].copy_(packed[:2] * 2)
            return out
        return step

    mixed = _step(_metas((12,), 3))[2]
    decode = _step(_metas((), 3))[2]
    penalty = _step(_metas((), 3, repetition_penalty=1.2))[2]
    assert (type(mixed), type(decode), type(penalty)) == (StepKey, DecodeKey, StepKey)
    graphs = _graphs(256, 8, 0, 256)
    sampling = {"temperature": torch.ones(8)}

    def run(key, value):
        packed = torch.full((6,), value, dtype=torch.int32)
        return graphs.run(key, make_step(key), packed, sampling, 1, None, None)[0]

    assert run(mixed, 1).tolist() == [2, 2]        # eager, then captured
    assert run(decode, 2).tolist() == [4, 4]
    out = run(mixed, 3)                             # a replay: most recent now
    assert out.tolist() == [6, 6] and out is graphs.graphs[mixed].outputs[0]
    assert list(graphs.graphs) == [decode, mixed] and graphs.replays == 1
    run(penalty, 4)                                 # drops decode, not mixed
    assert list(graphs.graphs) == [mixed, penalty] and graphs.evictions == 1
    assert run(mixed, 5).tolist() == [10, 10] and graphs.replays == 2
    assert eager == [mixed, decode, penalty]


# ---------------------------------------------------- the reserve
def _configs():
    from atoma_infer_tpu_torch.models.gemma import GemmaConfig
    from atoma_infer_tpu_torch.models.llama import LlamaConfig
    from atoma_infer_tpu_torch.models.mixtral import MixtralConfig

    return {
        "llama-3.2-1b": LlamaConfig(),
        "llama-3.1-8b": LlamaConfig(hidden_size=4096, intermediate_size=14336,
                                    num_hidden_layers=32, head_dim=128),
        "gemma-2-9b": GemmaConfig(vocab_size=256000, hidden_size=3584, intermediate_size=14336,
                                  num_hidden_layers=42, num_attention_heads=16,
                                  num_key_value_heads=8, head_dim=256),
        "mixtral-8x7b": MixtralConfig(vocab_size=32000, hidden_size=4096,
                                      intermediate_size=14336, num_hidden_layers=8,
                                      num_attention_heads=32, num_key_value_heads=8,
                                      head_dim=128),
    }


@pytest.mark.parametrize("model", sorted(_configs()))
@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
def test_reserve_is_at_least_the_pool_at_every_token_bucket(model, sched):
    """The sampler's buffers, a penalty step's, one step's activations and
    quantized temporaries at T, and the ragged split workspace at the
    splits the plan takes at T (they fall as T grows): the reserve's pool
    holds each T bucket's sum, and the reserve holds the pool, the static
    inputs and the instantiated graphs' own memory."""
    from atoma_infer_tpu_torch.engine.llm_service import (
        GRAPH_BYTES_PER_LAYER, GRAPH_POOL_ROWS, PENALTY_POOL_ROWS, activation_bytes,
        graph_pool_bytes, graph_reserve_bytes, quantized_bytes,
    )

    cfg = _configs()[model]
    budget, seqs, k, max_len = SCHEDULERS[sched]
    sched_cfg = SchedulerConfig(max_num_batched_tokens=budget, max_num_sequences=seqs,
                                max_model_len=max_len, enable_chunked_prefill=True,
                                num_speculative_tokens=k)
    hq, hk, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    P = page_capacity(max_len, BS)
    R = bucket(seqs) * (1 + k)
    sampler = 4 * (GRAPH_POOL_ROWS + PENALTY_POOL_ROWS) * R * cfg.vocab_size
    pool = graph_pool_bytes(cfg, sched_cfg, BS, quantized=True)
    T = 8
    while True:
        splits = max(
            pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=q, max_keys=P * BS,
                            group=hq // hk, num_kv_heads=hk, slots=slots).splits
            for S in {bucket(n) for n in range(1, bucket(seqs) + 1)}
            for q in {bucket(n, maximum=T) for n in range(1, T + 1)}
            for slots in (H100_SLOTS, 132, 132 * 4))
        at_t = (sampler + activation_bytes(T, cfg) + quantized_bytes(T, cfg)
                + 4 * splits * T * hq * (d + 2))
        assert at_t <= pool, (T, splits)
        if T >= token_capacity(budget):
            break
        T *= 2
    reserve = graph_reserve_bytes(cfg, sched_cfg, BS, quantized=True)
    assert reserve >= pool + (cuda_graphs.MAX_GRAPHS + 1) * GRAPH_BYTES_PER_LAYER * \
        cfg.num_layers + 4 * packed_capacity(bucket(seqs), P, token_capacity(budget), k)


# ---------------------------------------- services against JAX
REQUESTS = [
    ("the cat sat on the mat " * 8, dict(max_new_tokens=20)),
    ("abc abc abc abc abc", dict(max_new_tokens=24, repetition_penalty=1.3,
                                 frequency_penalty=0.4)),
    ("one two three one two three one " * 4, dict(max_new_tokens=16)),
    ("hello world. hello world. hello", dict(max_new_tokens=20)),
]


def _stub_graphs(monkeypatch, seen):
    """Every step of the service through ``StepGraphs``, whose capture is a
    stub replaying by recomputing the captured step into its outputs; the
    kind of each graph run is recorded in ``seen``."""
    from atoma_infer_tpu_torch.engine import worker as worker_mod

    class Replay:
        def __init__(self, step, views, outputs):
            self.step, self.views, self.outputs = step, views, outputs

        @torch.inference_mode()
        def replay(self):
            new = self.step(*self.views)
            for old, fresh in zip(self.outputs[:3], new[:3]):
                old.copy_(fresh)
            if self.outputs[3] is not None:
                for old, fresh in zip(self.outputs[3], new[3]):
                    old.copy_(fresh)

    def capture(self, step, views):
        outputs = step(*views)
        return cuda_graphs._Graph(Replay(step, views, outputs), views, outputs, {})

    monkeypatch.setattr(cuda_graphs.StepGraphs, "_capture", capture)
    # On the CPU the host copy is the tensor itself, which a later replay of
    # the same graph overwrites; the card copies to pinned memory.
    monkeypatch.setattr(worker_mod, "_to_host", lambda t: (t.clone(), None))

    def watch(service):
        worker, cfg = service.engine.worker, service.config.scheduler
        worker.graphs = StepGraphs(bucket(cfg.max_num_sequences),
                                   page_capacity(cfg.max_model_len, BS),
                                   token_capacity(cfg.max_num_batched_tokens),
                                   cfg.num_speculative_tokens)
        run = worker.graphs.run

        def spy(key, *args):
            seen.append((key, key in worker.graphs.graphs))
            return run(key, *args)

        worker.graphs.run = spy

    return watch


@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_chunked_prefill_and_penalty_service_matches_jax(async_scheduling, monkeypatch):
    """Prompts longer than the 32-token budget (chunked, beside decode
    rows) and a request with repetition and frequency penalties: the port's
    tokens, eager and with every step through stub graphs, are the JAX
    service's exactly (greedy f32)."""
    kw = dict(k=0, chunked=True, budget=32, async_scheduling=async_scheduling, late=(2, 3))
    want, _, _ = _serve(JAX, "tiny_trained", REQUESTS, **kw)
    eager, _, _ = _serve(PORT, "tiny_trained", REQUESTS, **kw)
    seen = []
    graphed, _, _ = _serve(PORT, "tiny_trained", REQUESTS, watch=_stub_graphs(monkeypatch, seen),
                           **kw)
    assert eager == want and graphed == want
    # Mixed and penalty steps ran through graphs, and their keys replayed.
    replayed = [key for key, before in seen if before]
    assert any(type(k) is StepKey and not k.decode_only for k, _ in seen)
    assert any(type(k) is StepKey and k.needs_penalties for k in replayed)
    assert any(type(k) is StepKey and k.max_q_len > 1 for k in replayed)


def test_verify_with_a_prefill_chunk_matches_jax(monkeypatch):
    """Drafts beside chunked prompts: verify steps that carry a prefill
    chunk replay their general keys; the tokens are JAX's."""
    requests = [(PROMPT, dict(max_new_tokens=20)), ("z" * 200, dict(max_new_tokens=6))]
    kw = dict(k=4, chunked=True, budget=64, late=(1,))
    want, _, _ = _serve(JAX, "tiny_random", requests, **kw)
    seen = []
    got, _, _ = _serve(PORT, "tiny_random", requests, watch=_stub_graphs(monkeypatch, seen),
                       **kw)
    assert got == want
    assert any(type(k) is StepKey and k.spec == 5 and k.max_q_len > 5 for k, _ in seen)
