"""The host side of the port's step CUDA graphs
(``atoma_infer_tpu_torch/engine/cuda_graphs.py``), on the CPU.

A CPU worker never captures: the CUDA graph API needs a CUDA device, so
every CPU step runs eagerly. What is pure host code is tested here: the
graph key and which steps get one, the static-buffer fill, and the launch
counts a replay adds (against a stub kernel and a stub graph that replays by
recomputing into the captured outputs). Capture and replay themselves run
only on the card (``chip_smoke.py``).
"""

import contextlib

import numpy as np
import pytest
import torch

from atoma_infer_tpu_torch.engine.cuda_graphs import (
    StepGraphs, StepKey, packed_capacity, page_capacity, step_graph_key, token_capacity,
)
from atoma_infer_tpu_torch.engine.input_prep import prepare_model_input
from atoma_infer_tpu_torch.engine.sampler import SamplingTensors
from atoma_infer_tpu_torch.ops import cuda_lib
from atoma_infer_tpu_torch.sampling_params import (
    NextTokenChooserParameters,
    StoppingCriteriaParameters,
)
from atoma_infer_tpu_torch.sequence import SequenceData, SequenceGroupMetadata


def _metadata(prompt_chunks=(), decodes=3, **params):
    """Groups of one sequence each: prefill chunks first, then decode rows
    (each sequence has 20 prompt tokens, 19 computed)."""
    metas = []
    for i, chunk in enumerate(prompt_chunks):
        data = SequenceData(list(range(3, 3 + chunk)))
        metas.append(SequenceGroupMetadata(
            request_id=f"p{i}", is_prompt=True, seq_data={i: data},
            next_token_chooser_params=NextTokenChooserParameters(**params),
            block_tables={i: [i]}, stopping_criteria=StoppingCriteriaParameters(),
            do_sample=True, token_chunk_size=chunk,
        ))
    for j in range(decodes):
        sid = 100 + j
        data = SequenceData(list(range(3, 23)))
        data.update_num_computed_tokens(19)
        metas.append(SequenceGroupMetadata(
            request_id=f"d{j}", is_prompt=False, seq_data={sid: data},
            next_token_chooser_params=NextTokenChooserParameters(**params),
            block_tables={sid: [10 + 2 * j, 11 + 2 * j]},
            stopping_criteria=StoppingCriteriaParameters(), do_sample=True,
            token_chunk_size=1,
        ))
    return metas


def _key(metas, feed=False, top_n=0):
    model_input = prepare_model_input(metas, block_size=16, max_pages_per_seq=16)
    params = [m.next_token_chooser_params for m in metas]
    sampling = SamplingTensors.build(
        params, [[] for _ in params], model_input.seq_lens.shape[0], [top_n] * len(params)
    )
    return step_graph_key(model_input, sampling, feed)


def test_graph_key_is_the_jax_steps_static_arguments():
    # Pure greedy decode of 3 sequences: T = S = 8 (the smallest bucket),
    # P = 8 (the table's smallest width bucket).
    assert _key(_metadata()) == (8, 8, 8, False, False, 0, False)
    assert _key(_metadata(), feed=True) == (8, 8, 8, False, False, 0, True)
    assert _key(_metadata(decodes=20)) == (24, 24, 8, False, False, 0, False)  # dense rung
    sampled = _metadata(do_sample=True, temperature=0.7, seed=3)
    assert _key(sampled, top_n=2) == (8, 8, 8, True, False, 2, False)
    typical = _metadata(do_sample=True, temperature=0.7, typical_p=0.5)
    assert _key(typical) == (8, 8, 8, True, True, 0, False)


@pytest.mark.parametrize("metas, key", [
    # Mixed prefill + decode: 15 tokens (T 16), the 12-token chunk's
    # max_q_len bucket 16, capped at T.
    (_metadata(prompt_chunks=(12,)),
     StepKey(16, 8, 8, False, False, False, False, 0, 0, False, 16)),
    # Prefill only: 17 tokens (T 32), the longest chunk 12 → 16.
    (_metadata(prompt_chunks=(12, 5), decodes=0),
     StepKey(32, 8, 8, False, False, False, False, 0, 0, False, 16)),
    # Penalties (the window moves): a decode step, max_q_len 1.
    (_metadata(repetition_penalty=1.2),
     StepKey(8, 8, 8, True, False, True, False, 0, 0, False, 1)),
    (_metadata(frequency_penalty=0.5),
     StepKey(8, 8, 8, True, False, True, False, 0, 0, False, 1)),
], ids=["mixed", "prefill", "repetition_penalty", "frequency_penalty"])
def test_steps_without_a_graph(metas, key):
    """The steps that ran eagerly before every step had a graph: each now
    has a key of the JAX step's static arguments and its max_q_len."""
    assert _key(metas) == key and type(_key(metas)) is StepKey


def test_cpu_worker_steps_eagerly():
    """A CPU worker has no graphs: every CPU step runs eagerly, because the
    CUDA graph API has no CPU counterpart."""
    from atoma_infer_tpu_torch.config import CacheConfig, SchedulerConfig
    from atoma_infer_tpu_torch.engine.cache_engine import CacheEngine
    from atoma_infer_tpu_torch.engine.worker import ModelWorker
    from atoma_infer_tpu_torch.entrypoints.offline import build_tiny_random
    from atoma_infer_tpu_torch.sequence import ExecuteModelRequest

    model, params, _ = build_tiny_random("cpu")
    cfg = model.config
    ce = CacheEngine(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        block_size=16, num_device_blocks=32, num_host_blocks=0, dtype=torch.float32,
        device="cpu",
    )
    worker = ModelWorker(model, params, ce, SchedulerConfig(max_model_len=256),
                         CacheConfig(block_size=16))
    assert worker.graphs is None
    out = worker.execute_model(ExecuteModelRequest(
        sequence_groups_metadata=_metadata(), blocks_to_swap_in=[],
        blocks_to_swap_out=[], blocks_to_copy=[],
    ))
    assert sorted(out) == ["d0", "d1", "d2"]


def _step_inputs(S=4, n_packed=6, n_prev=3, V=5, seed=0):
    rng = np.random.default_rng(seed)
    return (
        torch.from_numpy(rng.integers(0, 50, n_packed).astype(np.int32)),
        {"temperature": torch.from_numpy(rng.random(S).astype(np.float32)),
         "top_k": torch.from_numpy(rng.integers(0, 9, S).astype(np.int32)),
         "recent_tokens": torch.from_numpy(rng.integers(-1, 50, (S, 3)).astype(np.int32))},
        torch.from_numpy(rng.standard_normal((S, V)).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 50, n_prev).astype(np.int32)),
    )


def test_static_fill_copies_each_input_in_place():
    graphs = StepGraphs(max_rows=8, max_pages=8, max_tokens=8)
    packed, sampling, gumbel, prev = _step_inputs()
    views = graphs._views(packed, sampling, gumbel, prev)
    ptrs = [v.data_ptr() for v in (views[0], views[2], views[3])]
    graphs._fill(views, packed, sampling, 1, gumbel, prev)
    static_packed, static_sampling, noise, feed = views
    assert torch.equal(static_packed, packed)
    for name, t in sampling.items():
        assert torch.equal(static_sampling[name], t)
    assert torch.equal(noise, gumbel)
    # The previous step's tokens land in the first rows of the feed, which
    # is the whole buffer (prev_map indexes the previous step's rows).
    assert feed.shape == (8,) and torch.equal(feed[:3], prev)
    assert ptrs == [v.data_ptr() for v in (views[0], views[2], views[3])]


def test_static_fill_copies_sampling_only_when_it_changed():
    graphs = StepGraphs(max_rows=8, max_pages=8, max_tokens=8)
    packed, sampling, gumbel, prev = _step_inputs()
    views = graphs._views(packed, sampling, gumbel, prev)
    graphs._fill(views, packed, sampling, 1, gumbel, prev)
    # While the worker's sampling version holds, its tensors are unchanged
    # and a copy would be wasted, so the static ones are left alone.
    views[1]["temperature"].fill_(9.0)
    graphs._fill(views, packed, sampling, 1, gumbel, prev)
    assert views[1]["temperature"].tolist() == [9.0] * 4
    graphs._fill(views, packed, sampling, 2, gumbel, prev)
    assert torch.equal(views[1]["temperature"], sampling["temperature"])


def test_static_inputs_are_shared_by_every_key():
    """One set of static inputs at the largest bucket: a key reads its
    leading rows, so their memory does not grow with the number of keys."""
    graphs = StepGraphs(max_rows=16, max_pages=8, max_tokens=16)
    small = graphs._views(*_step_inputs(S=8, n_packed=20, n_prev=8))
    nbytes = graphs.static_bytes
    # packed [8·16 + 16·8 + 2] i32, sampling [16] f32 + [16] i32 + [16, 3]
    # i32, noise [16, 5] f32, feed [16] i32.
    assert nbytes == 4 * (258 + 16 + 16 + 48 + 80 + 16)
    wide = graphs._views(*_step_inputs(S=16, n_packed=40, n_prev=16, seed=1))
    assert graphs.static_bytes == nbytes
    for a, b in [(small[0], wide[0]), (small[2], wide[2]), (small[3], wide[3]),
                 *((small[1][n], wide[1][n]) for n in small[1])]:
        assert a.data_ptr() == b.data_ptr()
    assert small[2].shape == (8, 5) and wide[2].shape == (16, 5)


@pytest.mark.parametrize("S, n_packed, n_prev", [(16, 6, 3), (4, 300, 3), (4, 6, 17)],
                         ids=["rows", "packed", "feed"])
def test_static_fill_refuses_a_feed_wider_than_its_buffer(S, n_packed, n_prev):
    graphs = StepGraphs(max_rows=8, max_pages=8, max_tokens=8)
    with pytest.raises(ValueError, match="does not fit"):
        graphs._views(*_step_inputs(S=S, n_packed=n_packed, n_prev=n_prev))


# ----------------------------------------------------- launches per replay
# The device a stub launch names: a launch makes its device current, which
# the stub fixture turns into a no-op on this CUDA-less torch.
STUB_DEVICE = torch.device("cuda", 0)


@pytest.fixture()
def stub_kernels(monkeypatch):
    """Two registered kernels whose C entry point is a Python stub."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: STUB_DEVICE.index)
    names = ("stub_attention", "stub_matmul")
    saved = {n: cuda_lib.KERNELS.get(n) for n in names}
    kernels = []
    for n in names:
        k = cuda_lib.register(cuda_lib.CudaKernel(n, "none.cu", "none", [], replaces="test"))
        k._fn = lambda *args: 0
        kernels.append(k)
    yield kernels
    for n, k in saved.items():
        if k is None:
            cuda_lib.KERNELS.pop(n, None)
        else:
            cuda_lib.KERNELS[n] = k


def test_capture_records_launches_instead_of_counting(stub_kernels):
    attn, mm = stub_kernels
    attn(device=STUB_DEVICE)
    with cuda_lib.recording_launches() as tally:
        attn(device=STUB_DEVICE)
        mm(device=STUB_DEVICE)
        mm(device=STUB_DEVICE)
        with pytest.raises(RuntimeError, match="already recording"):
            with cuda_lib.recording_launches():
                pass
    assert (attn.launches, mm.launches) == (1, 0)
    assert tally == {"stub_attention": 1, "stub_matmul": 2}
    cuda_lib.count_replay(tally)
    cuda_lib.count_replay(tally)
    assert (attn.launches, mm.launches) == (3, 4)


class _StubGraph:
    """Replays by recomputing the captured step into its outputs (what a
    CUDA graph's replay amounts to), launching nothing through the
    wrappers."""

    capturing = []

    def __init__(self):
        self.recompute = None

    def replay(self):
        with cuda_lib.recording_launches():
            self.recompute()


@contextlib.contextmanager
def _stub_capture(graph, pool=None, capture_error_mode=None):
    assert capture_error_mode == "thread_local"
    _StubGraph.capturing.append(graph)
    try:
        yield
    finally:
        _StubGraph.capturing.pop()


def test_replays_count_the_captured_launches(stub_kernels, monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    # The capture's memory accounting reads the allocator and the driver.
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (0, 0))
    attn, mm = stub_kernels

    def compute(packed, sampling, gumbel, prev):
        attn(device=STUB_DEVICE)
        mm(device=STUB_DEVICE)
        mm(device=STUB_DEVICE)
        tokens = packed[:4] * sampling["scale"].to(torch.int32) + prev[:4]
        return tokens, (gumbel.argmax(dim=1).to(torch.int32),)

    def step(packed, sampling, gumbel, prev):
        out = compute(packed, sampling, gumbel, prev)
        if _StubGraph.capturing:
            graph = _StubGraph.capturing[-1]

            def recompute():
                new = compute(packed, sampling, gumbel, prev)
                out[0].copy_(new[0])
                out[1][0].copy_(new[1][0])

            graph.recompute = recompute
        return out

    rng = np.random.default_rng(0)

    def inputs(n_prev):
        return (
            torch.from_numpy(rng.integers(0, 50, 6).astype(np.int32)),
            {"scale": torch.from_numpy(rng.integers(1, 4, 4).astype(np.float32))},
            torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 50, n_prev).astype(np.int32)),
        )

    graphs = StepGraphs(max_rows=8, max_pages=8, max_tokens=8)
    key = (8, 8, 8, True, False, 0, True)
    first = inputs(4)
    out = graphs.run(key, step, first[0], first[1], 1, first[2], first[3])  # eager, captured
    want = compute(*first)
    assert torch.equal(out[0], want[0])
    assert (attn.launches, mm.launches) == (2, 4)  # the eager step and `want`
    assert graphs.graphs[key].launches == {"stub_attention": 1, "stub_matmul": 2}
    # The static inputs hold the captured step's inputs: the newest graph
    # replays right before its next fill.
    assert torch.equal(graphs.graphs[key].inputs[0], first[0])
    assert torch.equal(graphs.graphs[key].inputs[3][:4], first[3])
    for version, n_prev in ((2, 6), (3, 4)):
        step_inputs = inputs(n_prev)
        p, smp, g, prev = step_inputs
        out = graphs.run(key, step, p, smp, version, g, prev)   # a replay
        want = compute(*step_inputs)
        assert out[0] is graphs.graphs[key].outputs[0]
        assert torch.equal(out[0], want[0]) and torch.equal(out[1][0], want[1][0])
    # Two replays (2 + 4 launches) and two reference computes.
    assert (attn.launches, mm.launches) == (2 + 2 + 2, 4 + 4 + 4)
    assert len(graphs.graphs) == 1 and graphs.replays == 2 and graphs.capture_seconds > 0


def test_the_least_recently_used_graph_makes_room(monkeypatch):
    """At most MAX_GRAPHS graphs live: capturing one more drops the least
    recently used, whose key is captured again at its next step."""
    from atoma_infer_tpu_torch.engine import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "MAX_GRAPHS", 2)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", _stub_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device: (0, 0))
    eager = []

    def step(packed, sampling, gumbel, prev):
        if not _StubGraph.capturing:
            eager.append(int(packed[0]))
        else:
            _StubGraph.capturing[-1].recompute = lambda: None
        return (packed[:1].clone(),)

    graphs = StepGraphs(max_rows=8, max_pages=8, max_tokens=8)
    packed, sampling, gumbel, _ = _step_inputs()

    def run(k):
        p = packed.clone()
        p[0] = k
        graphs.run(("key", k), step, p, sampling, 1, gumbel, None)

    for k in (1, 2, 1, 3):   # 3 drops 2, the least recently used
        run(k)
    assert list(graphs.graphs) == [("key", 1), ("key", 3)] and graphs.evictions == 1
    run(2)                    # captured again (eagerly first); 1 goes
    assert eager == [1, 2, 3, 2] and graphs.replays == 1
    assert list(graphs.graphs) == [("key", 3), ("key", 2)] and graphs.evictions == 2


def test_decode_graph_bytes_are_left_out_of_the_kv_pool(monkeypatch):
    from atoma_infer_tpu_torch import config as config_mod
    from atoma_infer_tpu_torch.engine.cuda_graphs import MAX_GRAPHS
    from atoma_infer_tpu_torch.engine.llm_service import (
        GRAPH_BYTES_PER_LAYER, GRAPH_POOL_ROWS, PENALTY_POOL_ROWS, activation_bytes,
        graph_reserve_bytes, split_workspace_bytes,
    )
    from atoma_infer_tpu_torch.engine.sampler import PENALTY_WINDOW
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    # The static inputs at the largest sequence bucket (48 → 64) and token
    # bucket (the budget 200 → 256), the pool's GRAPH_POOL_ROWS and
    # PENALTY_POOL_ROWS [S, V] f32 buffers and one step's forward at the
    # widest T, and the instantiated graphs' own memory, MAX_GRAPHS and the one
    # being captured.
    cfg = LlamaConfig(vocab_size=1000, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      head_dim=16)
    for seqs, S in ((64, 64), (48, 64)):
        sched = config_mod.SchedulerConfig(max_num_batched_tokens=200, max_num_sequences=seqs,
                                           max_model_len=2048, enable_chunked_prefill=True)
        static = S * 1000 + packed_capacity(S, 128, 256) + S * (8 + PENALTY_WINDOW)
        forward = activation_bytes(256, cfg) + split_workspace_bytes(256, cfg, 128, 16)
        assert graph_reserve_bytes(cfg, sched, 16) == (
            4 * (static + (GRAPH_POOL_ROWS + PENALTY_POOL_ROWS) * S * 1000) + forward
            + (MAX_GRAPHS + 1) * 2 * GRAPH_BYTES_PER_LAYER)
    # The widest page bucket: max_model_len's pages, at least the smallest;
    # the widest token bucket: the budget's.
    assert (page_capacity(2048, 16), page_capacity(2048, 64), page_capacity(40, 16)) == (
        128, 32, 8)
    assert (token_capacity(256), token_capacity(200), token_capacity(2)) == (256, 256, 8)
    # A StepGraphs of the same buckets holds no more static bytes.
    graphs = StepGraphs(max_rows=64, max_pages=128, max_tokens=256)
    packed = torch.zeros(packed_capacity(64, 128, 256), dtype=torch.int32)
    sampling = {name: torch.zeros(64, dtype=dt) for name, dt in (
        ("temperature", torch.float32), ("top_k", torch.int32), ("top_p", torch.float32),
        ("typical_p", torch.float32), ("do_sample", torch.bool),
        ("repetition_penalty", torch.float32), ("frequency_penalty", torch.float32))}
    sampling["recent_tokens"] = torch.zeros(64, PENALTY_WINDOW, dtype=torch.int32)
    graphs._views(packed, sampling, torch.zeros(64, 1000), torch.zeros(64, dtype=torch.int32))
    assert graphs.static_bytes <= 4 * (
        64 * 1000 + packed_capacity(64, 128, 256) + 64 * (8 + PENALTY_WINDOW))
    monkeypatch.setattr(config_mod, "_min_free_device_memory", lambda devices: 10_000_000)
    cache = config_mod.CacheConfig(block_size=16, hbm_memory_utilization=0.5,
                                   num_host_blocks_override=0)
    per_block = cache.block_bytes(2, 2, 32, 4)
    cache.profile(2, 2, 32, 4, reserve_bytes=2_000_000)
    assert cache.num_device_blocks == int(8_000_000 * 0.5 // per_block)
