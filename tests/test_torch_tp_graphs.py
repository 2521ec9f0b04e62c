"""Tensor-parallel steps replayed as CUDA graphs captured in segments
between the collectives (``engine/cuda_graphs.py``, ``parallel/group.py``
``TpGroup.segmented``), the host side on the CPU.

Spawned gloo ranks (``tests/torch_parity.py``) run the port's own segmenter
(``StepGraphs._record``) with graphs that record nothing, and replay through
the port's own ``StepGraphs._replay`` with ``torch_parity.StubStepGraphs``,
whose segments recompute the captured step on a thread that stops at each
collective, writes its operand into the tensor the capture recorded and
reads on from it (the gather's from its static output) once the replay has
run the real collective there. The stubs reach every rank through the
service's ``ModelFactory`` (``step_graphs``).

- One tp 2 step's recorded boundaries equal the eager step's collectives,
  in order and shape (bf16, an INT8 cache's scales' max, Mixtral's expert
  mix); a capture issues no collective; a replay issues the eager step's;
  the next segment reads the gather's static output, and the replay's
  outputs are the eager step's.
- A tp 2 service (sync and async) and a pp 2 × tp 2 service through stub
  graphs give JAX's greedy tokens at the same tp and the eager port's.
- Every rank captures and evicts the same keys at the same runs, and a
  replay issues its key's eager collectives.
- ``warmup()`` under TP captures, and the traffic replays.
- The reserve at a rank's widths and segments.
- A segment's view of a capture's workspace does not own it.

Capture and replay on the card run in ``chip_smoke.py`` (``run_tp_services``,
``run_pp_services``).
"""

import numpy as np
import pytest
import torch

import torch_parity as tpar
from atoma_infer_tpu_torch.engine.cuda_graphs import StepGraphs, _alias, _view_of
from test_torch_tp import (
    MIXTRAL, PROMPTS, WIDTHS, jax_generate, jax_params, jax_service, port_factory,
    warm_then_generate,
)

torch.set_num_threads(2)

TP = 2


# ------------------------------------------------- segments of one step
# A prefill step (two prompts) and a decode step over them.
STEPS = [([5, 9], [5, 9]), ([6, 10], [1, 1])]
TABLES = [[0], [1]]

# An untied LM head: its vocab-sharded logits are gathered (a tied head's
# logits are whole on every rank: no gather).
UNTIED = dict(WIDTHS, tie_word_embeddings=False)
SEGMENT_CASES = {
    # name: (family, widths, dtype, kv cache dtype, collectives a layer)
    "bf16": ("llama", UNTIED, "bfloat16", None, ["sum", "sum"]),
    "int8-kv": ("llama", UNTIED, "float32", "int8", ["max", "sum", "sum"]),
    "mixtral": ("mixtral", MIXTRAL, "float32", None, ["sum", "sum"]),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segments_are_the_eager_steps_collectives(case, tmp_path):
    """Each rank's segments of a prefill and a decode step: one before each
    collective the eager step makes — the same operation on the same shape,
    in order — and one after the last (an untied head's logits' gather,
    whose static output [rows, V] the last segment reads). The capture
    issues no collective, the replay exactly the eager step's, and the
    replay's outputs (the logits and their argmax, taken in the last
    segment) and the gather's output are the eager step's."""
    family, widths, dtype, kv, per_layer = SEGMENT_CASES[case]
    _, params = jax_params(widths, family)
    path = tpar.save_params(tmp_path / f"{family}.npz", params)
    rng = np.random.default_rng(0)
    stream = [rng.integers(2, widths["vocab_size"], 16).tolist() for _ in TABLES]
    ranks = tpar.spawn_ranks(tpar.segments_rank, TP, tmp_path, path, family, widths, dtype,
                             kv, STEPS, stream, TABLES)
    layers = widths["num_hidden_layers"]
    gathers = 0 if widths["tie_word_embeddings"] else 1
    want_ops = per_layer * layers + ["gather"] * gathers
    for rank, steps in enumerate(ranks):
        for (seq_lens, q_lens), got in zip(STEPS, steps):
            assert [op for op, _ in got["eager_ops"]] == want_ops, (rank, q_lens)
            assert got["captured"][:-1] == got["eager_ops"], (rank, q_lens)
            assert got["captured"][-1] == (None, None)
            assert len(got["captured"]) == len(per_layer) * layers + 1 + gathers
            rows = -(-sum(q_lens) // 8) * 8   # the step's T: the head takes every row
            assert got["gather_out"] == [(rows, widths["vocab_size"])] * gathers
            if gathers:
                assert got["eager_ops"][-1][1] == (rows, widths["vocab_size"] // TP)
                np.testing.assert_array_equal(got["gathered"][0], got["eager"][0])
            assert got["capture_collectives"] == 0
            assert got["replay_collectives"] == got["eager_collectives"] == len(want_ops)
            for eager, replayed in zip(got["eager"], got["replayed"]):
                np.testing.assert_array_equal(replayed, eager)
    # Every rank samples from the same gathered logits.
    for a, b in zip(ranks[0], ranks[1]):
        np.testing.assert_array_equal(a["eager"][0], b["eager"][0])


# ---------------------------------------------------------- the services
def _service(tp, tmp_path, factory, name, **kw):
    """A port service at ``tp`` on the CPU, meeting at a rendezvous file of
    its own (two services at tp > 1 in one test)."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    config = tpar.tp_engine_config(tp, coordinator_address=tpar.rendezvous_file(tmp_path, name),
                                   **kw)
    return LlmService.start(config, model_factory=factory, device="cpu")


def _stub_factory(tmp_path, cls=tpar.StubStepGraphs):
    factory = port_factory(tmp_path, WIDTHS)
    return tpar.npz_factory(factory.args[0], "llama", WIDTHS, step_graphs=cls)


def _replays_match_captures(events):
    """Every replay issues the collectives of its key's eager first step."""
    eager = {}
    replays = 0
    for _, key, captured, _, collectives in events:
        if captured:
            eager[key] = collectives
        else:
            assert collectives == eager[key], key
            replays += 1
    return replays


@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_tp2_stub_graphs_serve_like_jax_and_eager(async_scheduling, tmp_path):
    sched = dict(async_scheduling=async_scheduling)
    want = jax_generate(jax_service(TP, WIDTHS, **sched), PROMPTS)
    eager = tpar.generate(_service(TP, tmp_path, port_factory(tmp_path, WIDTHS), "eager",
                                   **sched), PROMPTS)
    service = _service(TP, tmp_path, _stub_factory(tmp_path), "graphs", **sched)
    graphs = service.engine.worker.graphs
    assert isinstance(graphs, tpar.StubStepGraphs) and graphs.group is service.group
    followers = list(service.followers)
    got = tpar.generate(service, PROMPTS)
    assert got == want == eager
    assert graphs.replays and set(graphs.capture_collectives) == {0}
    assert _replays_match_captures(graphs.events) == graphs.replays
    assert [p.exitcode for p in followers] == [0]


def test_pp2_tp2_stub_stage_graphs_serve_like_jax_and_eager(tmp_path):
    from test_torch_pipeline import _jax_pp_service

    want = jax_generate(_jax_pp_service(TP, 2, WIDTHS), PROMPTS[:2])
    eager = tpar.generate(_service(TP, tmp_path, port_factory(tmp_path, WIDTHS), "eager",
                                   pipeline_parallel_size=2), PROMPTS[:2])
    service = _service(TP, tmp_path, _stub_factory(tmp_path), "graphs", pipeline_parallel_size=2)
    worker = service.engine.worker
    assert worker.graphs is None
    stages = [st.graphs for st in worker.stages]
    assert all(isinstance(g, tpar.StubStepGraphs) for g in stages)
    assert [g.group is st.model.group for g, st in zip(stages, worker.stages)] == [True, True]
    got = tpar.generate(service, PROMPTS[:2])
    assert got == want == eager
    for g in stages:
        assert g.replays and set(g.capture_collectives) == {0}
        assert _replays_match_captures(g.events) == g.replays


@pytest.mark.parametrize("pp", [1, 2], ids=["tp2", "pp2-tp2"])
def test_every_rank_captures_and_evicts_the_same_keys(pp, tmp_path):
    """Two ranks started by hand, each building its service with the stub
    graphs from the factory, keeping one graph: rank for rank the same key
    captured, replayed or evicted at every run, in every stage; every key
    after the first evicts; tokens as the eager port's at tp 1."""
    sched = dict(enable_chunked_prefill=True, max_num_batched_tokens=32)
    prompts = PROMPTS + ["a fourth prompt of middling length", "x" * 70]
    factory = port_factory(tmp_path, WIDTHS)
    one = tpar.generate(_service(1, tmp_path, factory, "one", **sched), prompts)
    ranks = tpar.spawn_ranks(tpar.graphs_lockstep_rank, TP, tmp_path, factory.args[0], WIDTHS,
                             prompts, sched, None, pp)
    assert ranks[0]["outputs"] == one
    assert ranks[1]["events"] == ranks[0]["events"]
    for stage in ranks[0]["events"]:
        keys = [key for _, key, captured, _, _ in stage if captured]
        assert sum(len(evicted) for *_, evicted, _ in stage) == len(keys) - 1 >= 3
        assert _replays_match_captures(stage)
    for rank in ranks:
        assert all(set(c) == {0} for c in rank["capture_collectives"])


def test_warmup_under_tp_captures_and_traffic_replays(tmp_path):
    """``warmup()`` at tp 2 with the stub graphs: rank 0 captures as the
    waves step, the traffic after it replays those keys, and its tokens are
    the port's tp 1."""
    factory = port_factory(tmp_path, WIDTHS)
    want = tpar.generate(_service(1, tmp_path, factory, "one"), PROMPTS)
    service = _service(TP, tmp_path, _stub_factory(tmp_path), "warm")
    graphs = service.engine.worker.graphs
    warm_at = []
    warmup = service.warmup

    async def counted(**kw):
        dt = await warmup(**kw)
        warm_at.append(len(graphs.events))
        return dt

    service.warmup = counted
    dt, left, free, got = warm_then_generate(service, PROMPTS, num_seqs=4, prompt_len=16)
    assert dt > 0 and not left and free == 128
    assert got == want
    (n,) = warm_at
    warm, traffic = graphs.events[:n], graphs.events[n:]
    assert sum(captured for _, _, captured, _, _ in warm) >= 4
    warmed = {key for _, key, *_ in warm}
    assert any(not captured and key in warmed for _, key, captured, _, _ in traffic)
    assert set(graphs.capture_collectives) == {0}


# ------------------------------------------------------------ the reserve
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_reserve_at_a_ranks_widths_and_segments(tp, quantized):
    """A rank's reserve: the pool at its shard's widths (its q and kv heads,
    its slice of the intermediate size, kv heads copied past Hk) with the
    gather's [R, V] output beside the sampler's rows, and each of
    MAX_GRAPHS + 1 keys' 3·L + 1 segments after the first."""
    from atoma_infer_tpu_torch.config import SchedulerConfig
    from atoma_infer_tpu_torch.engine.cuda_graphs import MAX_GRAPHS, packed_capacity
    from atoma_infer_tpu_torch.engine.llm_service import (
        GRAPH_BYTES_PER_LAYER, GRAPH_BYTES_PER_SEGMENT, GRAPH_POOL_ROWS, PENALTY_POOL_ROWS,
        QMM_SPLIT_ELEMENTS, graph_reserve_bytes, graph_segments, split_workspace_bytes,
    )
    from atoma_infer_tpu_torch.engine.sampler import PENALTY_WINDOW
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(vocab_size=1000, hidden_size=64, intermediate_size=256,
                      num_hidden_layers=5, num_attention_heads=8, num_key_value_heads=2,
                      head_dim=16)
    sched = SchedulerConfig(max_num_batched_tokens=200, max_num_sequences=48,
                            max_model_len=2048, enable_chunked_prefill=True)
    S, T, P, V, L = 64, 256, 128, 1000, 5
    hq, hk, inter = 8 // tp, max(2, tp) // tp, 256 // tp
    forward = 4 * T * (4 * 64 + 2 * (hq + 2 * hk) * 16 + hq * 16 + 3 * inter)
    forward += split_workspace_bytes(T, cfg, P, 16) // tp
    if quantized:
        wide = max(64, inter)
        forward += 4 * (3 * T * wide + QMM_SPLIT_ELEMENTS + T * wide)
    pool = 4 * (GRAPH_POOL_ROWS + PENALTY_POOL_ROWS + 1) * S * V + forward
    static = 4 * packed_capacity(S, P, T) + 4 * (S * V + S * (8 + PENALTY_WINDOW))
    instantiated = (MAX_GRAPHS + 1) * (GRAPH_BYTES_PER_LAYER * L
                                       + GRAPH_BYTES_PER_SEGMENT * (3 * L + 1))
    assert graph_segments(L, tp) == 3 * L + 2 and graph_segments(L, 1) == 1
    assert graph_reserve_bytes(cfg, sched, 16, quantized=quantized, tp=tp) == \
        static + instantiated + pool
    # The rank's forward is narrower than tp 1's; the segments cost more.
    one = graph_reserve_bytes(cfg, sched, 16, quantized=quantized)
    assert one - (MAX_GRAPHS + 1) * GRAPH_BYTES_PER_LAYER * L - static > forward


# ----------------------------------------------------------- which workers
class _Group:
    def __init__(self, tp):
        self.tp = tp


class _Model:
    def __init__(self, tp):
        self.group = _Group(tp) if tp > 1 else None
        self.tp = tp


class _Cache:
    def __init__(self, device):
        self.device = torch.device(device)


@pytest.mark.parametrize("device, tp, flag, cls, want", [
    ("cuda:0", 1, True, None, "one graph"),
    ("cuda:0", 2, True, None, "segments"),
    ("cuda:0", 8, True, None, "segments"),
    ("cuda:0", 2, False, None, None),          # the caller asked for none
    ("cpu", 1, True, None, None),               # no CUDA graph on the CPU
    ("cpu", 2, True, None, None),
    ("cpu", 2, True, tpar.StubStepGraphs, "segments"),   # a factory's own graphs
], ids=["cuda-tp1", "cuda-tp2", "cuda-tp8", "off", "cpu-tp1", "cpu-tp2", "cpu-stub"])
def test_workers_get_graphs_on_cuda_whatever_tp(device, tp, flag, cls, want, monkeypatch):
    """A single-stage worker keeps step graphs on the card at any tp (in
    segments between its group's collectives at tp > 1); a CPU one steps
    eagerly unless its factory gives a ``StepGraphs`` class."""
    from atoma_infer_tpu_torch.config import CacheConfig, SchedulerConfig
    from atoma_infer_tpu_torch.engine.worker import ModelWorker

    zeros = torch.zeros
    # The worker's null feed on a device this CPU has not: allocate it here.
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: zeros(*a, **k))
    model = _Model(tp)
    worker = ModelWorker(model, {}, _Cache(device),
                         SchedulerConfig(max_num_batched_tokens=64, max_num_sequences=8,
                                         max_model_len=256, enable_chunked_prefill=True),
                         CacheConfig(block_size=16), cuda_graphs=flag, step_graphs=cls)
    monkeypatch.undo()
    if want is None:
        assert worker.graphs is None
        return
    assert isinstance(worker.graphs, cls or StepGraphs)
    assert worker.graphs.group is (model.group if want == "segments" else None)


def test_a_segments_view_does_not_own_its_memory():
    """``_view_of``: the same memory, shape and strides, written through,
    over a storage of its own; ``_alias`` keeps a CPU tensor itself (the
    CPU allocator hands freed memory back)."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    y = _view_of(x)
    assert y.shape == x.shape and y.stride() == x.stride() and y.dtype == x.dtype
    assert y.data_ptr() == x.data_ptr()
    assert y.untyped_storage()._cdata != x.untyped_storage()._cdata
    y[1, 2] = -1.0
    assert x[1, 2] == -1.0
    assert _alias(x) is x
