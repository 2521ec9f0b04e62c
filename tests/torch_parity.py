"""Shared helpers for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made once with numpy from a seed and handed to both packages: to
the JAX package as ``jnp`` arrays, to the port as CPU tensors.
"""

from __future__ import annotations

import os

import ml_dtypes
import numpy as np
import torch

from atoma_infer_tpu_torch.engine.cuda_graphs import StepGraphs
from atoma_infer_tpu_torch.ops.attention import AttentionMetadata as TorchMeta


def ragged_case(
    rng,
    seq_specs,          # list of (q_len, kv_len)
    *,
    num_q_heads=4,
    num_kv_heads=2,
    head_dim=32,
    block_size=16,
    num_blocks=48,
    pad_tokens_to=8,
    pad_seqs_to=None,
):
    """A ragged batch over a random-filled page-major cache, every sequence
    on randomly permuted disjoint pages, plus decode-style slot mapping for
    each sequence's query tokens. Returns a dict of numpy arrays."""
    S = pad_seqs_to or len(seq_specs)
    total_q = sum(q for q, _ in seq_specs)
    T = -(-total_q // pad_tokens_to) * pad_tokens_to
    P = max(max(-(-kv // block_size) for _, kv in seq_specs), 2)
    perm = rng.permutation(num_blocks)
    tables = np.zeros((S, P), dtype=np.int32)
    seq_lens = np.zeros(S, dtype=np.int32)
    qsl = np.zeros(S + 1, dtype=np.int32)
    slots = np.full(T, -1, dtype=np.int32)
    used = 0
    for s, (q_len, kv_len) in enumerate(seq_specs):
        n = -(-kv_len // block_size)
        tables[s, :n] = perm[used: used + n]
        used += n
        assert used <= num_blocks
        seq_lens[s] = kv_len
        qsl[s + 1] = qsl[s] + q_len
        for i in range(q_len):
            pos = kv_len - q_len + i
            slots[qsl[s] + i] = tables[s, pos // block_size] * block_size + pos % block_size
    qsl[len(seq_specs) + 1:] = qsl[len(seq_specs)]
    row = 2 * num_kv_heads * head_dim
    return dict(
        q=rng.standard_normal((T, num_q_heads, head_dim)).astype(np.float32),
        kv_cache=rng.standard_normal((num_blocks, block_size, row)).astype(np.float32),
        k_new=rng.standard_normal((T, num_kv_heads, head_dim)).astype(np.float32),
        v_new=rng.standard_normal((T, num_kv_heads, head_dim)).astype(np.float32),
        block_tables=tables,
        seq_lens=seq_lens,
        query_start_loc=qsl,
        slot_mapping=slots,
        num_seqs=len(seq_specs),
        block_size=block_size,
        max_q_len=max(q for q, _ in seq_specs),
        decode_only=all(q == 1 for q, _ in seq_specs),
    )


def jax_meta(case):
    import jax.numpy as jnp

    from atoma_infer_tpu.ops.attention import AttentionMetadata

    return AttentionMetadata(
        slot_mapping=jnp.asarray(case["slot_mapping"]),
        block_tables=jnp.asarray(case["block_tables"]),
        seq_lens=jnp.asarray(case["seq_lens"]),
        query_start_loc=jnp.asarray(case["query_start_loc"]),
        num_seqs=jnp.asarray(case["num_seqs"], jnp.int32),
        block_size=case["block_size"],
        decode_only=case["decode_only"],
    )


def torch_meta(case, device="cpu"):
    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return TorchMeta(
        slot_mapping=t(case["slot_mapping"]),
        block_tables=t(case["block_tables"]),
        seq_lens=t(case["seq_lens"]),
        query_start_loc=t(case["query_start_loc"]),
        num_seqs=t([case["num_seqs"]]),
        block_size=case["block_size"],
        decode_only=case["decode_only"],
        max_q_len=case["max_q_len"],
    )


def model_step(seq_lens, q_lens, tables, stream, bs=16):
    """One model step over sequences on the pages ``tables``: each of
    ``q_lens`` new tokens of ``stream`` per sequence, ending at
    ``seq_lens``. Returns (case dict, positions, token ids)."""
    S = len(seq_lens)
    T = -(-sum(q_lens) // 8) * 8
    bt = np.zeros((S, max(len(t) for t in tables)), np.int32)
    qsl = np.zeros(S + 1, np.int32)
    slots = np.full(T, -1, np.int32)
    positions = np.zeros(T, np.int32)
    toks = np.zeros(T, np.int32)
    for s, (kv, q, t) in enumerate(zip(seq_lens, q_lens, tables)):
        bt[s, : len(t)] = t
        qsl[s + 1] = qsl[s] + q
        for i in range(q):
            pos = kv - q + i
            slots[qsl[s] + i] = t[pos // bs] * bs + pos % bs
            positions[qsl[s] + i] = pos
            toks[qsl[s] + i] = stream[s][pos]
    case = dict(
        block_tables=bt, seq_lens=np.asarray(seq_lens, np.int32), query_start_loc=qsl,
        slot_mapping=slots, num_seqs=S, block_size=bs, max_q_len=max(q_lens),
        decode_only=all(q == 1 for q in q_lens),
    )
    return case, positions, toks


def valid_rows(case) -> int:
    """Token rows holding real queries (later rows are padding)."""
    return int(case["query_start_loc"][case["num_seqs"]])


FIXTURE_TINY_TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_trained")

# numpy dtypes (ml_dtypes for the 16- and 8-bit floats) ↔ torch dtypes, and
# the integer type of the same width each is viewed as to cross over.
_BIT_VIEWS = {
    np.dtype(ml_dtypes.bfloat16): (torch.bfloat16, np.int16, torch.int16),
    np.dtype(ml_dtypes.float8_e4m3fn): (torch.float8_e4m3fn, np.uint8, torch.uint8),
}


def to_torch(a) -> torch.Tensor:
    """A numpy or JAX array → a CPU tensor with the same bytes (bfloat16
    and float8_e4m3fn included)."""
    a = np.asarray(a)
    if a.dtype in _BIT_VIEWS:
        dtype, np_int, _ = _BIT_VIEWS[a.dtype]
        return torch.from_numpy(np.ascontiguousarray(a).view(np_int)).view(dtype)
    return torch.from_numpy(np.ascontiguousarray(a))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor → numpy with the same bytes (ml_dtypes for bfloat16 and
    float8_e4m3fn)."""
    for np_dtype, (dtype, np_int, torch_int) in _BIT_VIEWS.items():
        if t.dtype == dtype:
            return t.contiguous().view(torch_int).numpy().view(np_dtype)
    return t.numpy()


def quantized_case(rng, seq_specs, kv_dtype, **kw):
    """``ragged_case`` over a 1-byte cache. ``"fp8"``: the random cache
    clipped to ±448 and rounded to e4m3. ``"int8"``: each slot's K and V
    halves quantized with their own absmax scale, rounded through bf16
    (``kv_scales`` [pages, bs, 2], K then V, as ml_dtypes bfloat16)."""
    case = ragged_case(rng, seq_specs, **kw)
    cache = case["kv_cache"]
    if kv_dtype == "fp8":
        case["kv_cache"] = np.clip(cache, -448, 448).astype(ml_dtypes.float8_e4m3fn)
        return case
    assert kv_dtype == "int8"
    D = case["q"].shape[2]
    nb, bs, row = cache.shape
    flat = cache.reshape(nb * bs, row)
    lanes_k = (np.arange(row) // D) % 2 == 0
    scales = np.stack(
        [np.abs(flat[:, lanes_k]).max(axis=1), np.abs(flat[:, ~lanes_k]).max(axis=1)], axis=1
    )
    scales = np.maximum(scales / np.float32(127), np.float32(1e-8))
    scales = scales.astype(ml_dtypes.bfloat16).astype(np.float32)
    sc_row = np.where(lanes_k[None, :], scales[:, :1], scales[:, 1:])
    quant = np.clip(np.round(flat * (np.float32(1) / sc_row)), -127, 127).astype(np.int8)
    case["kv_cache"] = quant.reshape(nb, bs, row)
    case["kv_scales"] = scales.astype(ml_dtypes.bfloat16).reshape(nb, bs, 2)
    return case


def jax_scale_pages(kv_scales) -> np.ndarray:
    """Port-layout scales [pages, bs, 2] → the JAX package's 128-lane bf16
    scale pages (K in lane 0, V in lane 1, zeros elsewhere)."""
    from atoma_infer_tpu.ops.kv_cache import SCALE_LANES

    s = np.asarray(kv_scales).astype(ml_dtypes.bfloat16)
    pages = np.zeros(s.shape[:2] + (SCALE_LANES,), ml_dtypes.bfloat16)
    pages[..., :2] = s
    return pages


# ------------------------------------------------ head dims past 512
def bf16_round(x) -> np.ndarray:
    """f32 values rounded to bf16 and back (round to nearest even)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def column_slice_model(q, k, v, visible, *, scale, k_scale=None, v_scale=None, key_tile=32,
                       width=512):
    """A numpy model of the width-512 kernels' column slices on one block's
    rows: ``q`` [R, D], ``k`` and ``v`` [N, D] f32 (a 1-byte cache's values
    widened, their INT8 scales ``k_scale``, ``v_scale`` [N] apart),
    ``visible`` [R, N]. Slice cs of ceil(D / width) sums each key tile's
    scores over the whole head a ``width``-column chunk at a time, in chunk
    order (× the key scale × ``scale``), runs the online softmax over tiles
    of ``key_tile`` keys, rounds P to bf16 after the V scale and multiplies
    it by V's columns of the slice only. Returns (out [R, D], each slice's
    final (m, l))."""
    R, D = q.shape
    N = k.shape[0]
    ones = np.ones(N, np.float32)
    k_scale = ones if k_scale is None else np.asarray(k_scale, np.float32)
    v_scale = ones if v_scale is None else np.asarray(v_scale, np.float32)
    out, states = np.zeros((R, D), np.float32), []
    for c0 in range(0, D, width):
        cols = slice(c0, min(D, c0 + width))
        m = np.full(R, -np.inf, np.float32)
        l = np.zeros(R, np.float32)
        o = np.zeros((R, cols.stop - c0), np.float32)
        for t0 in range(0, N, key_tile):
            keys = slice(t0, min(N, t0 + key_tile))
            s = np.zeros((R, keys.stop - t0), np.float32)
            for d0 in range(0, D, width):
                chunk = slice(d0, min(D, d0 + width))
                s += q[:, chunk] @ k[keys, chunk].T
            s = np.where(visible[:, keys], s * k_scale[keys] * np.float32(scale), -np.inf)
            m_new = np.maximum(m, s.max(axis=1))
            m_use = np.where(np.isneginf(m_new), 0, m_new).astype(np.float32)
            alpha, p = np.exp(m - m_use), np.exp(s - m_use[:, None])
            l = l * alpha + p.sum(axis=1)
            o = o * alpha[:, None] + bf16_round(p * v_scale[keys]) @ v[keys, cols]
            m = m_new
        out[:, cols] = np.where(l[:, None] > 0, o / np.where(l > 0, l, 1)[:, None], 0)
        states.append((m, l))
    return out, states


# ------------------------------------------------- tensor parallelism (spawn)
# Spawned ranks import this module (not the test files, which import JAX):
# the functions they run live here.

def flat_params(params, prefix=""):
    """A parameter tree (JAX arrays, numpy arrays or tensors; layers under
    ``layers``) → {"embed": a, "layers/q_proj": a, ...} of numpy arrays."""
    out = {}
    for key, value in params.items():
        if isinstance(value, dict):
            out.update(flat_params(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def save_params(path, params) -> str:
    """Dense f32 parameters (the JAX package's tree) → an ``.npz`` file that
    every rank loads (``npz_model``)."""
    np.savez(path, **flat_params(params))
    return str(path)


def npz_model(device, path, family, widths, dtype=torch.float32):
    """(model, params, tokenizer) of the port: ``family`` ("llama" or
    "mixtral") at ``widths`` (config fields), in ``dtype`` (f32 by default),
    the parameters of the ``.npz`` at ``path``. A ``ModelFactory`` build:
    picklable by import path, so that spawned ranks run it."""
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    if family == "mixtral":
        from atoma_infer_tpu_torch.models.mixtral import Mixtral as cls, MixtralConfig as cfg_cls
    else:
        from atoma_infer_tpu_torch.models.llama import Llama as cls, LlamaConfig as cfg_cls
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    cfg = cfg_cls(**widths)
    model = cls(cfg, dtype=dtype, device=device)
    return model, params_from_numpy(tree, dtype, device), ByteTokenizer(cfg.vocab_size)


def npz_factory(path, family, widths, step_graphs=None):
    """The ``ModelFactory`` of :func:`npz_model`; ``step_graphs``: the
    ``StepGraphs`` class every rank's workers keep (e.g.
    :class:`StubStepGraphs`)."""
    from atoma_infer_tpu_torch.engine.llm_service import ModelFactory
    from atoma_infer_tpu_torch.models.llama import LlamaConfig
    from atoma_infer_tpu_torch.models.mixtral import MixtralConfig

    cfg = (MixtralConfig if family == "mixtral" else LlamaConfig)(**widths)
    return ModelFactory(config=cfg, build=npz_model, args=(str(path), family, dict(widths)),
                        step_graphs=step_graphs)


# ------------------------------------------------------- stub step graphs
def clone_tree(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(clone_tree(o) for o in out)
    return out


def copy_into(old, new):
    if isinstance(old, torch.Tensor):
        if old is not new:
            old.copy_(new)
    elif old is not None:
        for o, n in zip(old, new):
            copy_into(o, n)


class _SegmentRunner:
    """Replays a segmented capture on the CPU by recomputing: each replay
    runs the captured step on a thread of its own, which stops at each of
    the model's collectives — it writes the collective's operand into the
    tensor the capture recorded, and waits while the replay runs the real
    collective on it — and reads on from that tensor (the gather's from its
    static output), as the next segment's graph reads the same memory on
    the card. The last segment's replay ends the step, copies its outputs
    into the captured ones and joins the thread. The step and the group are
    the graphs' (held weakly: no reference cycle keeps a rank's process
    groups alive until its interpreter exits)."""

    def __init__(self, graphs, views, entry):
        import threading
        import weakref

        self.graphs, self.views, self.entry = weakref.ref(graphs), views, entry
        self.reached = threading.Semaphore(0)
        self.resume = threading.Semaphore(0)
        self.thread = None
        self.done = False
        self.k = 0
        self.error = None

    def _pause(self, op, x):
        seg = self.entry.segments[self.k]
        if seg.op != op or tuple(seg.tensor.shape) != tuple(x.shape):
            raise AssertionError(f"collective {self.k}: {op} {tuple(x.shape)}, captured "
                                 f"{seg.op} {tuple(seg.tensor.shape)}")
        seg.tensor.copy_(x)
        self.k += 1
        self.reached.release()
        self.resume.acquire()
        return seg.out if op == "gather" else seg.tensor

    def _body(self, step, group):
        try:
            with torch.inference_mode(), group.segmented(self._pause):
                out = step(*self.views)
                if self.k != len(self.entry.segments) - 1:
                    raise AssertionError(f"{self.k} collectives replayed, "
                                         f"{len(self.entry.segments) - 1} captured")
                copy_into(self.entry.outputs, out)
        except BaseException as e:  # handed to the replaying thread
            self.error = e
        finally:
            self.done = True
            self.reached.release()

    def advance(self):
        """Run the step up to its next collective, or to its end (then the
        thread is joined)."""
        import threading

        if self.thread is None:
            graphs = self.graphs()
            self.k, self.done = 0, False
            self.thread = threading.Thread(target=self._body, args=(graphs.step, graphs.group),
                                           daemon=True)
            self.thread.start()
        else:
            self.resume.release()
        self.reached.acquire()
        if self.done:
            self.thread.join(RANK_TIMEOUT_S)
            if self.thread.is_alive():
                raise AssertionError("a replay's thread did not end")
            self.thread = None
        if self.error is not None:
            error, self.error = self.error, None
            raise error


class _Rerun:
    """A tp 1 stub graph's replay: the step again, into its outputs."""

    def __init__(self, graphs, views, entry):
        import weakref

        self.graphs, self.views, self.entry = weakref.ref(graphs), views, entry

    @torch.inference_mode()
    def advance(self):
        copy_into(self.entry.outputs, self.graphs().step(*self.views))


class _StubSegment:
    def __init__(self):
        self.runner = None

    def replay(self):
        self.runner.advance()


class StubStepGraphs(StepGraphs):
    """``StepGraphs`` on the CPU: the capture is the port's own
    (``_record``, segments cut at the group's collectives) with graphs that
    record nothing, and a replay recomputes (:class:`_SegmentRunner`, or
    the step itself at tp 1) with the step function of the run in progress
    (``step``, set only while one runs). On the CPU the capture's run
    computes — with no collective, so a rank's partial sums — and writes its
    step's K/V slots, which the card's capture does not; a replay right
    after the capture writes them again with the real collectives. Each run
    is logged in ``events``: (run, key, captured, evicted keys, the group's
    collectives in the run, less the capture's own replay's), and each
    capture's collectives in ``capture_collectives`` (0). A step's outputs
    are handed out as copies: on the card the host copy of the tokens is
    enqueued before the next replay overwrites them."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.events = []
        self.capture_collectives = []
        self.step = None
        self._fixup = 0

    def _new_graph(self):
        return _StubSegment()

    def _graph_capture(self, graph, pool):
        import contextlib

        return contextlib.nullcontext()

    def _count(self):
        return 0 if self.group is None else self.group.collectives

    def _capture(self, step, views):
        c0 = self._count()
        entry = self._record(step, views, None)
        self.capture_collectives.append(self._count() - c0)
        runner = (_Rerun if self.group is None else _SegmentRunner)(self, views, entry)
        for graph in [seg.graph for seg in entry.segments] or [entry.graph]:
            graph.runner = runner
        c1, self.step = self._count(), step
        try:
            self._replay(entry)
        finally:
            self.step = None
        self._fixup = self._count() - c1
        return entry

    def run(self, key, step, *args, **kw):
        before, c0 = list(self.graphs), self._count()
        captured = key not in self.graphs
        self._fixup = 0
        self.step = step
        try:
            out = super().run(key, step, *args, **kw)
        finally:
            self.step = None
        evicted = [_key_name(k) for k in before if k not in self.graphs]
        self.events.append((len(self.events), _key_name(key), captured, evicted,
                            self._count() - c0 - self._fixup))
        return clone_tree(out)


def _key_name(key):
    return (type(key).__name__, tuple(key))



def rendezvous_file(tmp_path, name="rdzv") -> str:
    """A ``file://`` rendezvous under the test's own directory: xdist
    workers never meet on a port."""
    return f"file://{tmp_path}/{name}"


# Seconds a spawned rank may take, start to exit.
RANK_TIMEOUT_S = 120


def _rank_main(fn, rank, tp, init, out, args):
    import pickle

    torch.set_num_threads(1)
    result = fn(rank, tp, init, *args)
    with open(out, "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn, tp, tmp_path, *args, timeout=RANK_TIMEOUT_S):
    """Run ``fn(rank, tp, init_method, *args)`` in ``tp`` spawned processes
    (``fn`` from this module), each joined within ``timeout`` seconds; every
    rank must exit 0. Returns their results in rank order."""
    import pickle
    import time

    ctx = torch.multiprocessing.get_context("spawn")
    init = rendezvous_file(tmp_path, f"ranks-{fn.__name__}")
    outs = [tmp_path / f"{fn.__name__}-rank{r}.pkl" for r in range(tp)]
    procs = [ctx.Process(target=_rank_main, args=(fn, r, tp, init, str(outs[r]), args))
             for r in range(tp)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p.name for p in procs if p.is_alive()]
        if hung:
            raise AssertionError(f"ranks {hung} did not exit in {timeout} s")
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise AssertionError(f"ranks exited with errors: {failed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def tp_engine_config(tp, *, kv_cache_dtype=None, coordinator_address=None,
                     pipeline_parallel_size=1, **sched):
    """The tensor-parallel services' configuration (``tests/test_engine_tp.py``
    ``make_service``'s, with the Python block manager), with
    ``pipeline_parallel_size`` stages."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )

    kw = dict(max_num_batched_tokens=512, max_num_sequences=16, max_model_len=512,
              enable_chunked_prefill=False, use_native_core=False)
    kw.update(sched)
    return EngineConfig(
        model=ModelConfig(model_name="injected", dtype="float32", tensor_parallel_size=tp,
                          pipeline_parallel_size=pipeline_parallel_size,
                          kv_cache_dtype=kv_cache_dtype,
                          coordinator_address=coordinator_address),
        cache=CacheConfig(block_size=16, num_device_blocks_override=128,
                          num_host_blocks_override=32),
        scheduler=SchedulerConfig(**kw),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )


def generate(service, prompts, *, max_new_tokens=12, abort_at=None):
    """Greedy ``prompts`` through a running-loop service → {request id:
    token ids}. ``abort_at=(step, request id)``: that request is aborted
    just before the engine's ``step``-th step."""
    import asyncio

    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    async def run():
        engine = service.engine
        if abort_at is not None:
            step, rid = abort_at
            inner, count = engine.step, [0]

            def counted():
                count[0] += 1
                if count[0] == step:
                    engine.abort_request(rid)
                return inner()

            engine.step = counted
        task = asyncio.create_task(engine.run())
        futs = [await service.handle_request(GenerateRequest(
            request_id=f"req-{i}", inputs=p,
            parameters=GenerateParameters(max_new_tokens=max_new_tokens, do_sample=False)))
            for i, p in enumerate(prompts)]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=RANK_TIMEOUT_S)
        service.stop()
        task.cancel()
        return {r.request_id: list(r.outputs[0].token_ids) for r in results}

    return asyncio.run(run())


def lockstep_rank(rank, tp, init, path, family, widths, prompts, sched, kv_cache_dtype,
                  abort_at=None):
    """One rank of a tensor-parallel service started by hand (the
    multi-host form: each rank builds its service on its group; rank 0
    attaches the lockstep hook and serves ``prompts``, the others run
    ``follower_loop``). Returns the rank's outputs, the digest of its
    schedule trace, the steps at which it applied aborts, and its KV caches
    and scales."""
    import hashlib
    import json

    from atoma_infer_tpu_torch.engine import multihost
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.parallel.distributed import init_distributed

    group = init_distributed(init, tp, rank, device=torch.device("cpu"), local_ranks=tp,
                             local_devices=1)
    config = tp_engine_config(tp, kv_cache_dtype=kv_cache_dtype, **sched)
    service = LlmService.start(config, model_factory=npz_factory(path, family, widths),
                               group=group)
    engine = service.engine
    trace, steps, aborted = hashlib.sha256(), [0], []
    schedule, step, abort = engine.scheduler.schedule, engine.step, \
        engine.scheduler.abort_sequence_group

    def traced_schedule():
        metas, outs = schedule()
        trace.update(json.dumps([(m.request_id, m.token_chunk_size, m.is_prompt,
                                  sorted(map(tuple, m.block_tables.items()))) for m in metas],
                                default=list).encode())
        return metas, outs

    def counted_step():
        steps[0] += 1
        return step()

    def traced_abort(rid):
        aborted.append((rid, steps[0]))
        return abort(rid)

    engine.scheduler.schedule = traced_schedule
    engine.step = counted_step
    engine.scheduler.abort_sequence_group = traced_abort
    if rank == 0:
        service.lockstep = multihost.attach_primary(service)
        outputs = generate(service, prompts, abort_at=abort_at)
    else:
        outputs = {r.request_id: list(r.outputs[0].token_ids)
                   for r in multihost.follower_loop(service)}
    ce = engine.worker.cache_engine
    return dict(
        outputs=outputs, digest=trace.hexdigest(), steps=steps[0], aborted=aborted,
        kv_cache=[c.numpy().copy() for c in ce.kv_cache],
        kv_scales=None if ce.kv_scales is None else [to_numpy(s).copy() for s in ce.kv_scales],
    )


def host_rank(rank, tp, init, raw, prompts):
    """One host of a multi-host service started from its configuration
    alone (``raw``, an ``EngineConfig.from_dict`` dict, with this rank's
    ``host_id`` and the rendezvous filled in): host 0 serves ``prompts``,
    the others follow. Returns the outputs and each stage's layer count."""
    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.engine.multihost import follower_loop

    raw = {key: dict(section) for key, section in raw.items()}
    raw["inference"].update(host_id=rank, coordinator_address=init)
    service = LlmService.start(EngineConfig.from_dict(raw), device="cpu")
    stages = [ce.num_layers for ce in service.engine.worker.cache_engines]
    if rank == 0:
        outputs = generate(service, prompts)
    else:
        outputs = {r.request_id: list(r.outputs[0].token_ids) for r in follower_loop(service)}
        service.tokenizer_pool.shutdown()
    return dict(outputs=outputs, stages=stages)


def cp_rank(rank, tp, init, batch, kw):
    """One rank of a context-parallel decode layer: ``batch`` (numpy q,
    k_new, v_new, the whole cache, and the metadata with GLOBAL page ids)
    with this rank's page range of the cache, the layer's options ``kw``.
    Returns the rank's output, its cache pages after the write, and its
    collectives."""
    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata
    from atoma_infer_tpu_torch.parallel.context_parallel import cp_decode_attention_layer
    from atoma_infer_tpu_torch.parallel.distributed import init_distributed

    group = init_distributed(init, tp, rank, device=torch.device("cpu"), local_ranks=tp,
                             local_devices=1)
    pages = batch["cache"].shape[0] // tp
    cache = torch.from_numpy(batch["cache"][rank * pages:(rank + 1) * pages].copy())
    S = batch["seq_lens"].shape[0]
    meta = AttentionMetadata(
        slot_mapping=torch.from_numpy(batch["slots"]),
        block_tables=torch.from_numpy(batch["tables"]),
        seq_lens=torch.from_numpy(batch["seq_lens"]),
        query_start_loc=torch.arange(S + 1, dtype=torch.int32),
        num_seqs=torch.tensor([S], dtype=torch.int32), block_size=batch["bs"],
        decode_only=True)
    out = cp_decode_attention_layer(
        torch.from_numpy(batch["q"]), cache, torch.from_numpy(batch["k_new"]),
        torch.from_numpy(batch["v_new"]), meta, group, scale=batch["q"].shape[2] ** -0.5, **kw)
    return dict(out=out.numpy(), cache=cache.numpy(), collectives=group.collectives)


def logits_rank(rank, tp, init, path, family, widths, steps, stream, tables):
    """One rank of a tensor-parallel model run by hand over ``steps``
    ((seq_lens, q_lens) each, ``model_step``'s): returns each step's gathered
    logits at the real rows."""
    from atoma_infer_tpu_torch.parallel.distributed import init_distributed
    from atoma_infer_tpu_torch.parallel.sharding import shard_params

    group = init_distributed(init, tp, rank, device=torch.device("cpu"), local_ranks=tp,
                             local_devices=1)
    model, params, _ = npz_model("cpu", path, family, widths)
    model.group = group
    params = shard_params(params, group, model.config.num_kv_heads)
    cache = model.alloc_kv_cache(16, 16)
    out = []
    for seq_lens, q_lens in steps:
        case, positions, toks = model_step(seq_lens, q_lens, tables[: len(seq_lens)], stream)
        hidden = model.forward(params, torch.from_numpy(toks), torch.from_numpy(positions),
                               cache, torch_meta(case))
        n = int(case["query_start_loc"][-1])
        out.append(model.compute_logits(params, hidden).numpy()[:n])
    return out


def collectives_rank(rank, tp, init, payloads):
    """Every collective of a ``TpGroup`` once, and each payload through
    ``broadcast_step_payload`` (rank 0 sends): returns what the rank got."""
    from atoma_infer_tpu_torch.parallel.distributed import (
        broadcast_step_payload, init_distributed,
    )

    group = init_distributed(init, tp, rank, device=torch.device("cpu"), local_ranks=tp,
                             local_devices=1)
    x = torch.full((3, 2), float(rank + 1))
    got = dict(
        sum=group.all_reduce_sum(x.clone()).tolist(),
        max=group.all_reduce_max(torch.tensor([[rank, -rank]], dtype=torch.float32)).tolist(),
        gather=group.all_gather_last(torch.full((2, 1), float(rank))).tolist(),
        min=group.min_int(10 + rank),
        payloads=[broadcast_step_payload(group, p if rank == 0 else None) for p in payloads],
    )
    got["collectives"] = group.collectives
    return got


def npz_model_failing_on_followers(device, path, family, widths):
    """:func:`npz_model` on rank 0; raises in a follower rank's process
    (named ``atoma-tp-rank<r>`` by ``LlmService.start``)."""
    if torch.multiprocessing.current_process().name.startswith("atoma-tp-rank"):
        raise RuntimeError("a follower rank fails to build its model")
    return npz_model(device, path, family, widths)


def segments_rank(rank, tp, init, path, family, widths, dtype_name, kv_cache_dtype, steps,
                  stream, tables):
    """One rank of a tensor-parallel model run by hand over ``steps``
    ((seq_lens, q_lens) each, ``model_step``'s) on a cache engine of its
    own (``kv_cache_dtype``: None or "int8"): each step eagerly, its
    collectives recorded (op, operand shape); then captured through
    :class:`StubStepGraphs` (``_record``: the port's segmenter) and
    replayed (``_replay``). Returns, by step, the eager and the captured collectives, the
    collectives the capture and the replay issued, the eager and the
    replayed outputs (the logits and their argmax, computed in the last
    segment) and the gather's static outputs after the replay (an untied LM
    head's logits are vocab-sharded and gathered; a tied head's are whole
    on every rank)."""
    from atoma_infer_tpu_torch.engine.cache_engine import CacheEngine
    from atoma_infer_tpu_torch.parallel.distributed import init_distributed
    from atoma_infer_tpu_torch.parallel.sharding import shard_params

    dtype = getattr(torch, dtype_name)
    group = init_distributed(init, tp, rank, device=torch.device("cpu"), local_ranks=tp,
                             local_devices=1)
    model, params, _ = npz_model("cpu", path, family, widths, dtype)
    model.group = group
    params = shard_params(params, group, model.config.num_kv_heads)
    ce = CacheEngine(num_layers=model.config.num_layers, num_kv_heads=model.local_kv_heads,
                     head_dim=model.config.head_dim, block_size=16, num_device_blocks=16,
                     num_host_blocks=0, device="cpu",
                     dtype=torch.int8 if kv_cache_dtype == "int8" else dtype)
    eager_ops = []

    class Recording:
        """The group's collectives, each recorded as the eager step calls it."""

        def __init__(self, op, fn):
            self.op, self.fn = op, fn

        def __call__(self, x, *a, **kw):
            eager_ops.append((self.op, tuple(x.shape)))
            return self.fn(x, *a, **kw)

    out = []
    for seq_lens, q_lens in steps:
        case, positions, toks = model_step(seq_lens, q_lens, tables[: len(seq_lens)], stream)
        meta = torch_meta(case)

        @torch.inference_mode()
        def step(tokens, pos):
            hidden = model.forward(params, tokens, pos, ce.kv_cache, meta,
                                   kv_scales=ce.kv_scales)
            logits = model.compute_logits(params, hidden)
            return logits * 1, logits.argmax(dim=-1)

        views = (torch.from_numpy(toks), torch.from_numpy(positions))
        eager_ops.clear()
        for op, name in (("sum", "all_reduce_sum"), ("max", "all_reduce_max"),
                         ("gather", "all_gather_last")):
            setattr(group, name, Recording(op, getattr(group, name)))
        c0 = group.collectives
        eager = step(*views)
        eager_collectives = group.collectives - c0
        for name in ("all_reduce_sum", "all_reduce_max", "all_gather_last"):
            delattr(group, name)
        graphs = StubStepGraphs(8, 8, 64, group=group)
        entry = graphs._capture(step, views)   # the segmenter, then one replay
        (capture_collectives,), replay_collectives = graphs.capture_collectives, graphs._fixup
        gathers = [seg for seg in entry.segments if seg.op == "gather"]
        out.append(dict(
            eager_ops=list(eager_ops),
            captured=[(seg.op, None if seg.tensor is None else tuple(seg.tensor.shape))
                      for seg in entry.segments],
            gather_out=[tuple(seg.out.shape) for seg in gathers],
            eager_collectives=eager_collectives, capture_collectives=capture_collectives,
            replay_collectives=replay_collectives,
            eager=[t.float().numpy().copy() for t in eager],
            replayed=[t.float().numpy().copy() for t in entry.outputs],
            gathered=[seg.out.float().numpy().copy() for seg in gathers],
        ))
    return out


def graphs_lockstep_rank(rank, tp, init, path, widths, prompts, sched, kv_cache_dtype,
                         pipeline_parallel_size=1):
    """One rank of a tensor-parallel service started by hand (as
    :func:`lockstep_rank`), whose workers keep :class:`StubStepGraphs`
    through its factory, at most one graph each (this rank's process keeps
    ``MAX_GRAPHS`` at 1: a step of another key evicts): rank 0 serves
    ``prompts``, the others follow. Returns the rank's outputs, and its
    graphs' ``events`` and capture collectives (every stage's under PP)."""
    from atoma_infer_tpu_torch.engine import cuda_graphs, multihost
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.parallel.distributed import init_distributed

    cuda_graphs.MAX_GRAPHS = 1

    group = init_distributed(init, tp, rank, device=torch.device("cpu"), local_ranks=tp,
                             local_devices=1)
    config = tp_engine_config(tp, kv_cache_dtype=kv_cache_dtype,
                              pipeline_parallel_size=pipeline_parallel_size, **sched)
    factory = npz_factory(path, "llama", widths, step_graphs=StubStepGraphs)
    service = LlmService.start(config, model_factory=factory, group=group)
    worker = service.engine.worker
    graphs = [st.graphs for st in worker.stages] if pipeline_parallel_size > 1 \
        else [worker.graphs]
    if rank == 0:
        service.lockstep = multihost.attach_primary(service)
        outputs = generate(service, prompts)
    else:
        outputs = {r.request_id: list(r.outputs[0].token_ids)
                   for r in multihost.follower_loop(service)}
    return dict(outputs=outputs, events=[g.events for g in graphs],
                capture_collectives=[g.capture_collectives for g in graphs])
