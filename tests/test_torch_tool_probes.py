"""The port's ``attn_bench`` and ``engine_step_probe`` (``atoma_infer_tpu_torch/tools``)
against the JAX package, on the CPU.

- ``attn_bench``'s steps at the tool's CPU shapes (4 sequences, 8 q heads
  over 4 kv heads of 32, blocks of 32, contexts 64 and 192, 2 rounds of 2
  steps after round 0) over bf16, INT8 and e4m3 pools with permuted and
  contiguous tables, on the JAX tool's numpy draws, against the same steps
  through JAX's ``ragged_paged_attention_fused`` and
  ``ragged_paged_attention_fused_quant`` in interpret mode, each step on the
  tables and slots the tool gave it (its page sets rotated): the last
  step's output within ``TOL``, the pool after every step and an INT8
  pool's scales byte for byte (JAX's 128-lane scale pages cut to the port's
  two lanes);
- the tool's accounting: the cache bytes a step reads in the port's layout
  and the least time for its work at 32,640 keys (and the bf16 bounds at
  512, 2,048 and 8,192), and its page sets at the card's defaults;
- ``engine_step_probe``'s steps on the CPU configuration in f32, the
  weights JAX's carried across by ``params_from_numpy``: the tokens of its
  first step, (a) and (b), 8 steps each over 32 sequences, equal those of
  JAX's ``ModelWorker._invoke`` fed the same inputs;
- both tools' ``--cpu`` runs end in their JSON line (the device default
  without a card: ``tests/test_torch_tools.py``).

Tolerance: bf16 queries and new rows, ``TOL`` 2e-2 as in
``test_torch_fused_split.py`` (``ATTN_TOL["bfloat16"]`` of
``chip_smoke.py``: one rounding of the output to bf16, P in bf16 in the
Pallas kernel); caches and scales after a write byte for byte.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from atoma_infer_tpu.ops.attention import AttentionMetadata as JaxMeta
from atoma_infer_tpu_torch.tools import attn_bench as ab
from atoma_infer_tpu_torch.tools import engine_step_probe as esp
from jax_compiled import ragged_paged_attention_fused, ragged_paged_attention_fused_quant

torch.set_num_threads(2)

TOL = 2e-2
BS = 32


def _bytes(a):
    a = a.cpu().view(torch.uint8).numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _jax_tool_draws(kind, contiguous):
    """The JAX tool's pool, scale pages and tables at its --cpu sizes, drawn
    in its order from ``default_rng(0)`` (``tools/attn_bench.py:94-113``):
    (rng, kv0, JAX's scale pages or None, tables)."""
    seqs, max_ctx, _, _ = ab.CPU_SIZES
    _, hk, d = ab.CPU_HEADS
    P = max_ctx // BS + 1
    num_blocks = seqs * P + 8
    shape = (num_blocks, BS, 2 * hk * d)
    rng = np.random.default_rng(0)
    pages = None
    if kind == "int8":
        kv0 = rng.integers(-127, 128, shape).astype(np.int8)
        pages = np.zeros((num_blocks, BS, 128), ml_dtypes.bfloat16) + ml_dtypes.bfloat16(0.01)
    else:
        dtype = ml_dtypes.bfloat16 if kind == "bf16" else ml_dtypes.float8_e4m3fn
        kv0 = rng.standard_normal(shape).astype(dtype)
    blocks, tables = ab.page_tables(seqs, P, contiguous, rng)
    assert blocks == num_blocks
    return rng, kv0, pages, tables


@pytest.mark.parametrize("contiguous", [False, True], ids=["permuted", "contiguous"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "e4m3"])
def test_attn_bench_steps_match_jax_fused(kind, contiguous):
    seqs, _, ctxs, steps = ab.CPU_SIZES
    hq, hk, d = ab.CPU_HEADS
    rng, kv0, pages, tables = _jax_tool_draws(kind, contiguous)
    bench = ab.AttnBench(kv0, None if pages is None else pages[..., :2], tables, device="cpu",
                         block_size=BS, heads=ab.CPU_HEADS, inner=steps, outer=steps)
    cache, scales = jnp.asarray(kv0), None if pages is None else jnp.asarray(pages)
    rotations_seen = set()
    for ctx in ctxs:
        q = rng.standard_normal((seqs, hq, d)).astype(ml_dtypes.bfloat16)
        kn = jnp.asarray(rng.standard_normal((seqs, hk, d)).astype(ml_dtypes.bfloat16))
        got = bench.run(ctx, q, np.asarray(kn))["out"].float().numpy()
        R, touched = bench.page_sets(ctx)
        rotations_seen.add(R)
        page_sets = [np.roll(tables, -r * touched, axis=1) for r in range(R)]
        for o in range(steps + 1):
            kv_len = ctx + o
            for i in range(steps):
                t = page_sets[i % R]
                meta = JaxMeta(
                    slot_mapping=jnp.asarray(t[np.arange(seqs), kv_len // BS] * BS + kv_len % BS,
                                             jnp.int32),
                    block_tables=jnp.asarray(t),
                    seq_lens=jnp.full((seqs,), kv_len + 1, jnp.int32),
                    query_start_loc=jnp.arange(seqs + 1, dtype=jnp.int32),
                    num_seqs=jnp.asarray(seqs, jnp.int32),
                    block_size=BS, decode_only=True)
                if kind == "int8":
                    out, cache, scales = ragged_paged_attention_fused_quant(
                        jnp.asarray(q), cache, scales, kn, kn, meta, scale=d ** -0.5,
                        interpret=True)
                else:
                    out, cache = ragged_paged_attention_fused(
                        jnp.asarray(q), cache, kn, kn, meta, scale=d ** -0.5, interpret=True)
        np.testing.assert_allclose(got, np.asarray(out).astype(np.float32), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(_bytes(bench.kv_cache), _bytes(cache))
        if kind == "int8":
            np.testing.assert_array_equal(_bytes(bench.kv_scales),
                                          _bytes(np.asarray(scales)[..., :2]))
    # Contexts of 64 keys rotate between two page sets here; 192 take one.
    assert rotations_seen == {1, 2}


def test_attn_bench_counts_bytes_in_the_ports_layout():
    """A step's cache bytes at 32,640 keys and 64 sequences of Llama-3.2-1B
    attention: rows of 2·8·64 elements, 2 bytes each in bf16, 1 in INT8 and
    e4m3, and INT8's 4 bytes of scales a token; the least times at 3.35
    TB/s, bound by the bytes."""
    row = 2 * 8 * 64
    assert ab.kv_bytes(64, 32640, row, "bf16") == 4_278_190_080
    assert ab.kv_bytes(64, 32640, row, "int8") == 2_147_450_880
    assert ab.kv_bytes(64, 32640, row, "e4m3") == 2_139_095_040
    for kind, ms in (("bf16", 1.277), ("int8", 0.641), ("e4m3", 0.639)):
        bound, by = ab.step_bound(64, [32640], ab.CARD_HEADS, kind)
        assert (round(bound, 3), by) == (ms, "bytes")
    for ctx, ms in ((512, 0.020), (2048, 0.080), (8192, 0.321)):
        assert round(ab.step_bound(64, [ctx], ab.CARD_HEADS, "bf16")[0], 3) == ms


def test_attn_bench_page_sets_at_the_card_defaults():
    """At the card's defaults (P = 1,025 pages a sequence, 8 rounds of 8
    steps) a step at 512 keys touches 17 pages and rotates among 8 page
    sets; at 32,640 keys 1,021 pages, one set; past the tables it raises."""
    tables = np.zeros((64, 32768 // BS + 1), np.int32)
    bench = ab.AttnBench(torch.zeros((1, BS, 1024), dtype=torch.bfloat16), None, tables,
                         device="cpu", block_size=BS, heads=ab.CARD_HEADS, inner=8, outer=8)
    assert bench.page_sets(512) == (8, 17)
    assert bench.page_sets(8192) == (3, 257)
    assert bench.page_sets(32640) == (1, 1021)
    with pytest.raises(ValueError, match="pass the tables"):
        bench.page_sets(32800)


def _jax_probe_tokens(jmodel, jparams, seqs, steps):
    """JAX's ``ModelWorker._invoke`` driven as ``tools/engine_step_probe.py``
    drives it (its first step, then (a)'s and (b)'s steps), in f32: every
    step's tokens [1 + 2·steps, seqs]."""
    from atoma_infer_tpu.config import CacheConfig, SchedulerConfig
    from atoma_infer_tpu.engine.cache_engine import CacheEngine
    from atoma_infer_tpu.engine.input_prep import ModelInput
    from atoma_infer_tpu.engine.sampler import SamplingTensors
    from atoma_infer_tpu.engine.worker import ModelWorker
    from atoma_infer_tpu.sampling_params import NextTokenChooserParameters

    cfg, S, bs, ctx = jmodel.config, seqs, esp.BLOCK_SIZE, esp.CTX
    total, pages_per_seq, num_blocks = esp.sizes(seqs, steps)
    worker = ModelWorker(
        jmodel, jparams,
        CacheEngine(num_layers=cfg.num_hidden_layers, num_kv_heads=cfg.num_key_value_heads,
                    head_dim=cfg.head_dim, block_size=bs, num_device_blocks=num_blocks,
                    num_host_blocks=8, dtype=jnp.float32),
        SchedulerConfig(max_num_batched_tokens=max(S * ctx, total + 1), max_num_sequences=S,
                        max_model_len=total + 1),
        CacheConfig(block_size=bs, num_device_blocks_override=num_blocks,
                    num_host_blocks_override=8))
    rng = np.random.default_rng(0)
    P = worker.max_pages_per_seq
    tables = np.zeros((S, P), dtype=np.int32)
    perm = (rng.permutation(num_blocks - 1)[: S * pages_per_seq] + 1).reshape(S, pages_per_seq)
    tables[:, : min(P, pages_per_seq)] = perm[:, :P]
    sampling = SamplingTensors.build([NextTokenChooserParameters()] * S, [[0]] * S, S, [0] * S)
    arrays = {name: jnp.asarray(getattr(sampling, name)) for name in (
        "temperature", "top_k", "top_p", "typical_p", "do_sample", "seeds",
        "repetition_penalty", "frequency_penalty", "recent_tokens")}
    zero_steps = np.zeros(S, dtype=np.int32)
    prev_map = np.arange(S, dtype=np.int32)

    def model_input_for(i):
        kv_len = ctx + i
        page = tables[np.arange(S), (kv_len // bs) % P]
        return ModelInput(
            token_ids=np.zeros(S, np.int32), positions=np.full(S, kv_len, np.int32),
            slot_mapping=(page * bs + kv_len % bs).astype(np.int32), block_tables=tables,
            seq_lens=np.full(S, kv_len + 1, np.int32),
            query_start_loc=np.arange(S + 1, dtype=np.int32),
            num_seqs=np.asarray(S, dtype=np.int32),
            selected_token_indices=np.arange(S, dtype=np.int32), sample_mask=np.ones(S, bool),
            seq_ids=list(range(S)), request_ids=[f"r{j}" for j in range(S)], num_prefills=0)

    toks, trail = jnp.zeros((S,), jnp.int32), []
    for i in [0] + list(range(1, 1 + 2 * steps)):
        toks, _, _ = worker._invoke(model_input_for(i), arrays, zero_steps, sampling,
                                    prev=(toks, prev_map))
        trail.append(np.asarray(toks))
    return np.stack(trail)


def test_probe_steps_match_jax_worker():
    from atoma_infer_tpu.models.llama import Llama as JaxLlama
    from atoma_infer_tpu.models.llama import LlamaConfig as JaxConfig
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import params_from_numpy

    seqs, steps = esp.CPU_LIMITS
    cfg = esp.llama_config(on_card=False)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "head_dim", "max_position_embeddings",
        "tie_word_embeddings")})
    jmodel = JaxLlama(jcfg, dtype=jnp.float32)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = Llama(cfg, dtype=torch.float32, device="cpu")
    worker = esp.build_worker(model, params_from_numpy(jparams), seqs=seqs, steps=steps,
                              cuda_graphs=True)
    assert worker.graphs is None  # a CPU worker steps eagerly
    run = esp.probe(worker, seqs=seqs, steps=steps)
    assert run["tokens"].shape == (1 + 2 * steps, seqs)
    np.testing.assert_array_equal(run["tokens"], _jax_probe_tokens(jmodel, jparams, seqs, steps))
    assert run["replay_ms"] is None and run["chained_ms"] > 0 and run["fetch_every_step_ms"] > 0


@pytest.mark.parametrize("tool, metric", [(ab, "attn_kernel_bandwidth"),
                                          (esp, "engine_step_probe")],
                         ids=["attn_bench", "engine_step_probe"])
def test_cpu_run_ends_in_its_json_line(tool, metric, capsys):
    report = tool.main(["--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    last = json.loads(lines[-1])
    assert last["metric"] == metric and last["card"] == "cpu"
    if tool is ab:
        assert [r["ctx"] for r in last["results"]] == list(ab.CPU_SIZES[2])
        assert all(r["route"] == "plain" and r["kv_gb_per_s"] is None for r in last["results"])
        for name, seqs in (("plain_check", ab.CPU_SIZES[0]), ("merge_check", ab.CPU_SIZES[0])):
            check = last[name]
            assert check["seqs"] == seqs and check["within_tol"] and check["rows_equal"]
            assert check["faults_caught"] and check["splits"] is None
        assert last["merge_check"]["ctx"] == last["plain_check"]["ctx"] + 1
    else:
        assert list(last["runs"]) == ["eager"] and last["tokens_equal"] is None
        assert report["tokens"]["eager"].shape == (1 + 2 * 8, 32)


@pytest.mark.parametrize("fault, within", [
    ("none", True), ("scaled", False), ("offset_2e-2", False), ("keys_dropped", False)])
def test_attn_bench_limit_is_on_the_outputs_scale(fault, within):
    """The check's limit, ``PLAIN_TOL`` times the largest |want|, on outputs
    of a long row's scale (a softmax over 32,640 standard-normal keys: about
    N(0, e/N)): one bf16 rounding passes; the output scaled by 1.5, an
    error of the old absolute limit's size, or attention over the first
    three quarters of the keys does not."""
    rng = np.random.default_rng(0)
    n, rows = 32640, 64
    v = torch.from_numpy(rng.standard_normal((n, rows)).astype(np.float32))
    w = torch.from_numpy(np.exp(rng.standard_normal(n)).astype(np.float32))
    want = (w[:, None] * v).sum(0) / w.sum()
    got = {
        "none": want.to(torch.bfloat16),
        "scaled": want * ab.FAULT_SCALE,
        "offset_2e-2": want + TOL,
        "keys_dropped": ((w[: n * 3 // 4, None] * v[: n * 3 // 4]).sum(0)
                         / w[: n * 3 // 4].sum()),
    }[fault]
    result = ab.compare(got, want)
    assert float(want.abs().max()) < 0.05
    assert result["within_tol"] is within
    assert result["tol"] == pytest.approx(ab.PLAIN_TOL * float(want.abs().max()))


def test_probe_times_replays_only_while_open():
    """``timing_replays`` on no graphs yields nothing; on a worker's graphs
    it wraps ``_replay`` while open and restores the class's after."""
    with esp.timing_replays(None) as events:
        assert events == []

    class Graphs:
        def _replay(self, entry):
            raise AssertionError("replayed outside the probe")

    graphs = Graphs()
    with esp.timing_replays(graphs):
        assert "_replay" in vars(graphs)
    assert "_replay" not in vars(graphs)
