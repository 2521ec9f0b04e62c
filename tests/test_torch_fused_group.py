"""Fused decode at 9 to 16 query heads per kv head (kernels B, D and E's
fused variants), on the CPU: Mistral-Large-Instruct-2407 has 12 (96 q heads
over 8 kv heads), Llama-3.1-405B 16 (128 over 8, still 16 on a rank at tp
8).

The split kernel (``fused_split_kernel`` in the port's
``csrc/fused_decode_split.cuh``) puts such a group in both halves of Q·Kᵀ's
m16 tile: heads 0-7 in rows 0-7, heads 8..G-1 in rows 8-15, each lane
holding two score rows with an online-softmax state each. It runs only on
the card. What is checked here:
- a plain model of the kernel's blocks at those groups: each warp's rounds
  of 32 keys, each half's (m, l, O) rescaled on its own, P rounded to bf16
  after the INT8 V scale, the warps' merge and the splits' merge
  (``split_combine_plain``), against the unsplit plain version
  (``fused_decode_attention_plain``) and JAX's fused kernels in interpret
  mode (``ragged_paged_attention_fused`` and
  ``ragged_paged_attention_fused_quant``, which take the group as a lane
  slice), bf16 queries over bf16, INT8 + scales and e4m3 caches, head dims
  32 to 256; tolerance 2e-2 (``ATTN_TOL["bfloat16"]`` of
  ``chip_smoke.py``: bf16 inputs, one rounding of the output to bf16, P in
  bf16), written caches and scales byte for byte JAX's;
- the plain version against JAX's fused kernels at every group from 9 to
  16 (drawn by hypothesis), with a window, a soft cap or ALiBi;
- a tiny Llama with 16, 12, 17 and 32 q heads over one kv head served
  through the port's and JAX's ``LlmService``, sync and async (17 and 32
  also over a bf16, an INT8 and an e4m3 cache; past 16 a pure-decode step
  takes the write and the ragged kernel on the card), and 34 q heads over
  2 kv heads at tp 2 (a rank's group of 17): greedy tokens identical;
- ``check_kernel_shapes`` (what ``LlmService.start`` runs on the card
  before loading) takes both published configs at tp 1 and tp 8 over every
  cache kind, and groups of 17 to 129 at tp 1 and 2.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_torch_fused_split as fs
import torch_parity as tpar
from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view, scales_flat
from atoma_infer_tpu_torch.ops.kv_write import write_kv_cache_plain, write_kv_cache_quant_plain

torch.set_num_threads(2)

TOL = fs.TOL
WARPS = 4        # kFsWarps: a block's warps, 32 keys each a round
ROUND = 32
HALF = 8         # rows of one half of the m16 tile
SPECS = fs.SPECS[:4] + [(1, 200)]


# ------------------------------------------------------ the kernel, in a model
def block_rows(Q, K, V, ks, vs, keys, pos, *, group, scale, soft_cap, slopes):
    """One block's (m, l, O) for the rows of its tile: ``Q`` [16, D] holds
    the group's heads (rows past the group zero), ``K``/``V`` [keys, D] the
    block's key range, ``ks``/``vs`` its INT8 scales (ones otherwise). Each
    warp takes rounds of 32 keys (warp w the keys 32 w + 128 i ...) and
    keeps an online-softmax state for each half of the tile it fills (one
    half up to 8 heads, two beyond), rescaling that half's O alone; then the
    warps' states merge. Returns (m [16], l [16], O [16, D]) before
    normalisation."""
    G16, D = Q.shape
    halves = 2 if group > HALF else 1
    n = K.shape[0]
    ms, ls, os_ = [], [], []
    for w in range(WARPS):
        m = torch.full((G16,), float("-inf"))
        l = torch.zeros(G16)
        O = torch.zeros(G16, D)
        for base in range(ROUND * w, n, ROUND * WARPS):
            idx = torch.arange(base, min(base + ROUND, n))
            s = (Q @ K[idx].T) * ks[idx] * scale
            if soft_cap:
                s = soft_cap * torch.tanh(s / soft_cap)
            s = s + slopes[:, None] * torch.from_numpy(
                (keys[idx.numpy()] - pos).astype(np.float32))
            for r in range(halves):
                rows = slice(HALF * r, HALF * (r + 1))
                m_new = torch.maximum(m[rows], s[rows].amax(1))
                alpha = torch.exp(m[rows] - m_new)
                p = torch.exp(s[rows] - m_new[:, None])
                l[rows] = l[rows] * alpha + p.sum(1)
                pb = (p * vs[idx]).to(torch.bfloat16).float()
                O[rows] = O[rows] * alpha[:, None] + pb @ V[idx]
                m[rows] = m_new
        ms.append(m)
        ls.append(l)
        os_.append(O)
    m, l, O = torch.stack(ms), torch.stack(ls), torch.stack(os_)
    mx = m.amax(0)
    c = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - mx))
    return mx, (l * c).sum(0), (O * c[..., None]).sum(0)


def model_fused_halves(case, kind, splits, *, window=None, soft_cap=None, alibi=None):
    """The split kernel on the case, block by block (:func:`block_rows`):
    the write by each row's last split, each split's unnormalized (m, l, O)
    for the tile rows that hold heads, the merge of split rows. Returns
    (out [T, Hq, D] rounded to bf16, the written cache, the written scales
    or None)."""
    meta = tpar.torch_meta(case)
    cache = tpar.to_torch(case["kv_cache"]).clone()
    scales = None if kind != "int8" else tpar.to_torch(case["kv_scales"]).clone()
    k_new, v_new = (tpar.to_torch(case[x]).to(torch.bfloat16) for x in ("k_new", "v_new"))
    if scales is not None:
        write_kv_cache_quant_plain(cache, scales, k_new, v_new, meta.slot_mapping)
    else:
        write_kv_cache_plain(cache, k_new, v_new, meta.slot_mapping)
    q = tpar.to_torch(case["q"]).float()
    T, Hq, D = q.shape
    Hk = cache.shape[2] // (2 * D)
    G = Hq // Hk
    assert HALF < G <= 2 * HALF
    K_all, V_all = (x.float() for x in kv_cache_view(cache, Hk, D))
    ones = torch.ones(K_all.shape[0])
    ks_all, vs_all = ((x.float() for x in scales_flat(scales)) if scales is not None
                      else (ones, ones))
    ws_o = torch.zeros((splits, T, Hq, D))
    ws_ml = torch.zeros((splits, T, Hq, 2))
    out = torch.zeros((T, Hq, D))
    lens, qsl, bt, bs = (case[k] for k in ("seq_lens", "query_start_loc", "block_tables",
                                           "block_size"))
    slopes = torch.zeros(Hq) if alibi is None else alibi.float()
    for s in range(case["num_seqs"]):
        t, pos = qsl[s], lens[s] - 1
        ranges = pa.split_key_ranges(pos, window, splits, fs.MIN_TILES)
        for i, (a, b) in enumerate(ranges):
            keys = np.arange(a, b)
            slots = torch.from_numpy(bt[s, keys // bs] * bs + keys % bs).long()
            for h in range(Hk):
                heads = slice(h * G, (h + 1) * G)
                Q = torch.zeros(2 * HALF, D)
                Q[:G] = q[t, heads]
                sl = torch.zeros(2 * HALF)
                sl[:G] = slopes[heads]
                m, l, O = block_rows(Q, K_all[slots, h], V_all[slots, h], ks_all[slots],
                                     vs_all[slots], keys, pos, group=G, scale=D ** -0.5,
                                     soft_cap=soft_cap, slopes=sl)
                # Rows past the group hold no head: never stored.
                if len(ranges) == 1:
                    out[t, heads] = O[:G] / l[:G, None]
                else:
                    ws_o[i, t, heads] = O[:G]
                    ws_ml[i, t, heads] = torch.stack([m[:G], l[:G]], 1)
    pa.split_combine_plain(ws_o, ws_ml, out, meta, bq=1, splits=splits,
                           min_tiles=fs.MIN_TILES, window=window)
    return fs.bf16(out.numpy()), cache, scales


def _case(kind, group, D, seed, block_size=64, boost=True):
    case = fs._case(kind, group=group, D=D, block_size=block_size, seed=seed, specs=SPECS)
    if boost:
        # Heads 8.. get larger scores than heads 0-7, so that a shared
        # softmax state across the tile's halves would show.
        Hk = case["kv_cache"].shape[2] // (2 * D)
        q = case["q"].astype(np.float32).reshape(-1, Hk, group, D)
        q[:, :, HALF:] *= 3.0
        case["q"] = q.reshape(case["q"].shape).astype(case["q"].dtype)
    return case


def _check_against(got, cache, sc, want, want_cache, want_sc, n):
    np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(fs._bytes(cache), fs._bytes(want_cache))
    if sc is not None:
        np.testing.assert_array_equal(fs._bytes(sc), fs._bytes(want_sc))


MODEL_SHAPES = [(32, 9), (64, 12), (128, 16), (128, 10), (96, 12), (256, 16)]


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("D, group", MODEL_SHAPES)
def test_halves_model_matches_plain(kind, D, group):
    """The two-half model, unsplit and in up to 3 and 16 splits a row,
    within TOL of the unsplit plain version; the written cache and scales
    byte for byte its."""
    case = _case(kind, group, D, seed=D + group, block_size=16)
    n = tpar.valid_rows(case)
    want, want_cache, want_sc = fs._plain(case, kind)
    for splits in (1, 3, 16):
        got, cache, sc = model_fused_halves(case, kind, splits)
        _check_against(got, cache, sc, want, want_cache, want_sc, n)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("D, group", [(64, 12), (128, 16), (96, 9)])
@pytest.mark.parametrize("mod", ["none", "window", "soft_cap", "alibi"])
def test_halves_model_matches_jax_fused(kind, D, group, mod):
    """One score modifier at a time, 4 splits at most: the model against
    JAX's fused kernels in interpret mode (blocks of 64); the written cache
    and scales equal JAX's byte for byte."""
    case = _case(kind, group, D, seed=3 * D + group + len(mod))
    Hk = case["kv_cache"].shape[2] // (2 * D)
    kw = fs._mods(mod, Hk * group)
    n = tpar.valid_rows(case)
    got, cache, sc = model_fused_halves(case, kind, 4, window=kw.get("sliding_window"),
                                        soft_cap=kw.get("soft_cap"),
                                        alibi=kw.get("alibi_slopes"))
    want, want_cache, want_sc = fs._jax(case, kind, **kw)
    _check_against(got, cache, sc, want, want_cache, want_sc, n)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@settings(max_examples=5, deadline=None, derandomize=True)
@given(group=st.integers(HALF + 1, 2 * HALF), D=st.sampled_from([32, 64, 128, 256]),
       mod=st.sampled_from(["none", "window", "soft_cap", "alibi"]))
def test_plain_matches_jax_fused_at_groups_9_to_16(kind, group, D, mod):
    """The plain version (what the kernel is held against on the card)
    against JAX's fused kernels in interpret mode at a drawn group of 9 to
    16: within TOL, the written cache and scales byte for byte."""
    case = _case(kind, group, D, seed=group * D, boost=False)
    Hk = case["kv_cache"].shape[2] // (2 * D)
    kw = fs._mods(mod, Hk * group)
    n = tpar.valid_rows(case)
    got, cache, sc = fs._plain(case, kind, **kw)
    want, want_cache, want_sc = fs._jax(case, kind, **kw)
    _check_against(got, cache, sc, want, want_cache, want_sc, n)


def test_route_and_plan_at_groups_9_to_16(monkeypatch):
    """bf16 and fp16 queries at 9 to 16 q heads per kv head take the split
    kernels; f32 queries the unsplit one. The plan asks the card's occupancy
    for the group itself (the kernel's two-half instantiation answers it)."""
    asked = []

    def slots(kind, d, g, dev):
        asked.append(g)
        return 132 * 2

    monkeypatch.setattr(pa, "_fused_slots", slots)
    for group in range(HALF + 1, 2 * HALF + 1):
        for kind in (None, torch.int8, torch.float8_e4m3fn):
            q = torch.empty((8, 2 * group, 128), dtype=torch.bfloat16)
            assert pa.fused_route(q, kind) is pa.FUSED_DECODE_SPLIT[kind]
            assert pa.fused_route(q.half(), kind) is pa.FUSED_DECODE_SPLIT_F16[kind]
            assert pa.fused_route(q.float(), kind) is pa.FUSED_DECODE[kind]
        meta = tpar.torch_meta(dict(
            slot_mapping=np.zeros(8), block_tables=np.zeros((8, 128)),
            seq_lens=np.full(8, 2000), query_start_loc=np.arange(9), num_seqs=8,
            block_size=16, decode_only=True, max_q_len=1))
        splits = pa.fused_splits_for(q, meta, 2, None)
        assert splits == pa.fused_split_plan(num_seq_slots=8, max_keys=2048, num_kv_heads=2,
                                             slots=132 * 2)
        assert asked[-1] == group


# ------------------------------------------------------------- the services
def _widths(hq, hk=1):
    return dict(
        vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=hq, num_key_value_heads=hk, head_dim=16,
        max_position_embeddings=2048, rope_theta=10000.0, rope_scaling=None,
        tie_word_embeddings=True, eos_token_ids=(1,), bos_token_id=0,
    )


PROMPTS = [
    "a group of sixteen query heads over one kv head",
    "a second, rather longer prompt that spans multiple KV blocks " * 3,
    "short",
]


def _jax_params(widths):
    """The JAX Llama's f32 parameters at ``widths``, from a fixed key."""
    from atoma_infer_tpu.models.llama import Llama, LlamaConfig

    return Llama(LlamaConfig(**widths), dtype=jnp.float32).init_params(jax.random.PRNGKey(0))


def _jax_tokens(widths, async_scheduling, *, dtype="float32", kv_cache_dtype=None, tp=1):
    """JAX's greedy tokens on ``PROMPTS`` by request: the model
    in ``dtype`` (its f32 parameters rounded to it), over a cache of
    ``kv_cache_dtype`` (None: the model's dtype), at ``tp`` (a mesh of the
    conftest's virtual CPU devices)."""
    from atoma_infer_tpu.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu.engine.llm_service import LlmService
    from atoma_infer_tpu.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu.models.llama import Llama, LlamaConfig
    from atoma_infer_tpu.types import GenerateParameters, GenerateRequest

    params = _jax_params(widths)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    model = Llama(LlamaConfig(**widths), dtype=jdtype)
    served = jax.tree_util.tree_map(lambda a: a.astype(jdtype), params)
    config = EngineConfig(
        model=ModelConfig(model_name="tiny-random", dtype=dtype, kv_cache_dtype=kv_cache_dtype,
                          tensor_parallel_size=tp),
        cache=CacheConfig(block_size=16, num_device_blocks_override=128,
                          num_host_blocks_override=32),
        scheduler=SchedulerConfig(max_num_batched_tokens=512, max_num_sequences=16,
                                  max_model_len=512, enable_chunked_prefill=False,
                                  use_native_core=False, async_scheduling=async_scheduling),
        validation=ValidationConfig(max_input_tokens=256, max_total_tokens=512),
    )
    service = LlmService.start(config, model=model, params=served,
                               tokenizer=ByteTokenizer(widths["vocab_size"]))

    async def run():
        task = asyncio.create_task(service.engine.run())
        futs = [await service.handle_request(GenerateRequest(
            request_id=f"req-{i}", inputs=p,
            parameters=GenerateParameters(max_new_tokens=12, do_sample=False)))
            for i, p in enumerate(PROMPTS)]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=180)
        service.stop()
        task.cancel()
        return {r.request_id: list(r.outputs[0].token_ids) for r in results}

    return asyncio.run(run())


@pytest.mark.parametrize("hq", [16, 12, 17, 32])
@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_service_at_large_groups_matches_jax(hq, async_scheduling, tmp_path):
    """A 2-layer Llama with ``hq`` q heads over one kv head (the group of
    Llama-3.1-405B's rank at tp 8, and of Mistral-Large-2's; past 16 a
    group the fused kernel lacks, whose decode steps take the write and the
    ragged kernel on the card) through the port's ``LlmService`` and JAX's
    on the same weights: greedy tokens identical."""
    assert _port_tokens(tmp_path, hq, async_scheduling) == _jax_tokens(
        _widths(hq), async_scheduling)


def _port_tokens(tmp_path, hq, async_scheduling, *, dtype="float32", kv_cache_dtype=None,
                 tp=1, hk=1, step_graphs=None):
    """The port's greedy tokens on ``PROMPTS`` with JAX's f32 parameters
    (rounded to ``dtype``), served as :func:`_jax_tokens` serves them; every
    rank's workers keeping ``step_graphs`` (None: eager on the CPU)."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService, ModelFactory
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    widths = _widths(hq, hk)
    path = tpar.save_params(tmp_path / "llama.npz", _jax_params(widths))
    factory = ModelFactory(config=LlamaConfig(**widths), build=tpar.npz_model,
                           args=(path, "llama", widths, getattr(torch, dtype)),
                           step_graphs=step_graphs)
    config = tpar.tp_engine_config(
        tp, kv_cache_dtype=kv_cache_dtype, async_scheduling=async_scheduling,
        coordinator_address=tpar.rendezvous_file(tmp_path) if tp > 1 else None)
    config.model.dtype = dtype
    service = LlmService.start(config, model_factory=factory, device="cpu")
    if tp == 1:
        assert service.engine.worker.model.local_q_heads == hq
    return tpar.generate(service, PROMPTS)


@pytest.mark.parametrize("hq", [17, 32])
@pytest.mark.parametrize("dtype, kv", [("bfloat16", None), ("float32", "int8"),
                                       ("float32", "fp8")], ids=["bf16", "int8", "fp8"])
@pytest.mark.parametrize("async_scheduling", [False, True], ids=["sync", "async"])
def test_service_past_16_over_each_cache_matches_jax(hq, dtype, kv, async_scheduling, tmp_path):
    """Groups of 17 and 32 q heads over one kv head, whose pure-decode steps
    take the write and the ragged kernel on the card, over a bf16 cache (a
    bf16 model) and INT8 and e4m3 caches: the port's greedy tokens are
    JAX's, sync and async."""
    want = _jax_tokens(_widths(hq), async_scheduling, dtype=dtype, kv_cache_dtype=kv)
    assert _port_tokens(tmp_path, hq, async_scheduling, dtype=dtype,
                        kv_cache_dtype=kv) == want


@pytest.mark.parametrize("step_graphs", [None, tpar.StubStepGraphs], ids=["eager", "stub-graphs"])
def test_service_at_a_rank_group_of_17_matches_jax_at_tp2(step_graphs, tmp_path):
    """34 q heads over 2 kv heads at tp 2, each rank's group 17 (one kv
    head, 17 q heads: the write and the ragged kernel on the card), two
    ranks on gloo, eager and through stub graphs captured in segments
    between the collectives, against JAX's service at tp 2: greedy tokens
    identical."""
    want = _jax_tokens(_widths(34, 2), False, tp=2)
    assert _port_tokens(tmp_path, 34, False, tp=2, hk=2, step_graphs=step_graphs) == want


# --------------------------------------------------- the service's shape check
# Published configs (config.json): (head dim, q heads, kv heads).
PUBLISHED = {
    "Mistral-Large-Instruct-2407": (128, 96, 8),
    "Llama-3.1-405B": (128, 128, 8),
}


def _engine_config(dtype, kv, tp):
    from atoma_infer_tpu_torch.config import EngineConfig

    return EngineConfig.from_dict({
        "inference": {"model_name": "served", "dtype": dtype, "kv_cache_dtype": kv,
                      "tensor_parallel_size": tp},
        "cache": {"block_size": 16},
        "scheduler": {"max_model_len": 2048},
    })


@pytest.mark.parametrize("name", sorted(PUBLISHED))
@pytest.mark.parametrize("tp", [1, 8])
@pytest.mark.parametrize("dtype, kv", [("bfloat16", None), ("float16", None),
                                       ("float32", None), ("bfloat16", "int8"),
                                       ("bfloat16", "fp8")])
def test_service_shape_check_takes_published_groups(name, tp, dtype, kv):
    """``check_kernel_shapes`` takes Mistral-Large-2 (12 q heads per kv
    head) and Llama-3.1-405B (16) at tp 1 and tp 8 (a rank's group is
    unchanged), over every cache kind."""
    from atoma_infer_tpu_torch.engine.llm_service import check_kernel_shapes
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    D, hq, hk = PUBLISHED[name]
    cfg = LlamaConfig(head_dim=D, num_attention_heads=hq, num_key_value_heads=hk)
    check_kernel_shapes(cfg, _engine_config(dtype, kv, tp))


@pytest.mark.parametrize("group", [17, 32, 128, 129])
@pytest.mark.parametrize("tp", [1, 2])
def test_service_shape_check_refuses_17_naming_the_item(tp, group):
    """A rank's group past 16 over 8 kv heads, at tp 1 and tp 2 (the
    rank's group unchanged): the check passes and a pure-decode step takes
    the write and the ragged kernel (``decode_route``), 129 too (the
    tensor-core ragged kernel cuts a token's group past 128 into slices)."""
    from atoma_infer_tpu_torch.engine.llm_service import check_kernel_shapes
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(head_dim=128, num_attention_heads=8 * group, num_key_value_heads=8)
    assert pa.decode_route(8 * group // tp, 8 // tp) == "ragged"
    check_kernel_shapes(cfg, _engine_config("bfloat16", None, tp))
