"""Attention at head dims past 512, on the CPU.

Past 512 the port's width-512 kernels (A, B, D, E on the tensor cores,
``csrc/paged_attention_w512.cuh``; the f32 queries' ``rpa_kernel`` and
``fused_decode_kernel``, ``csrc/paged_attention.cuh``) cut the head's
columns into ``column_slices``: ceil(head_dim / 512) blocks, each owning 512
of the output's columns, each computing the whole Q·Kᵀ over the head dim in
512-column chunks, so that every slice's online softmax agrees and nothing
crosses slices. The fused kernels' slices store their own columns of the new
K and V rows, and take the new key's K from ``k_new``, encoded and decoded as
the cache holds it. The kernels run only on the card (``chip_smoke.py``
``check_head_dim_variants`` and ``check_wide_head_kernels``); what is
checked here:

- the plain versions (what the kernels are held against on the card)
  against the JAX package's XLA branch (``ops/reference.py``, through its
  ``ragged_paged_attention`` and ``paged_attention_layer`` on the CPU) at head
  dims 513, 576, 640, 767, 1,024, 1,025, 1,536 and 2,048, over a cache of
  the queries' dtype (f32, bf16), an INT8 one and an e4m3 one, groups 1, 4
  and 20, with a window, a soft cap and ALiBi at one shape each; against
  JAX's Pallas kernels in interpret mode at 640 and 1,024;
- a numpy model of the column slices (``torch_parity.column_slice_model``)
  against the plain version, every slice's softmax state the same bit for
  bit; the fused kernels' write by slices (the union is the plain write,
  byte for byte) and the new key's K from ``k_new`` (the cache's bytes);
- the plans: the column slices and the blocks they add, which the KV split
  heuristic counts;
- tiny services through the port's and JAX's ``LlmService``: a Llama with
  heads of 1,024 over an f32 and an INT8 cache and one with ALiBi and heads
  of 513, greedy tokens identical;
- the shape check: every head dim from 513 to 4,096 on every route, dtype
  and cache kind, and ``LlmService.start`` going on to load at 2,048 and
  4,096.

Tolerances (``test_torch_head_dims.py``'s): f32 queries over an f32 or a
1-byte cache 1e-5 (the same arithmetic in another order); bf16 queries 2e-2
(bf16 inputs, one rounding of the output, P in bf16 in the model and in the
Pallas kernels); caches and scales byte for byte.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fused_split as fs
import test_torch_head_dims as hd
import test_torch_launch_device as ld
import torch_parity as tpar
from test_torch_launch_device import launches  # noqa: F401  (a fixture)
from atoma_infer_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from atoma_infer_tpu.ops.attention import paged_attention_layer as jax_attention_layer
from atoma_infer_tpu.ops.attention import ragged_paged_attention as jax_ragged
from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view, scales_flat
from atoma_infer_tpu_torch.ops.kv_write import write_kv_cache_plain, write_kv_cache_quant_plain

torch.set_num_threads(2)

HEAD_DIMS = [513, 576, 640, 767, 1024, 1025, 1536, 2048]
KINDS = ["f32", "bf16", "int8", "fp8"]
GROUPS = (1, 4, 20)
# One score modifier a head dim: a window at 640, a soft cap at 1,024,
# ALiBi at 767.
MODIFIERS = {640: dict(sliding_window=50), 1024: dict(soft_cap=5.0), 767: dict(alibi=True)}
MIXED = [(20, 45), (1, 30), (1, 1), (9, 140)]
DECODE = [(1, kv) for kv in (1, 40, 65, 300)]


def _shapes(fused):
    """(D, kind, group): every head dim over two cache kinds ragged and the
    other two fused, so that each kind meets four head dims on each route;
    the groups 1, 4 and 20 taken in turn."""
    return [pytest.param(D, KINDS[(i + j) % 4], GROUPS[(i + j) % 3],
                         id=f"{D}-{KINDS[(i + j) % 4]}")
            for i, D in enumerate(HEAD_DIMS) for j in ((1, 3) if fused else (0, 2))]


def _mods(D, hq):
    """The score modifiers at ``D`` for the port and for JAX."""
    kw = dict(MODIFIERS.get(D, {}))
    if kw.pop("alibi", None):
        slopes = np.array(jax_alibi_slopes(hq))
        return dict(alibi_slopes=torch.from_numpy(slopes)), dict(alibi_slopes=jnp.asarray(slopes))
    return kw, kw


def _case(kind, D, group, specs, seed):
    return hd._case(kind, D, group, specs, seed, num_kv_heads=1 if group == 20 else 2)


# ------------------------------------------- plain versions against JAX
@pytest.mark.parametrize("D, kind, group", _shapes(fused=False))
def test_ragged_plain_matches_jax_past_512(D, kind, group):
    """A, D and E's plain version on a mixed batch (chunks and decode rows)
    against JAX's XLA branch on the same pages."""
    case = _case(kind, D, group, MIXED, seed=D + group + len(kind))
    n = tpar.valid_rows(case)
    kw, jkw = _mods(D, case["q"].shape[1])
    got = hd._plain_ragged(case, **kw)
    want = np.asarray(jax_ragged(
        jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), tpar.jax_meta(case),
        scale=D ** -0.5, kv_scales=hd._jax_scales(case), **jkw)).astype(np.float32)
    np.testing.assert_allclose(got[:n], want[:n], atol=hd._tol(kind), rtol=hd._tol(kind))


@pytest.mark.parametrize("D, kind, group", _shapes(fused=True))
def test_fused_plain_matches_jax_past_512(D, kind, group):
    """B and the fused D and E's plain version (the write, then attention)
    on a decode batch against JAX's ``paged_attention_layer`` on the CPU: the
    written cache and INT8 scales byte for byte, the output within the
    tolerance (groups past 16 take the write and the ragged kernel on the
    card: the same function)."""
    case = _case(kind, D, group, DECODE, seed=3 * D + group + len(kind))
    n = tpar.valid_rows(case)
    kw, jkw = _mods(D, case["q"].shape[1])
    got, cache, sc = hd._plain_fused(case, **kw)
    meta = dataclasses.replace(tpar.jax_meta(case), decode_only=True)
    want, cache_j, sc_j = jax_attention_layer(
        jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), hd._jax_scales(case),
        jnp.asarray(case["k_new"]), jnp.asarray(case["v_new"]), meta, scale=D ** -0.5, **jkw)
    np.testing.assert_allclose(got[:n], np.asarray(want).astype(np.float32)[:n],
                               atol=hd._tol(kind), rtol=hd._tol(kind))
    np.testing.assert_array_equal(fs._bytes(cache), fs._bytes(cache_j))
    if sc is not None:
        np.testing.assert_array_equal(fs._bytes(sc), fs._bytes(np.asarray(sc_j)[..., :2]))


@pytest.mark.parametrize("D, Hk, group, kind", [(640, 1, 2, "bf16"), (1024, 1, 2, "int8")])
def test_plain_matches_pallas_interpret_past_512(D, Hk, group, kind):
    """At two lane-aligned shapes past 512 the plain versions against JAX's
    Pallas kernels in interpret mode (ragged on a mixed batch, fused on a
    decode batch, caches and scales byte for byte)."""
    hd.test_plain_matches_pallas_interpret(D, Hk, group, kind)


# ------------------------------------------------ the column slices' model
def _rows_and_keys(case, kind, s, h, group):
    """Sequence ``s``'s query rows of kv head ``h`` (all its tokens ×
    group, token-major) and its keys' K, V (f32, a 1-byte cache widened),
    their INT8 scales (or None), and which key each row sees."""
    q = np.asarray(case["q"], np.float32)
    D = q.shape[2]
    cache = tpar.to_torch(case["kv_cache"])
    Hk = cache.shape[2] // (2 * D)
    k_view, v_view = (x.float().numpy() for x in kv_cache_view(cache, Hk, D))
    qsl, lens, bt, bs = (case[x] for x in ("query_start_loc", "seq_lens", "block_tables",
                                           "block_size"))
    keys = np.arange(lens[s])
    slots = bt[s, keys // bs] * bs + keys % bs
    rows = q[qsl[s]:qsl[s + 1], h * group:(h + 1) * group].reshape(-1, D)
    pos = lens[s] - (qsl[s + 1] - qsl[s]) + np.repeat(np.arange(qsl[s + 1] - qsl[s]), group)
    scales = None
    if "kv_scales" in case:
        k_sc, v_sc = (x.float().numpy() for x in scales_flat(tpar.to_torch(case["kv_scales"])))
        scales = (k_sc[slots], v_sc[slots])
    return rows, k_view[slots, h], v_view[slots, h], scales, keys[None, :] <= pos[:, None]


@pytest.mark.parametrize("D, kind, group", [(1024, "bf16", 4), (1025, "int8", 2),
                                            (1536, "fp8", 12), (767, "bf16", 1)])
def test_column_slice_model_matches_plain(D, kind, group):
    """The column slices' arithmetic (``column_slice_model``: every slice's
    scores over the whole head in 512-column chunks, 32-key tiles, P in
    bf16 after the V scale, its own V columns) on a mixed batch against the
    plain version within TOL; every slice ends with the same (m, l), bit for
    bit, so the slices' columns need no merge."""
    case = _case(kind, D, group, MIXED, seed=D + group)
    want = hd._plain_ragged(case)
    q = np.asarray(case["q"])
    Hk = q.shape[1] // group
    qsl = case["query_start_loc"]
    for s in range(case["num_seqs"]):
        for h in range(Hk):
            rows, k, v, scales, visible = _rows_and_keys(case, kind, s, h, group)
            k_sc, v_sc = scales or (None, None)
            got, states = tpar.column_slice_model(rows, k, v, visible, scale=D ** -0.5,
                                                  k_scale=k_sc, v_scale=v_sc)
            assert len(states) == pa.column_slices(D)
            for m, l in states[1:]:
                np.testing.assert_array_equal(m, states[0][0])
                np.testing.assert_array_equal(l, states[0][1])
            ref = want[qsl[s]:qsl[s + 1], h * group:(h + 1) * group].reshape(-1, D)
            np.testing.assert_allclose(tpar.bf16_round(got), ref, atol=hd.TOL, rtol=hd.TOL)


@pytest.mark.parametrize("D, kind", [(1025, "bf16"), (1024, "int8"), (1536, "fp8"),
                                     (767, "f32")])
def test_fused_slices_write_their_columns_and_read_k_new(D, kind):
    """The fused kernels past 512: each column slice stores its own columns
    of the new K and V rows (INT8 with the token's scales from the whole
    row's absmax, one block storing them): the slices' stores together are
    the plain write, byte for byte; and the new key's K taken from
    ``k_new``, encoded and decoded as the cache holds it, equals the stored
    row read back, which a slice could not see before every other slice has
    stored its columns."""
    case = _case(kind, D, 4, DECODE, seed=D)
    meta = tpar.torch_meta(case)
    cache = tpar.to_torch(case["kv_cache"])
    scales = tpar.to_torch(case["kv_scales"]).clone() if kind == "int8" else None
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    k_new, v_new = (tpar.to_torch(case[x]).to(dtype) for x in ("k_new", "v_new"))
    want = cache.clone()
    if scales is not None:
        write_kv_cache_quant_plain(want, scales, k_new, v_new, meta.slot_mapping)
    else:
        write_kv_cache_plain(want, k_new, v_new, meta.slot_mapping)
    T, Hk, _ = k_new.shape
    W = pa.W512
    got = cache.clone().view(cache.shape[0] * cache.shape[1], Hk, 2, D)
    rows = want.view(got.shape)
    for t in range(tpar.valid_rows(case)):
        slot = int(meta.slot_mapping[t])
        for h in range(Hk):
            for cs in range(pa.column_slices(D)):  # a block each, its columns only
                cols = slice(cs * W, min(D, cs * W + W))
                got[slot, h, :, cols] = rows[slot, h, :, cols]
            # The new key's K from k_new, encoded and decoded.
            if kind == "int8":
                k_sc = scales.view(-1, 2)[slot, 0].float()
                enc = torch.clamp(torch.round(k_new[t, h].float() * (1 / k_sc)), -127, 127)
                np.testing.assert_array_equal(enc.to(torch.int8).numpy(),
                                              rows[slot, h, 0].numpy())
            else:
                enc = k_new[t, h].to(cache.dtype)
                np.testing.assert_array_equal(fs._bytes(enc), fs._bytes(rows[slot, h, 0]))
    np.testing.assert_array_equal(fs._bytes(got.view(cache.shape)), fs._bytes(want))


# ------------------------------------------------------------- the plans
@pytest.mark.parametrize("head_dim", [513, 767, 1024, 1025, 1536, 2048, 2049, 4096])
def test_column_slices_and_routes(head_dim):
    """Past 512 a head dim runs at the width 512 in ceil(head_dim / 512)
    column slices, on every route's ``*_w512`` kernel; up to 512, one."""
    assert pa.instance_dim(head_dim) == pa.W512
    assert pa.column_slices(head_dim) == -(-head_dim // 512) >= 2
    assert pa.column_slices(head_dim - 512 * (pa.column_slices(head_dim) - 1)) == 1
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q = torch.empty((8, 4, head_dim), dtype=dtype)
        for kind in (None, torch.int8, torch.float8_e4m3fn):
            for route in (pa.ragged_route(q, kind), pa.fused_route(q, kind)):
                assert route.name.endswith(("_w512", "_w512_f16")) and "_w512" in route.source
    assert [pa.column_slices(d) for d in (1, 257, 512)] == [1, 1, 1]


def test_plans_count_the_column_slices(monkeypatch):
    """The ragged and fused plans count a block a (tile, kv head, group
    slice, column slice): past 512 the grid is (T / tokens + S, Hk · slices,
    splits · columns), and the column slices' blocks fill the card as the
    KV splits would, so the heuristic takes fewer splits (8 decode rows of
    up to 2,048 keys over one kv head on a card that holds 132 blocks: the
    ragged plan's 8 query tiles take 16, 8, 4 and 2 splits at 512, 1,024,
    2,048 and 4,096, 128 blocks each time; the fused plan's 8 rows, at
    most 4 splits of 512 keys, 2 at 4,096); the plans get the call's column
    slices from its head dim."""
    dims = (512, 1024, 2048, 4096)
    kw = dict(num_seq_slots=8, num_tokens=8, max_q_len=1, max_keys=2048, group=4,
              num_kv_heads=1, slots=132, split_cols=True)
    columns = [pa.column_slices(D) for D in dims]
    assert columns == [1, 2, 4, 8]
    plans = [pa.rpa_mma_plan(**kw, columns=c) for c in columns]
    assert all((p.warps, p.tokens, p.slices) == (4, 4, 1) for p in plans)
    assert [p.splits for p in plans] == [16, 8, 4, 2]
    tiles = max(-(-8 // 4), min(8, 8))  # the query tiles holding a token
    assert all(tiles * 1 * p.slices * c * p.splits == 128 for p, c in zip(plans, columns))
    fused = [pa.fused_split_plan(num_seq_slots=8, max_keys=2048, num_kv_heads=1, slots=132,
                                 columns=pa.column_slices(D)) for D in dims]
    assert fused == [4, 4, 4, 2]
    monkeypatch.setattr(pa, "_rpa_slots", lambda kind, d, w, dev: 132)
    monkeypatch.setattr(pa, "_fused_slots", lambda kind, d, g, dev: 132)
    meta = tpar.torch_meta(dict(
        slot_mapping=np.zeros(8), block_tables=np.zeros((8, 128)), seq_lens=np.full(8, 2000),
        query_start_loc=np.arange(9), num_seqs=8, block_size=16, decode_only=True,
        max_q_len=1))
    for D in (513, 1024, 2048):
        q = torch.empty((8, 4, D), dtype=torch.bfloat16)
        assert pa.rpa_plan_for(q, meta, 1, None) == pa.rpa_mma_plan(
            num_seq_slots=8, num_tokens=8, max_q_len=1, max_keys=2048, group=4,
            num_kv_heads=1, slots=132, padded=True, split_cols=True,
            columns=pa.column_slices(D))
        assert pa.fused_splits_for(q, meta, 1, None) == pa.fused_split_plan(
            num_seq_slots=8, max_keys=2048, num_kv_heads=1, slots=132,
            columns=pa.column_slices(D))


def test_split_workspace_reserve_covers_the_kernels_past_512():
    """The graphs' split workspace reserve at a head dim of 1,024 (4 q heads
    over one kv head): the most splits any plan takes, the workspace strided
    by the head dim, fits it."""
    import math

    from atoma_infer_tpu_torch.engine.llm_service import split_workspace_bytes
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(head_dim=1024, num_attention_heads=4, num_key_value_heads=1,
                      hidden_size=4096)
    T, P, bs = 256, 128, 16
    most = max(
        pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=q, max_keys=P * bs, group=4,
                        num_kv_heads=1, slots=s, split_cols=True, columns=2).splits
        for S in (1, 8, 64) for q in (1, 256) for s in (132, 264, 1 << 12))
    o, ml = pa.split_workspace_shapes(most, T, 4, 1024)
    assert 4 * (math.prod(o) + math.prod(ml)) <= split_workspace_bytes(T, cfg, P, bs)


# ------------------------------------------------- the launches' column slices
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("decode", [False, True], ids=["ragged", "fused"])
def test_wrappers_count_the_column_slices_they_launch(launches, monkeypatch, dtype, decode):
    """Each attention wrapper counts its launch's column slices (the grid's
    ceil(head_dim / 512)) beside the launch, on the kernel it launches: the
    smoke holds the services past 512 to these counts. The kernels cannot
    run here: the tensors report a CUDA device and the C entry points are
    stubs (``test_torch_launch_device``)."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    for kernel in cuda_lib.KERNELS.values():
        monkeypatch.setattr(kernel, "columns", kernel.columns)  # restored after the test
    rng = np.random.default_rng(0)
    S, P, bs, Hq, Hk = 2, 2, 16, 4, 1
    T = S if decode else 6
    for D in (512, 1024, 1025, 2048):
        def t(*shape, dt=dtype):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)

        meta = dict(slot_mapping=torch.arange(T, dtype=torch.int32),
                    block_tables=torch.arange(S * P, dtype=torch.int32).reshape(S, P),
                    seq_lens=torch.tensor([1, 1] if decode else [3, 3], dtype=torch.int32),
                    query_start_loc=torch.tensor([0, 1, 2] if decode else [0, 3, 6],
                                                 dtype=torch.int32),
                    num_seqs=torch.tensor([S], dtype=torch.int32))
        x = ld._place(dict(q=t(T, Hq, D), k=t(T, Hk, D), v=t(T, Hk, D),
                           cache=torch.zeros((S * P, bs, 2 * Hk * D), dtype=dtype),
                           scales=None, meta=meta, decode_only=decode,
                           max_q_len=1 if decode else 3), 0)
        route = (pa.fused_route if decode else pa.ragged_route)(x["q"], None)
        before, cols = route.launches, route.columns
        (ld._fused if decode else ld._ragged)(x)
        assert (route.launches - before, route.columns - cols) == (1, pa.column_slices(D))
        assert launches[-1][0] == route.name


def test_graph_replays_count_the_captured_column_slices(monkeypatch):
    """A capture records each kernel's column slices with its calls, and
    every replay adds both."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    kernel = cuda_lib.CudaKernel("stub_w512", "none.cu", "none", [], replaces="test")
    monkeypatch.setitem(cuda_lib.KERNELS, kernel.name, kernel)
    monkeypatch.setattr(cuda_lib, "call_on_device", lambda device, fn, *args: 0)
    kernel._fn = lambda *args: 0
    kernel(device=torch.device("cuda", 0), columns=2)
    with cuda_lib.recording_launches() as tally:
        kernel(device=torch.device("cuda", 0), columns=4)
        kernel(device=torch.device("cuda", 0))
    assert (kernel.launches, kernel.columns) == (1, 2)
    assert tally == {"stub_w512": 2} and tally.columns == {"stub_w512": 5}
    cuda_lib.count_replay(tally)
    cuda_lib.count_replay(tally)
    assert (kernel.launches, kernel.columns) == (5, 12)


# ------------------------------------------------------------- the services
def _port_tokens(tmp_path, widths, kv_cache_dtype):
    """The port's greedy tokens on ``test_torch_fused_group.PROMPTS`` with
    JAX's f32 parameters at ``widths``, over a cache of ``kv_cache_dtype``
    (None: f32)."""
    import test_torch_fused_group as fg
    from atoma_infer_tpu_torch.engine.llm_service import LlmService, ModelFactory
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    path = tpar.save_params(tmp_path / "llama.npz", fg._jax_params(widths))
    factory = ModelFactory(config=LlamaConfig(**widths), build=tpar.npz_model,
                           args=(path, "llama", widths, torch.float32))
    service = LlmService.start(tpar.tp_engine_config(1, kv_cache_dtype=kv_cache_dtype),
                               model_factory=factory, device="cpu")
    assert service.engine.worker.model.config.head_dim == widths["head_dim"]
    return tpar.generate(service, fg.PROMPTS)


@pytest.mark.parametrize("head_dim, hq, hk, alibi, kv", [
    (1024, 4, 1, False, None), (1024, 2, 1, False, "int8"), (513, 4, 2, True, None)],
    ids=["1024-f32", "1024-int8", "513-alibi"])
def test_service_past_512_matches_jax(head_dim, hq, hk, alibi, kv, tmp_path):
    """Tiny Llamas with heads of 1,024 (over an f32 and an INT8 cache) and
    with ALiBi and heads of 513, through the port's and JAX's
    ``LlmService`` on the same f32 weights: greedy tokens identical."""
    import test_torch_fused_group as fg

    widths = hd._widths(head_dim, hq, hk, alibi=alibi)
    assert _port_tokens(tmp_path, widths, kv) == fg._jax_tokens(widths, False,
                                                                kv_cache_dtype=kv)


# ------------------------------------------------------- the shape checks
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("kind", [None, torch.int8, torch.float8_e4m3fn],
                         ids=["same", "int8", "fp8"])
def test_shape_check_admits_every_head_dim_to_4096(dtype, kind):
    """Every head dim from 513 to 4,096, ragged and fused, for bf16, fp16
    and f32 queries over each cache kind: no cap past 512."""
    for head_dim in range(513, 4097):
        for fused in (False, True):
            pa.check_kernel_shape(head_dim=head_dim, dtype=dtype, kind=kind, group=4,
                                  block_size=16, fused=fused)


@pytest.mark.parametrize("head_dim", [2048, 4096])
def test_cuda_service_goes_on_to_load_past_512(head_dim, tmp_path, monkeypatch):
    """``LlmService.start`` on the card, from a directory holding only a
    ``config.json``: at head dims of 2,048 and 4,096 (32 heads) the check
    passes and the start goes on to build the model."""
    hd.test_cuda_service_checks_the_head_dim_before_loading(
        32 * head_dim, 32, False, tmp_path, monkeypatch)
