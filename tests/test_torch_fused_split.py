"""The split fused decode kernel (kernels B, D and E's fused variants for
bf16 queries: ``fused_split_kernel`` in the port's
``csrc/fused_decode_split.cuh``), modelled on the CPU.

The CUDA kernel runs only on the card. What can be checked here:
- the split plan: ``split_key_ranges`` (the kernel's ``rpa_tile_keys`` and
  ``rpa_split_count``) covers every key of every decode row exactly once,
  in whole 64-key tiles, with ``pos`` (the new key, the one the kernel
  writes) only in the last split, so the write happens once; a short row
  stays whole; and ``fused_split_plan`` / ``fused_splits_for`` take shapes
  only (the same answer whatever the sequence lengths);
- the kernel's arithmetic, in a plain model of its blocks: the write (once,
  by the last split), each split's unnormalized (m, l, O) over its key
  range with the INT8 key scale on the score and the V scale on p (p then
  rounded to bf16, as P·V's ``mma`` takes it), and the
  merge of split rows by ``split_combine_plain`` (``rpa_combine_kernel``'s
  log-sum-exp in split order). It is held against the unsplit plain version
  (``fused_decode_attention_plain``) and against the JAX package's fused
  kernels in interpret mode (``ragged_paged_attention_fused`` and
  ``ragged_paged_attention_fused_quant``) on the same seeded numpy inputs:
  bf16 queries over bf16, INT8 + scales and e4m3 caches, D = 32, 64, 128,
  groups 1, 3, 4, 8, blocks of 16 and 64, and over bf16 caches at D = 96
  and 256 (Phi-3-mini, Gemma-2), with a sliding window, a soft cap and
  ALiBi. Tolerance 2e-2 (``ATTN_TOL["bfloat16"]`` of ``chip_smoke.py``:
  bf16 inputs, one rounding of the output to bf16, the Pallas kernel's P in
  bf16). The written cache and scales equal JAX's byte for byte;
- the kernel's geometry at every head dim it is built for: the ring's
  copies take each 16-byte piece of a round's K rows once (12 pieces a row
  at D = 96), Q·Kᵀ's reads stay in their row and meet no bank conflict, the
  k order and P·V's output columns cover the head's dims once, and a
  lane's V run is read in aligned pieces that never pass it (24 bytes at
  D = 96: 8-byte pieces);
- the route: bf16 queries take the ``*_split`` kernels, f32 queries the
  unsplit ``fused_decode_kernel``.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops.attention import alibi_slopes
from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view, scales_flat
from atoma_infer_tpu_torch.ops.kv_write import write_kv_cache_plain, write_kv_cache_quant_plain

from jax_compiled import ragged_paged_attention_fused, ragged_paged_attention_fused_quant
from torch_parity import (
    jax_meta, jax_scale_pages, quantized_case, ragged_case, to_numpy, to_torch, torch_meta,
    valid_rows,
)

torch.set_num_threads(2)

TOL = 2e-2
KT = pa.RPA_KEY_TILE
# The model's splits take at least 2 key tiles (the kernel's min_tiles is an
# argument; the route gives it FUSED_MIN_TILES), so that rows of a few
# hundred keys are cut into several.
MIN_TILES = pa.RPA_MIN_TILES


# ------------------------------------------------------------ the split plan
@pytest.mark.parametrize("window", [None, 1, 40, 300])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("min_tiles", [1, 2, 3])
def test_split_ranges_cover_every_key_once(window, splits, min_tiles):
    for pos in list(range(0, 200)) + [255, 256, 1023, 1599, 2047, 4000]:
        ranges = pa.split_key_ranges(pos, window, splits, min_tiles)
        lo = max(0, pos - window + 1) if window else 0
        n_tiles = pos // KT + 1 - lo // KT
        assert 1 <= len(ranges) <= splits
        assert ranges[0][0] == lo and ranges[-1][1] == pos + 1
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c  # contiguous: every key once
        for i, (a, b) in enumerate(ranges):
            assert a < b
            assert (a % KT == 0 or i == 0) and (b % KT == 0 or i == len(ranges) - 1)
        # The new key (the write) lies in the last split only.
        assert [a <= pos < b for a, b in ranges] == [False] * (len(ranges) - 1) + [True]
        if n_tiles <= min_tiles:
            assert len(ranges) == 1  # a short row stays whole


def test_plan_takes_shapes_only():
    params = inspect.signature(pa.fused_split_plan).parameters
    assert set(params) == {"num_seq_slots", "max_keys", "num_kv_heads", "slots", "columns"}
    assert all(p.kind == p.KEYWORD_ONLY for p in params.values())


H100_SLOTS = 132 * 8


@pytest.mark.parametrize("S, P, bs", [(8, 32, 16), (64, 128, 16), (8, 8, 64), (1, 256, 16),
                                      (256, 128, 16), (4, 128, 16)])
def test_splits_for_ignores_sequence_lengths(S, P, bs, monkeypatch):
    """The same splits whatever the lengths; none where the grid already
    fills the card; more where few rows leave it idle."""
    monkeypatch.setattr(pa, "_fused_slots", lambda kind, d, g, dev: H100_SLOTS)
    rng = np.random.default_rng(S + P)
    got = set()
    for _ in range(3):
        lens = rng.integers(1, P * bs + 1, size=S).astype(np.int32)
        meta = torch_meta(dict(slot_mapping=np.zeros(S), block_tables=np.zeros((S, P)),
                               seq_lens=lens, query_start_loc=np.arange(S + 1), num_seqs=S,
                               block_size=bs, decode_only=True, max_q_len=1))
        q = torch.empty((S, 32, 128), dtype=torch.bfloat16)
        got.add(pa.fused_splits_for(q, meta, 8, None))
    assert len(got) == 1
    splits = got.pop()
    assert splits == pa.fused_split_plan(num_seq_slots=S, max_keys=P * bs, num_kv_heads=8,
                                         slots=H100_SLOTS)
    assert 1 <= splits <= pa.RPA_MAX_SPLITS
    if S * 8 >= 0.8 * H100_SLOTS or P * bs <= pa.FUSED_MIN_TILES * KT:
        assert splits == 1  # a full grid, or rows too short to be worth a merge
    if S * 8 * 4 <= H100_SLOTS and P * bs >= 4 * pa.FUSED_MIN_TILES * KT:
        assert splits >= 4


@pytest.mark.parametrize("kind", [None, torch.int8, torch.float8_e4m3fn])
def test_route(kind):
    q16, q32 = torch.empty(2, 4, 64, dtype=torch.bfloat16), torch.empty(2, 4, 64)
    assert pa.fused_route(q16, kind) is pa.FUSED_DECODE_SPLIT[kind]
    assert pa.fused_route(q32, kind) is pa.FUSED_DECODE[kind]
    assert pa.FUSED_DECODE_SPLIT[kind].name == pa.FUSED_DECODE[kind].name + "_split"
    suffix = pa.FUSED_DECODE[kind].source[len("paged_attention"):-len("_fused.cu")]
    assert pa.FUSED_DECODE_SPLIT[kind].source == f"fused_decode_split{suffix}.cu"


# ------------------------------------------------------ the kernel, in a model
def bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def model_fused(case, kind, splits, *, window=None, soft_cap=None, alibi=None):
    """The split kernel's arithmetic on the case: the write (by the last
    split of each row), each split's (m, l, O), the merge of split rows.
    Returns (out [T, Hq, D] rounded to bf16, the written cache, the written
    scales or None)."""
    meta = torch_meta(case)
    cache = to_torch(case["kv_cache"]).clone()
    scales = None if kind != "int8" else to_torch(case["kv_scales"]).clone()
    k_new, v_new = (to_torch(case[x]).to(torch.bfloat16) for x in ("k_new", "v_new"))
    if scales is not None:
        write_kv_cache_quant_plain(cache, scales, k_new, v_new, meta.slot_mapping)
    else:
        write_kv_cache_plain(cache, k_new, v_new, meta.slot_mapping)
    q = to_torch(case["q"]).float()
    T, Hq, D = q.shape
    Hk = cache.shape[2] // (2 * D)
    G = Hq // Hk
    k_view, v_view = kv_cache_view(cache, Hk, D)
    K_all, V_all = k_view.float(), v_view.float()  # [slots, Hk, D]
    ks_all, vs_all = (scales_flat(scales) if scales is not None
                      else (torch.ones(K_all.shape[0]), torch.ones(K_all.shape[0])))
    ks_all, vs_all = ks_all.float(), vs_all.float()
    ws_o = torch.zeros((splits, T, Hq, D))
    ws_ml = torch.zeros((splits, T, Hq, 2))
    out = torch.zeros((T, Hq, D))
    lens, qsl, bt = case["seq_lens"], case["query_start_loc"], case["block_tables"]
    bs = case["block_size"]
    scale = D ** -0.5
    slopes = torch.zeros(Hq) if alibi is None else alibi.float()
    for s in range(case["num_seqs"]):
        t, pos = qsl[s], lens[s] - 1
        ranges = pa.split_key_ranges(pos, window, splits, MIN_TILES)
        writers = [i for i, (a, b) in enumerate(ranges) if a <= pos < b]
        assert writers == [len(ranges) - 1]  # the write happens once, in the last split
        for i, (a, b) in enumerate(ranges):
            keys = np.arange(a, b)
            slots = torch.from_numpy(bt[s, keys // bs] * bs + keys % bs).long()
            for h in range(Hk):
                Q = q[t, h * G:(h + 1) * G]                                # [G, D]
                sc = (Q @ K_all[slots, h].T) * ks_all[slots] * scale      # [G, keys]
                if soft_cap:
                    sc = soft_cap * torch.tanh(sc / soft_cap)
                sc = sc + slopes[h * G:(h + 1) * G, None] * torch.from_numpy(
                    (keys - pos).astype(np.float32))
                m = sc.amax(1)
                p = torch.exp(sc - m[:, None])
                l = p.sum(1)
                # P·V takes p times the V scale rounded to bf16 (its mma's A).
                pb = (p * vs_all[slots]).to(torch.bfloat16).float()
                o = pb @ V_all[slots, h]                                    # [G, D]
                if len(ranges) == 1:
                    out[t, h * G:(h + 1) * G] = o / l[:, None]
                else:
                    ws_o[i, t, h * G:(h + 1) * G] = o
                    ws_ml[i, t, h * G:(h + 1) * G] = torch.stack([m, l], 1)
    pa.split_combine_plain(ws_o, ws_ml, out, meta, bq=1, splits=splits,
                           min_tiles=MIN_TILES, window=window)
    return bf16(out.numpy()), cache, scales


SPECS = [(1, kv) for kv in (1, 40, 64, 65, 300, 700)]


def _case(kind, *, group, D, block_size, seed, specs=SPECS):
    # Hk 4 at D = 32 keeps Hq·D and the cache row at multiples of 128, as the
    # Pallas kernel needs. Rows of 1 to 700 keys: short rows whole, long
    # rows in several splits.
    Hk = 4 if D == 32 else 2
    kw = dict(num_q_heads=Hk * group, num_kv_heads=Hk, head_dim=D, block_size=block_size,
              num_blocks=sum(-(-kv // block_size) for _, kv in specs) + 4, pad_seqs_to=8)
    rng = np.random.default_rng(seed)
    case = (ragged_case(rng, specs, **kw) if kind == "bf16"
            else quantized_case(rng, specs, kind, **kw))
    for x in ("q", "k_new", "v_new"):
        case[x] = case[x].astype(ml_dtypes.bfloat16)
    if kind == "bf16":
        case["kv_cache"] = case["kv_cache"].astype(ml_dtypes.bfloat16)
    return case


def _plain(case, kind, **kw):
    """fused_decode_attention_plain on a copy of the case's cache."""
    scales = case.get("kv_scales")
    cache = to_torch(case["kv_cache"]).clone()
    sc = None if scales is None else to_torch(scales).clone()
    out = pa.fused_decode_attention_plain(
        to_torch(case["q"]), cache, to_torch(case["k_new"]), to_torch(case["v_new"]),
        torch_meta(case), scale=case["q"].shape[2] ** -0.5, kv_scales=sc, **kw)
    return out.float().numpy(), cache, sc


def _jax(case, kind, **kw):
    """JAX's fused kernel (or its INT8 twin) in interpret mode: (out, cache,
    scales or None)."""
    D = case["q"].shape[2]
    meta = dataclasses.replace(jax_meta(case), decode_only=True)
    args = (jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]))
    kn, vn = jnp.asarray(case["k_new"]), jnp.asarray(case["v_new"])
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    if kind == "int8":
        out, cache, sc = ragged_paged_attention_fused_quant(
            *args, jnp.asarray(jax_scale_pages(case["kv_scales"])), kn, vn, meta,
            scale=D ** -0.5, interpret=True, **jkw)
        return np.asarray(out).astype(np.float32), cache, np.asarray(sc)[..., :2]
    out, cache = ragged_paged_attention_fused(*args, kn, vn, meta, scale=D ** -0.5,
                                              interpret=True, **jkw)
    return np.asarray(out).astype(np.float32), cache, None


def _bytes(a):
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _mods(mod, Hq):
    return {"window": dict(sliding_window=150), "soft_cap": dict(soft_cap=5.0),
            "alibi": dict(alibi_slopes=alibi_slopes(Hq)), "none": {}}[mod]


def _model(case, kind, splits, kw):
    return model_fused(case, kind, splits, window=kw.get("sliding_window"),
                       soft_cap=kw.get("soft_cap"), alibi=kw.get("alibi_slopes"))


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("block_size", [16, 64])
@pytest.mark.parametrize("D, group", [(32, 1), (64, 3), (128, 4), (32, 8), (64, 8), (128, 1)])
def test_model_matches_plain(kind, block_size, D, group):
    """Split into up to 1, 3 and 16 splits a row: within TOL of the unsplit
    plain version, and the written cache and scales byte for byte its."""
    case = _case(kind, group=group, D=D, block_size=block_size, seed=D + group + block_size)
    n = valid_rows(case)
    want, want_cache, want_sc = _plain(case, kind)
    for splits in (1, 3, 16):
        got, cache, sc = _model(case, kind, splits, {})
        np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(_bytes(cache), _bytes(want_cache))
        if sc is not None:
            np.testing.assert_array_equal(_bytes(sc), _bytes(want_sc))


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("D, group", [(32, 1), (64, 3), (128, 4), (32, 8)])
@pytest.mark.parametrize("mod", ["none", "window", "soft_cap", "alibi"])
def test_model_matches_plain_and_jax_fused(kind, D, group, mod):
    """One score modifier at a time, 4 splits at most, blocks of 64 (JAX's
    fused kernels take 1-byte caches in blocks of 32 and more): against the
    plain version and JAX's fused kernels in interpret mode; the written
    cache and scales equal JAX's byte for byte."""
    case = _case(kind, group=group, D=D, block_size=64,
                 seed=7 * D + group + len(mod) + 10 * len(kind), specs=SPECS[:4] + [(1, 200)])
    Hk = case["kv_cache"].shape[2] // (2 * D)
    kw = _mods(mod, Hk * group)
    n = valid_rows(case)
    got, cache, sc = _model(case, kind, 4, kw)
    want, _, _ = _plain(case, kind, **kw)
    np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)
    out_j, cache_j, sc_j = _jax(case, kind, **kw)
    np.testing.assert_allclose(got[:n], out_j[:n], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(_bytes(cache), _bytes(cache_j))
    if sc is not None:
        np.testing.assert_array_equal(_bytes(sc), _bytes(sc_j))


def _wide_cases(shapes):
    """(D, group, kind) cases: each shape over a bf16 cache (its first
    cases, ids as they were), then over INT8 and e4m3 caches."""
    return ([pytest.param(D, g, "bf16", id=f"{D}-{g}") for D, g in shapes]
            + [pytest.param(D, g, kind, id=f"{D}-{g}-{kind}") for kind in ("int8", "fp8")
               for D, g in shapes])


@pytest.mark.parametrize("block_size", [16, 64])
@pytest.mark.parametrize("D, group, kind", _wide_cases([(96, 1), (256, 2), (96, 8), (256, 8)]))
def test_model_matches_plain_wide_heads(block_size, D, group, kind):
    """The same at Phi-3-mini's (96) and Gemma-2's (256) head dims over a
    bf16, an INT8 and an e4m3 cache."""
    test_model_matches_plain(kind, block_size, D, group)


@pytest.mark.parametrize("D, group, kind", _wide_cases([(96, 1), (256, 2)]))
@pytest.mark.parametrize("mod", ["none", "window", "soft_cap", "alibi"])
def test_model_matches_plain_and_jax_fused_wide_heads(D, group, kind, mod):
    """The same at Phi-3-mini's and Gemma-2's shapes (group 1 and 2), over
    each cache kind."""
    test_model_matches_plain_and_jax_fused(kind, D, group, mod)


# ------------------------------------------------- the kernel's geometry
def fs_tile(D, elt):
    """``FsTile``: (16-byte pieces of a K row, a lane's piece in bytes: 16
    where the row is a multiple of 64 bytes, else 8; the ring's padded row
    in bytes)."""
    nbytes = D * elt
    piece = 16 if nbytes % 64 == 0 else 8
    row = (nbytes + 64 + 127) // 128 * 128 - 64 if piece == 16 else nbytes
    return nbytes // 16, piece, row


GEOMETRIES = [(32, 2), (64, 2), (96, 2), (128, 2), (256, 2), (32, 1), (64, 1), (128, 1),
              (96, 1), (256, 1)]


@pytest.mark.parametrize("D, elt", GEOMETRIES)
def test_ring_copies_and_loads(D, elt):
    """A warp's ring copies each of the round's 32 K rows whole and once:
    copy c of lane l is chunk l % kChunks of key c (32 / kChunks) + l /
    kChunks where the chunks divide the lanes, else (12 chunks a row at D =
    96, 6 in a 1-byte cache: ``kWalk``) piece 32 c + l of the round's
    key-major pieces. Q·Kᵀ's
    reads, lane (gid, tig) kPiece bytes at 4 kPiece c + kPiece tig of key
    8 j + gid's row: within the row, and a load phase (2 keys of 16-byte
    pieces, or 4 of 8-byte ones) on disjoint banks."""
    chunks, piece, row = fs_tile(D, elt)
    walk = 32 % chunks != 0
    assert walk == (D == 96)
    seen = {}
    for c in range(chunks):
        for lane in range(32):
            if walk:
                key, chunk = (32 * c + lane) // chunks, (32 * c + lane) % chunks
            else:
                key, chunk = c * (32 // chunks) + lane // chunks, lane % chunks
            seen[(key, chunk)] = seen.get((key, chunk), 0) + 1
    assert seen == {(k, ch): 1 for k in range(32) for ch in range(chunks)}
    assert row % 16 == 0 and row >= D * elt
    lanes_a_phase = 128 // piece
    for c in range(D * elt // (4 * piece)):
        for first in range(0, 32, lanes_a_phase):
            words = set()
            for lane in range(first, first + lanes_a_phase):
                gid, tig = lane >> 2, lane & 3
                start = gid * row + 4 * piece * c + piece * tig
                assert 4 * piece * c + piece * tig + piece <= D * elt
                words |= {(start // 4 + w) % 32 for w in range(piece // 4)}
            assert len(words) == 32  # every bank once: no conflict


@pytest.mark.parametrize("D, elt", GEOMETRIES)
def test_qk_k_order_and_pv_columns_cover_the_dims(D, elt):
    """Q·Kᵀ's k order (step st of lane tig: dims 4 EPL (st / SPC) + EPL tig +
    4 (st % SPC) + 0..3) and P·V's output map (column n of n8 tile m: dim
    NT n + m) each take every dim of the head exactly once."""
    _, piece, _ = fs_tile(D, elt)
    epl = piece // elt
    spc = epl // 4
    dims = [4 * epl * (st // spc) + epl * tig + 4 * (st % spc) + i
            for st in range(D // 16) for tig in range(4) for i in range(4)]
    assert sorted(dims) == list(range(D))
    NT = D // 8
    assert sorted(NT * n + m for n in range(8) for m in range(NT)) == list(range(D))


@pytest.mark.parametrize("D, elt", GEOMETRIES)
@pytest.mark.parametrize("num_kv_heads", [1, 2, 8, 32])
def test_v_runs_are_read_in_aligned_pieces(D, elt, num_kv_heads):
    """A lane's V run (dims NT gid .. NT gid + NT − 1 of its key's V row),
    read VC dims at a time (the whole run, or 16 dims at D = 256) in
    ``load_run``'s pieces (16 bytes where a piece's words are a multiple of
    4, else 8, else 4): the pieces tile the run exactly, never past it (at D
    = 96 a run is 24 bytes: three 8-byte pieces, not two 16-byte ones; in a
    1-byte cache 12 bytes: three 4-byte pieces), and each is aligned to its
    size at every kv head, lane and cache row."""
    NT = D // 8
    VC = 16 if NT > 16 else NT
    words = VC * elt // 4
    size = 16 if words % 4 == 0 else 8 if words % 2 == 0 else 4
    row_bytes = 2 * num_kv_heads * D * elt
    for h in range(num_kv_heads):
        for gid in range(8):
            run = (h * 2 * D + D + NT * gid) * elt
            covered = []
            for c0 in range(0, NT, VC):
                for off in range(0, VC * elt, size):
                    start = run + c0 * elt + off
                    assert start % size == 0 and (start + row_bytes) % size == 0
                    covered += range(start, start + size)
            assert covered == list(range(run, run + NT * elt))


def test_bf16_jax_fused_at_block_16():
    """JAX's bf16 fused kernel takes blocks of 16: the model against it there."""
    case = _case("bf16", group=4, D=128, block_size=16, seed=99, specs=SPECS[:5])
    n = valid_rows(case)
    got, cache, _ = _model(case, "bf16", 8, {})
    out_j, cache_j, _ = _jax(case, "bf16")
    np.testing.assert_allclose(got[:n], out_j[:n], atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(_bytes(cache), _bytes(cache_j))


def test_split_combine_plain_leaves_unsplit_rows():
    """Rows whose query tile took one split keep what the attention stored;
    split rows become the weighted merge, splits past a row's count unread."""
    case = _case("bf16", group=1, D=32, block_size=16, seed=5)
    meta = torch_meta(case)
    T, Hq, D = case["q"].shape
    rng = np.random.default_rng(0)
    ws_o = torch.from_numpy(rng.standard_normal((4, T, Hq, D)).astype(np.float32))
    ws_ml = torch.from_numpy(np.abs(rng.standard_normal((4, T, Hq, 2))).astype(np.float32))
    ws_ml[3] = float("nan")  # past the call's 3 splits: never read
    out = torch.full((T, Hq, D), 7.0)
    pa.split_combine_plain(ws_o, ws_ml, out, meta, bq=1, splits=3,
                           min_tiles=MIN_TILES)
    for s, (_, kv) in enumerate(SPECS):
        nsplit = len(pa.split_key_ranges(kv - 1, None, 3, MIN_TILES))
        t = case["query_start_loc"][s]
        if nsplit == 1:
            assert torch.all(out[t] == 7.0)
            continue
        m, l = ws_ml[:nsplit, t, :, 0], ws_ml[:nsplit, t, :, 1]
        w = torch.exp(m - m.amax(0))
        want = (w[..., None] * ws_o[:nsplit, t]).sum(0) / (w * l).sum(0)[..., None]
        torch.testing.assert_close(out[t], want)


# ------------------------------------------------------- the ablation tool
def test_rpa_ablation_fused_mode_needs_a_card():
    from atoma_infer_tpu_torch.tools import rpa_ablation

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    with pytest.raises(SystemExit, match="CUDA device"):
        rpa_ablation.main(["--mode", "fused"])


def test_rpa_ablation_decode_batch_writes_each_rows_last_slot():
    from atoma_infer_tpu_torch.tools import rpa_ablation

    specs = [(1, 1), (1, 17), (1, 64), (1, 300)]
    b = rpa_ablation.make_batch(np.random.default_rng(0), specs, hq=8, hk=2, d=32, bs=16,
                                kind=None, device=torch.device("cpu"), decode=True)
    m = b["meta"]
    assert m.decode_only and b["q"].shape[0] == len(specs) == b["k"].shape[0]
    for s, (_, kv) in enumerate(specs):
        pos = kv - 1
        assert int(m.slot_mapping[s]) == int(m.block_tables[s, pos // 16]) * 16 + pos % 16


def test_rpa_ablation_fused_hooks_are_the_sources():
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.tools import rpa_ablation

    source = (cuda_lib.CSRC_DIR / "fused_decode_split.cuh").read_text()
    assert rpa_ablation.FS_VARIANTS["port"] == ()
    for flags in rpa_ablation.FS_VARIANTS.values():
        for flag in flags:
            assert flag.startswith("-D") and flag[2:].split("=")[0] in source
    assert "ATOMA_FS_SHAPES_D128_G4" in source
    assert not any(flag.startswith("-DATOMA_FS") for flag in cuda_lib.NVCC_FLAGS)
