"""Attention at every head dim and GQA group the JAX package serves, on the
CPU: head dims that run at a padded width, odd ones, those past 256, and
groups past 128 q heads per kv head.

The port's attention kernels (A, B, D, E and the merge of split rows) are
instantiated at the widths 32, 64, 96, 128, 256 and 512 and run any head dim
from 1 to 512 on the smallest width that holds it, the head dim passed at
run time (``instance_dim``): Q, K and V are staged with their columns past
the head dim zero-filled, the output columns there are never stored, and a
head's K and V rows are copied in the widest pieces its bytes allow
(16, 8, 4, 2 or 1 bytes: ``copy_width``; an odd head dim's Q and output a
half of a pair at a time). The tensor-core ragged kernel cuts a token's
group past 128 q heads per kv head into slices of at most 128 rows, a block
each; at the width 512 one kernel serves A, D, E and the fused B, D, E, a
16-row tile a block whose 4 warps split O's columns (its numpy model:
``test_torch_rpa_mma.py``), a group past 16 cut into slices of 16 rows. The
kernels run only on the card; what is checked here:

- the plain versions (what the kernels are held against on the card)
  against the JAX package's XLA branch (``ops/reference.py``, through its
  ``ragged_paged_attention`` and ``paged_attention_layer`` on the CPU) and
  its Pallas kernels in interpret mode where JAX's gates admit the shape:
  A, D and E on mixed batches, B and the fused D and E on decode batches
  (written caches and INT8 scales byte for byte), and the merge of split
  rows, at head dims 8, 40, 80, 100, 112, 120, 160, 192 and 248, and at 1,
  7, 63, 257, 320, 511 and 512 (odd ones and the width 512), over a cache of
  the queries' dtype, an INT8 one and an e4m3 one, groups 1, 4 and 8, with a
  sliding window and a soft cap (at 512 and 384 against the Pallas kernels
  too); at groups 144 and 256 the ragged plain version, with the plan's
  slices and grid;
- numpy models of the kernels' padded staging: the ragged kernel's and the
  split fused kernel's copies (every byte of a head's K and V rows copied
  once, in aligned pieces that never cross the head's end, the columns past
  it zero), the split fused kernel's V runs, and the kernels' arithmetic at
  the width (the tensor-core ragged kernel's query tiles, slices, KV splits
  and merge; the split fused kernel's splits and merge) against the plain
  version at the head dim; the CUDA-core ragged kernel's thread map
  (``test_torch_shapes.py``) at the new head dims too;
- tiny services at head dims 80 (Mistral with a window), 100, 120 and 63
  (a Llama with ALiBi in place of RoPE), at 144 q heads per kv head, and a
  Gemma-2 at head dim 512, through the port's and JAX's ``LlmService``:
  greedy tokens identical, sync and async, in f32, and at tp 2;
- the shape check: every head dim from 1 up admitted on every route and
  dtype (past 512 too, since the width-512 kernels take column slices:
  ``test_torch_head_dims_past_512.py``), any group; head dims under 1
  refused by the wrappers and by ``LlmService.start`` before anything is
  loaded; the split workspace's reserve at head dims 100 and 512 covers
  what the kernels write.

Tolerances (those of ``test_torch_fused_group.py`` and
``test_torch_shapes.py``):
- f32 queries over an f32 cache (and over a 1-byte cache, whose values are
  exact in f32): atol 1e-5 / rtol 1e-5, the same arithmetic in another
  order;
- bf16 queries: 2e-2 (``ATTN_TOL["bfloat16"]`` of ``chip_smoke.py``: bf16
  inputs, one rounding of the output to bf16, P in bf16 in the models and
  in the Pallas kernels);
- caches and scales after a write: byte for byte.
"""

import asyncio
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import test_torch_fused_split as fs
import torch_parity as tpar
from atoma_infer_tpu.ops.attention import _pallas_supported
from atoma_infer_tpu_torch.ops import paged_attention as pa
from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view, scales_flat
from atoma_infer_tpu_torch.ops.kv_write import write_kv_cache_plain, write_kv_cache_quant_plain
from jax_compiled import paged_attention_layer as jax_attention_layer
from jax_compiled import ragged_paged_attention as jax_ragged
from jax_compiled import (
    ragged_paged_attention_fused,
    ragged_paged_attention_fused_quant,
    ragged_paged_attention_pallas,
)

torch.set_num_threads(2)

ATOL = 1e-5
TOL = 2e-2
KT = pa.RPA_KEY_TILE
# The head dims checked: every width's padded range, the three published
# ones (h2o-danube-1.8b's 80, OpenLLaMA-3B's 100, h2o-danube3-4b's 120),
# and the smallest and largest.
HEAD_DIMS = [8, 40, 80, 100, 112, 120, 160, 192, 248]
# Odd head dims (on the widths 32, 64 and 512) and the width 512's.
ODD_AND_W512_DIMS = [1, 7, 63, 257, 320, 511, 512]
KINDS = ["f32", "bf16", "int8", "fp8"]
MIXED = [(20, 45), (1, 30), (7, 7), (1, 1), (33, 140), (1, 300)]
DECODE = [(1, kv) for kv in (1, 40, 64, 65, 300, 700)]


def _case(kind, D, group, specs, seed, *, num_kv_heads=2, block_size=16):
    """A batch at head dim ``D``: f32 queries over an f32 cache ("f32"),
    bf16 queries over a bf16 cache, or bf16 queries over an INT8 (with
    scales) or e4m3 cache."""
    kw = dict(num_q_heads=num_kv_heads * group, num_kv_heads=num_kv_heads, head_dim=D,
              block_size=block_size, pad_seqs_to=8,
              num_blocks=sum(-(-kv // block_size) for _, kv in specs) + 4)
    rng = np.random.default_rng(seed)
    case = (tpar.ragged_case(rng, specs, **kw) if kind in ("f32", "bf16")
            else tpar.quantized_case(rng, specs, kind, **kw))
    if kind != "f32":
        for x in ("q", "k_new", "v_new"):
            case[x] = case[x].astype(ml_dtypes.bfloat16)
    if kind == "bf16":
        case["kv_cache"] = case["kv_cache"].astype(ml_dtypes.bfloat16)
    return case


def _tol(kind):
    return ATOL if kind == "f32" else TOL


def _jax_scales(case):
    scales = case.get("kv_scales")
    return None if scales is None else jnp.asarray(tpar.jax_scale_pages(scales))


def _plain_ragged(case, **kw):
    scales = case.get("kv_scales")
    return pa.ragged_paged_attention_paged_plain(
        tpar.to_torch(case["q"]), tpar.to_torch(case["kv_cache"]), tpar.torch_meta(case),
        scale=case["q"].shape[2] ** -0.5,
        kv_scales=None if scales is None else tpar.to_torch(scales), **kw).float().numpy()


def _plain_fused(case, **kw):
    """fused_decode_attention_plain on copies: (out, cache, scales)."""
    scales = case.get("kv_scales")
    cache = tpar.to_torch(case["kv_cache"]).clone()
    sc = None if scales is None else tpar.to_torch(scales).clone()
    out = pa.fused_decode_attention_plain(
        tpar.to_torch(case["q"]), cache, tpar.to_torch(case["k_new"]),
        tpar.to_torch(case["v_new"]), tpar.torch_meta(case), scale=case["q"].shape[2] ** -0.5,
        kv_scales=sc, **kw)
    return out.float().numpy(), cache, sc


def _jax_kw(kw):
    return {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items()}


# ------------------------------------------- plain versions against JAX
def _shapes():
    """(D, kind, group): every head dim over every cache kind, the groups
    1, 4 and 8 taken in turn."""
    return [pytest.param(D, kind, (1, 4, 8)[(i + j) % 3], id=f"{D}-{kind}")
            for i, D in enumerate(HEAD_DIMS + ODD_AND_W512_DIMS)
            for j, kind in enumerate(KINDS)]


@pytest.mark.parametrize("D, kind, group", _shapes())
def test_ragged_plain_matches_jax(D, kind, group):
    """A, D and E's plain version on a mixed batch (chunks and decode rows,
    one of 300 keys) against JAX's XLA branch on the same pages, with no
    score modifier and with a sliding window and a soft cap."""
    case = _case(kind, D, group, MIXED, seed=D * 7 + group + len(kind))
    n = tpar.valid_rows(case)
    for kw in ({}, dict(sliding_window=50, soft_cap=5.0)):
        got = _plain_ragged(case, **kw)
        want = np.asarray(jax_ragged(
            jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), tpar.jax_meta(case),
            scale=D ** -0.5, kv_scales=_jax_scales(case), **kw)).astype(np.float32)
        np.testing.assert_allclose(got[:n], want[:n], atol=_tol(kind), rtol=_tol(kind))


@pytest.mark.parametrize("D, kind, group", _shapes())
def test_fused_plain_matches_jax(D, kind, group):
    """B and the fused D and E's plain version (the write, then attention)
    on a decode batch against JAX's XLA branch (its ``paged_attention_layer``
    on the CPU: the write, an INT8 cache's scales taken over the token's
    rows, then the XLA attention): the written cache and scales byte for
    byte, the output within the tolerance; with a window and a soft cap."""
    case = _case(kind, D, group, DECODE, seed=D * 11 + group + len(kind))
    n = tpar.valid_rows(case)
    kw = dict(sliding_window=150, soft_cap=5.0) if D % 3 == 0 else {}
    got, cache, sc = _plain_fused(case, **kw)
    meta = dataclasses.replace(tpar.jax_meta(case), decode_only=True)
    want, cache_j, sc_j = jax_attention_layer(
        jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), _jax_scales(case),
        jnp.asarray(case["k_new"]), jnp.asarray(case["v_new"]), meta, scale=D ** -0.5,
        **_jax_kw(kw))
    np.testing.assert_allclose(got[:n], np.asarray(want).astype(np.float32)[:n],
                               atol=_tol(kind), rtol=_tol(kind))
    np.testing.assert_array_equal(fs._bytes(cache), fs._bytes(cache_j))
    if sc is not None:
        np.testing.assert_array_equal(fs._bytes(sc), fs._bytes(np.asarray(sc_j)[..., :2]))


# Shapes JAX's Pallas gates admit at these head dims (merged head lanes
# Hq·D and the cache row 2·Hk·D multiples of 128), each over two cache
# kinds, every kind at two or three of them: (D, Hk, group, kind).
PALLAS_SHAPES = [(80, 4, 2, "f32"), (80, 4, 2, "int8"), (112, 4, 2, "bf16"),
                 (112, 4, 2, "fp8"), (120, 8, 2, "int8"), (120, 8, 2, "f32"),
                 (160, 2, 2, "fp8"), (160, 2, 2, "bf16"), (192, 2, 2, "bf16"),
                 (192, 2, 2, "fp8"), (512, 2, 2, "bf16"), (512, 2, 2, "int8"),
                 (384, 2, 2, "fp8"), (384, 2, 2, "f32")]


@pytest.mark.parametrize("D, Hk, group, kind", PALLAS_SHAPES)
def test_plain_matches_pallas_interpret(D, Hk, group, kind):
    """Where JAX's gates admit the shape (blocks of 32, which its kernels
    take for every cache kind): the ragged plain version against
    ``ragged_paged_attention_pallas`` in interpret mode on a mixed batch,
    and the fused one against ``ragged_paged_attention_fused`` (its INT8
    twin over an INT8 cache) on a decode batch, caches and scales byte for
    byte."""
    specs = [(20, 40), (1, 70), (1, 1)]
    case = _case(kind, D, group, specs, seed=D + Hk + len(kind), num_kv_heads=Hk,
                 block_size=32)
    meta = tpar.jax_meta(case)
    q, cache = jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"])
    assert _pallas_supported(q, cache, meta)
    n = tpar.valid_rows(case)
    want = ragged_paged_attention_pallas(q, cache, meta, scale=D ** -0.5, interpret=True,
                                         kv_scales=_jax_scales(case))
    np.testing.assert_allclose(_plain_ragged(case)[:n], np.asarray(want).astype(np.float32)[:n],
                               atol=_tol(kind), rtol=_tol(kind))
    case = _case(kind, D, group, [(1, kv) for kv in (1, 33, 90, 200)], seed=D + Hk,
                 num_kv_heads=Hk, block_size=32)
    n = tpar.valid_rows(case)
    got, cache_t, sc_t = _plain_fused(case)
    meta = dataclasses.replace(tpar.jax_meta(case), decode_only=True)
    args = (jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]))
    new = (jnp.asarray(case["k_new"]), jnp.asarray(case["v_new"]), meta)
    if kind == "int8":
        want, cache_j, sc_j = ragged_paged_attention_fused_quant(
            *args, _jax_scales(case), *new, scale=D ** -0.5, interpret=True)
        np.testing.assert_array_equal(fs._bytes(sc_t), fs._bytes(np.asarray(sc_j)[..., :2]))
    else:
        want, cache_j = ragged_paged_attention_fused(*args, *new, scale=D ** -0.5,
                                                     interpret=True)
    np.testing.assert_array_equal(fs._bytes(cache_t), fs._bytes(cache_j))
    np.testing.assert_allclose(got[:n], np.asarray(want).astype(np.float32)[:n],
                               atol=_tol(kind), rtol=_tol(kind))


@pytest.mark.parametrize("group", [144, 256])
@pytest.mark.parametrize("D, kind", [(32, "f32"), (80, "bf16"), (128, "int8")])
def test_ragged_plain_matches_jax_past_128(group, D, kind):
    """Groups past 128 q heads per kv head (one kv head): the ragged plain
    version against JAX's XLA branch, on a mixed batch and on decode rows
    (whose steps take the write and the ragged kernel); the plan takes 8
    warps, one token a tile and two slices, its grid (tiles, Hk · slices,
    splits) as the kernel's launch sizes it."""
    for specs in (MIXED, DECODE):
        case = _case(kind, D, group, specs, seed=group + D, num_kv_heads=1)
        n = tpar.valid_rows(case)
        got = _plain_ragged(case)
        want = np.asarray(jax_ragged(
            jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), tpar.jax_meta(case),
            scale=D ** -0.5, kv_scales=_jax_scales(case))).astype(np.float32)
        np.testing.assert_allclose(got[:n], want[:n], atol=_tol(kind), rtol=_tol(kind))
        T, S = case["q"].shape[0], case["block_tables"].shape[0]
        plan = pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=case["max_q_len"],
                               max_keys=case["block_tables"].shape[1] * 16, group=group,
                               num_kv_heads=1, slots=132 * 2)
        assert (plan.warps, plan.tokens, plan.slices) == (8, 1, 2)
        grid = (T // plan.tokens + S, 1 * plan.slices, plan.splits)
        assert grid[1] == 2 and grid[2] >= 1
        assert pa.decode_route(group, 1) == "ragged"


# ------------------------------------------------- the kernels' staging
def copy_width(head_bytes):
    """``copy_width``: the widest of 16, 8, 4, 2, 1 bytes dividing a head's
    bytes."""
    return next(w for w in (16, 8, 4, 2, 1) if head_bytes % w == 0)


def piece_copies(head_bytes, piece, width):
    """The copies of 16-byte piece ``piece`` of a head's K (or V) row: one
    16-byte ``cp.async`` where the head's bytes are a multiple of 16, else
    ``cp_async_part``'s pieces of ``width``: the (offset in the piece,
    bytes) of each copy that reads; the rest of the piece is zero-filled."""
    n = min(16, max(0, head_bytes - 16 * piece))
    if width == 16:
        return [(0, 16)] if n else []
    return [(o, width) for o in range(0, 16, width) if o < n]


def stage_row(src, head_bytes, width_bytes):
    """A (slot, kv head) K|V slice of ``2 head_bytes`` bytes staged into
    ring rows of ``width_bytes`` (the instantiation width's bytes) as the
    kernels' copies place it: returns (K row, V row, the byte offsets of
    the slice each copy read, each read's size)."""
    w = copy_width(head_bytes)
    K, V = np.zeros(width_bytes, np.uint8), np.zeros(width_bytes, np.uint8)
    reads = []
    for half, dst in ((0, K), (1, V)):
        for p in range(width_bytes // 16):
            for o, size in piece_copies(head_bytes, p, w):
                at = half * head_bytes + 16 * p + o
                dst[16 * p + o: 16 * p + o + size] = src[at: at + size]
                reads.append((at, size))
    return K, V, reads


@pytest.mark.parametrize("head_dim", HEAD_DIMS + [50, 64, 128])
@pytest.mark.parametrize("elt", [1, 2, 4])
def test_staging_copies_each_byte_once_zero_past_the_head(head_dim, elt):
    """The ragged kernel's (and the split fused kernel's K ring's) staging
    at a padded width: every byte of a head's K and V rows is read once,
    by copies of ``copy_width`` bytes (50 in a 1-byte cache: 2; in bf16: 4)
    that are aligned at every kv head and cache row (the cache's base
    16-byte aligned) and never cross the head's end; the ring rows hold the
    head's bytes, then zeros to the width."""
    w = _check_staging(head_dim, elt)
    assert w >= 2 * elt if elt < 4 else w >= 8


def _check_staging(head_dim, elt):
    """The staging of a head of ``head_dim`` elements of ``elt`` bytes at
    its width, checked for 1, 2 and 8 kv heads; returns the copy width."""
    width = pa.instance_dim(head_dim)
    hb, wb = head_dim * elt, width * elt
    rng = np.random.default_rng(head_dim + elt)
    w = copy_width(hb)
    for hk in (1, 2, 8):
        row = 2 * hk * hb
        for h in range(hk):
            src = rng.integers(1, 256, size=2 * hb).astype(np.uint8)
            K, V, reads = stage_row(src, hb, wb)
            np.testing.assert_array_equal(K[:hb], src[:hb])
            np.testing.assert_array_equal(V[:hb], src[hb:])
            assert not K[hb:].any() and not V[hb:].any()
            covered = sorted(b for at, size in reads for b in range(at, at + size))
            assert covered == list(range(2 * hb))
            for at, size in reads:
                for slot in (0, 1, 7):
                    assert (slot * row + h * 2 * hb + at) % size == 0
                assert at // hb == (at + size - 1) // hb  # within K or within V
    return w


@pytest.mark.parametrize("head_dim", ODD_AND_W512_DIMS + [3, 9, 127, 255])
@pytest.mark.parametrize("elt", [1, 2, 4])
def test_odd_and_w512_staging_copies_each_byte_once(head_dim, elt):
    """The same staging at odd head dims and at the width 512: an odd head
    of a 1-byte cache is copied byte by byte (``cp_async_part``'s and
    ``load16_padded``'s 1-byte pieces: its K and V start at odd offsets),
    in 16 bits 2 bytes at a time, in f32 4; the width 512's even heads as
    wide as their bytes allow (512 and 320: whole 16-byte pieces)."""
    w = _check_staging(head_dim, elt)
    assert w == (elt if head_dim % 2 else min(16, copy_width(head_dim * elt)))
    if head_dim in (320, 512):
        assert w == 16


def v_run_loads(head_dim, elt, gid, c0):
    """The split fused kernel's V reads: lane gid's run (dims NT gid + c0 ..
    + VC − 1 of the width's NT = width / 8), read in ``load_run``'s pieces
    up to the run's bytes inside the head, or, where the head's copy width
    is below that piece (the run then starts only that aligned),
    ``load_run_padded``'s 4-byte reads (2-byte at a copy width of 2, 1-byte
    at 1): (dim offset, dims) of each read; dims at or past the head dim are
    0 and never read."""
    width = pa.instance_dim(head_dim)
    NT = width // 8
    VC = 16 if NT > 16 else NT
    words = VC * elt // 4
    run_piece = 16 if words % 4 == 0 else 8 if words % 2 == 0 else 4
    cw = copy_width(head_dim * elt)
    w = run_piece if cw >= run_piece else 4 if cw >= 4 else cw
    n = min(VC, max(0, head_dim - NT * gid - c0)) * elt
    return [(NT * gid + c0 + b // elt, w // elt) for b in range(0, VC * elt, w) if b < n], w


@pytest.mark.parametrize("head_dim", HEAD_DIMS + [50, 96])
@pytest.mark.parametrize("elt", [1, 2])
def test_v_runs_read_the_head_once_in_aligned_pieces(head_dim, elt):
    """The split fused kernel's V runs at a padded width: over the lanes'
    runs (gid 0 to 7, VC dims at a time) every dim of the head is read
    once, none past it, each read aligned to its size at every kv head and
    cache row."""
    _check_v_runs(head_dim, elt)


def _check_v_runs(head_dim, elt):
    width = pa.instance_dim(head_dim)
    NT = width // 8
    VC = 16 if NT > 16 else NT
    for hk in (1, 2, 8):
        row = 2 * hk * head_dim * elt
        dims = []
        for h in range(hk):
            dims = []
            for gid in range(8):
                for c0 in range(0, NT, VC):
                    loads, w = v_run_loads(head_dim, elt, gid, c0)
                    for d, count in loads:
                        start = (h * 2 * head_dim + head_dim + d) * elt
                        assert start % w == 0 and (start + row) % w == 0
                        dims += range(d, d + count)
            assert sorted(dims) == list(range(head_dim))


@pytest.mark.parametrize("head_dim", [1, 3, 7, 9, 63, 127, 255])
@pytest.mark.parametrize("elt", [1, 2])
def test_v_runs_at_odd_head_dims(head_dim, elt):
    """The split fused kernel's V runs at odd head dims (widths 32 to 256):
    a 1-byte cache's runs read byte by byte, a 16-bit cache's 2 bytes at a
    time, each dim of the head once and none past it."""
    _check_v_runs(head_dim, elt)
    assert v_run_loads(head_dim, elt, 0, 0)[1] == elt


def stage_case(case, head_dim, width):
    """The case as the kernels stage it at ``width``: Q, k_new, v_new and
    every (slot, kv head) K|V slice of the cache widened to ``width`` dims,
    the dims past ``head_dim`` zero (:func:`stage_row`'s layout, element
    for element)."""
    out = dict(case)
    for x in ("q", "k_new", "v_new"):
        a = np.asarray(case[x])
        pad = np.zeros(a.shape[:-1] + (width,), a.dtype)
        pad[..., :head_dim] = a
        out[x] = pad
    cache = np.asarray(case["kv_cache"])
    nb, bs, row = cache.shape
    Hk = row // (2 * head_dim)
    staged = np.zeros((nb, bs, Hk, 2, width), cache.dtype)
    staged[..., :head_dim] = cache.reshape(nb, bs, Hk, 2, head_dim)
    out["kv_cache"] = staged.reshape(nb, bs, 2 * Hk * width)
    return out


def model_ragged(case, plan, head_dim, *, window=None, key_tile=KT):
    """The tensor-core ragged kernel's arithmetic on a case staged at its
    width: query tiles of ``plan.tokens`` tokens laid end to end, a token's
    group cut into ``plan.slices`` slices of near-equal size (one block per
    tile, kv head and slice), 64-key tiles in KV splits merged by
    log-sum-exp, each attended ``key_tile`` keys at a time (the width 512's
    ring stages: 32), P in bf16 after the V scale; scale head_dim^-0.5 and
    only the head's dims stored. Returns [T, Hq, head_dim] rounded to
    bf16."""
    import test_torch_rpa_mma as rm

    q = np.asarray(case["q"], np.float32)
    T, Hq, W = q.shape
    cache = np.asarray(case["kv_cache"]).astype(np.float32)
    nb, bs, row = cache.shape
    Hk = row // (2 * W)
    G = Hq // Hk
    group_rows = -(-G // plan.slices)
    flat = cache.reshape(nb * bs, Hk, 2, W)
    sc = (np.asarray(case["kv_scales"]).astype(np.float32).reshape(nb * bs, 2)
          if "kv_scales" in case else np.ones((nb * bs, 2), np.float32))
    qsl, lens, bt = case["query_start_loc"], case["seq_lens"], case["block_tables"]
    win, scale = window or 0, np.float32(head_dim ** -0.5)
    out = np.zeros((T, Hq, head_dim), np.float32)
    seen = np.zeros((T, Hq), int)
    for h in range(Hk):
        for z in range(plan.slices):
            for s, tok0, ntok in rm.query_tiles(qsl, case["num_seqs"], lens, plan.tokens, T,
                                                bt.shape[0]):
                first = lens[s] - (qsl[s + 1] - qsl[s]) + tok0
                last = first + ntok - 1
                key_lo = max(0, first - win + 1) if win else 0
                r = np.arange(ntok * group_rows)
                ti, gg = r // group_rows, z * group_rows + r % group_rows
                r, ti, gg = r[gg < G], ti[gg < G], gg[gg < G]
                Q, qpos = q[qsl[s] + tok0 + ti, h * G + gg], first + ti
                t_lo, n_tiles = rm.tile_keys(first, last, win)
                nsplit = rm.split_count(n_tiles, plan.splits)
                parts = []
                for i in range(nsplit):
                    tb, te = rm.split_range(t_lo, n_tiles, nsplit, i)
                    m = np.full(len(r), -np.inf, np.float32)
                    l = np.zeros(len(r), np.float32)
                    o = np.zeros((len(r), W), np.float32)
                    for t in range(tb * KT // key_tile, te * KT // key_tile):
                        keys = t * key_tile + np.arange(key_tile)
                        ok = (keys >= key_lo) & (keys <= last)
                        slots = np.where(ok, bt[s, np.minimum(keys // bs, bt.shape[1] - 1)] * bs
                                         + keys % bs, 0)
                        K = np.where(ok[:, None], flat[slots, h, 0], 0)
                        V = np.where(ok[:, None], flat[slots, h, 1], 0)
                        sco = (Q @ K.T) * np.where(ok, sc[slots, 0], 0) * scale
                        vis = keys[None, :] <= qpos[:, None]
                        if win:
                            vis &= keys[None, :] > qpos[:, None] - win
                        sco = np.where(vis, sco, -np.inf).astype(np.float32)
                        m_new = np.maximum(m, sco.max(axis=1))
                        m_use = np.where(np.isneginf(m_new), 0, m_new)
                        alpha, p = np.exp(m - m_use), np.exp(sco - m_use[:, None])
                        l = l * alpha + p.sum(axis=1)
                        o = o * alpha[:, None] + rm.bf16(p * np.where(ok, sc[slots, 1], 0)) @ V
                        m = m_new
                    parts.append((m, l, o))
                m, l, o = rm.merge(parts)
                res = np.where(l[:, None] > 0, o / np.where(l > 0, l, 1)[:, None], 0)
                assert not res[:, head_dim:].any()  # the padded columns: zero V columns
                out[qsl[s] + tok0 + ti, h * G + gg] = rm.bf16(res[:, :head_dim])
                seen[qsl[s] + tok0 + ti, h * G + gg] += 1
    n = tpar.valid_rows(case)
    assert (seen[:n] == 1).all()  # every (token, q head) row in one block
    return out


@pytest.mark.parametrize("head_dim, kind, group", [
    (80, "bf16", 4), (100, "int8", 1), (120, "fp8", 8), (40, "bf16", 2), (192, "int8", 3),
    (50, "fp8", 4), (112, "bf16", 144), (32, "int8", 256), (63, "bf16", 4), (7, "int8", 2),
    (320, "bf16", 4), (512, "int8", 2), (511, "fp8", 20), (257, "bf16", 1),
])
def test_ragged_model_at_the_width_matches_plain(head_dim, kind, group):
    """The tensor-core ragged kernel's model on the case staged at its
    width, with the plan's tiles, slices (two past 128 q heads per kv head;
    at the width 512, whose tiles are 16 rows in 32-key stages, past 16)
    and up to 1, 4 and 16 KV splits, within TOL of the plain version at the
    head dim, with and without a window."""
    hk = 1 if group > 128 else 2
    width = pa.instance_dim(head_dim)
    split_cols = width == pa.W512
    case = _case(kind, head_dim, group, MIXED, seed=head_dim + group, num_kv_heads=hk)
    staged = stage_case(case, head_dim, width)
    n = tpar.valid_rows(case)
    T, S = case["q"].shape[0], case["block_tables"].shape[0]
    for window in (None, 60):
        want = _plain_ragged(case, sliding_window=window)
        for splits in (1, 4, 16):
            plan = pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=case["max_q_len"],
                                   max_keys=4096, group=group, num_kv_heads=hk, slots=1 << 20,
                                   padded=width != head_dim, split_cols=split_cols)
            plan = dataclasses.replace(plan, splits=splits)
            assert plan.slices == (2 if group > (16 if split_cols else 128) else 1)
            got = model_ragged(staged, plan, head_dim, window=window,
                               key_tile=32 if split_cols else KT)
            np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)


def model_fused_at_width(case, kind, splits, head_dim):
    """The split fused kernel's arithmetic on a case staged at its width
    (:func:`stage_case`): the write of the new rows (their padded dims
    zero), each split's (m, l, O) over its key range, the merge of split
    rows by ``split_combine_plain`` into a workspace strided by the head
    dim; scale head_dim^-0.5. Returns (out [T, Hq, head_dim] rounded to
    bf16, the written cache at the head dim, its scales or None)."""
    meta = tpar.torch_meta(case)
    cache = tpar.to_torch(case["kv_cache"]).clone()
    scales = None if kind != "int8" else tpar.to_torch(case["kv_scales"]).clone()
    k_new, v_new = (tpar.to_torch(case[x]).to(torch.bfloat16) for x in ("k_new", "v_new"))
    if scales is not None:
        write_kv_cache_quant_plain(cache, scales, k_new, v_new, meta.slot_mapping)
    else:
        write_kv_cache_plain(cache, k_new, v_new, meta.slot_mapping)
    q = tpar.to_torch(case["q"]).float()
    T, Hq, W = q.shape
    Hk = cache.shape[2] // (2 * W)
    G = Hq // Hk
    k_view, v_view = (x.float() for x in kv_cache_view(cache, Hk, W))
    ones = torch.ones(k_view.shape[0])
    ks_all, vs_all = ((x.float() for x in scales_flat(scales)) if scales is not None
                      else (ones, ones))
    ws_o = torch.zeros(pa.split_workspace_shapes(splits, T, Hq, head_dim)[0])
    ws_ml = torch.zeros(pa.split_workspace_shapes(splits, T, Hq, head_dim)[1])
    out = torch.zeros((T, Hq, head_dim))
    lens, qsl, bt, bs = (case[k] for k in ("seq_lens", "query_start_loc", "block_tables",
                                           "block_size"))
    for s in range(case["num_seqs"]):
        t, pos = qsl[s], lens[s] - 1
        ranges = pa.split_key_ranges(pos, None, splits, fs.MIN_TILES)
        for i, (a, b) in enumerate(ranges):
            keys = np.arange(a, b)
            slots = torch.from_numpy(bt[s, keys // bs] * bs + keys % bs).long()
            for h in range(Hk):
                Q = q[t, h * G:(h + 1) * G]
                sc = (Q @ k_view[slots, h].T) * ks_all[slots] * head_dim ** -0.5
                m = sc.amax(1)
                p = torch.exp(sc - m[:, None])
                l = p.sum(1)
                o = (p * vs_all[slots]).to(torch.bfloat16).float() @ v_view[slots, h]
                assert not o[:, head_dim:].any()
                if len(ranges) == 1:
                    out[t, h * G:(h + 1) * G] = o[:, :head_dim] / l[:, None]
                else:
                    ws_o[i, t, h * G:(h + 1) * G] = o[:, :head_dim]
                    ws_ml[i, t, h * G:(h + 1) * G] = torch.stack([m, l], 1)
    pa.split_combine_plain(ws_o, ws_ml, out, meta, bq=1, splits=splits,
                           min_tiles=fs.MIN_TILES)
    nb, bsz, _ = cache.shape
    cache = cache.view(nb, bsz, Hk, 2, W)[..., :head_dim].reshape(nb, bsz, -1)
    return fs.bf16(out.numpy()), cache, scales


@pytest.mark.parametrize("head_dim, kind, group", [
    (80, "bf16", 4), (100, "int8", 1), (120, "fp8", 8), (8, "int8", 12), (160, "bf16", 2),
    (50, "fp8", 16), (63, "int8", 4), (7, "bf16", 1), (257, "bf16", 2), (511, "fp8", 12),
    (512, "int8", 16),
])
def test_fused_model_at_the_width_matches_plain(head_dim, kind, group):
    """The split fused kernel's model on the case staged at its width, in
    up to 1, 3 and 16 splits a row (the merge's plain version on a
    workspace strided by the head dim), within TOL of the plain version at
    the head dim and of JAX's XLA branch; the written cache and scales
    byte for byte the plain version's."""
    case = _case(kind, head_dim, group, DECODE, seed=head_dim * 3 + group)
    staged = stage_case(case, head_dim, pa.instance_dim(head_dim))
    n = tpar.valid_rows(case)
    want, want_cache, want_sc = _plain_fused(case)
    meta = dataclasses.replace(tpar.jax_meta(case), decode_only=True)
    jax_out = np.asarray(jax_attention_layer(
        jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), _jax_scales(case),
        jnp.asarray(case["k_new"]), jnp.asarray(case["v_new"]), meta,
        scale=head_dim ** -0.5)[0]).astype(np.float32)
    for splits in (1, 3, 16):
        got, cache, sc = model_fused_at_width(staged, kind, splits, head_dim)
        np.testing.assert_allclose(got[:n], want[:n], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got[:n], jax_out[:n], atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(fs._bytes(cache.contiguous()), fs._bytes(want_cache))
        if sc is not None:
            np.testing.assert_array_equal(fs._bytes(sc), fs._bytes(want_sc))


@pytest.mark.parametrize("head_dim", HEAD_DIMS + [32, 64, 96, 128, 256] + ODD_AND_W512_DIMS)
def test_instance_dim_and_routes(head_dim):
    """A head dim runs at the smallest width that holds it; the route's
    kernel of a 1-byte cache at the widths 96 and 256 is a ``*_wide``
    instantiation, of every query dtype; every route's kernel at the width
    512 a ``*_w512`` one, from a ``*_w512*.cu`` source; the fused and ragged
    kernels' occupancy is asked at the width."""
    width = pa.instance_dim(head_dim)
    assert width in pa.INSTANCE_DIMS and width >= head_dim
    assert all(w < head_dim for w in pa.INSTANCE_DIMS if w < width)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q = torch.empty((8, 4, head_dim), dtype=dtype)
        for kind in (None, torch.int8, torch.float8_e4m3fn):
            wide = width in pa.WIDE_HEAD_DIMS and (kind is not None or dtype == torch.float32)
            for route in (pa.ragged_route(q, kind), pa.fused_route(q, kind)):
                assert route.name.endswith("_wide") == wide or route.name.endswith(
                    "_wide_f16") == wide
                w512 = route.name.endswith(("_w512", "_w512_f16"))
                assert w512 == (width == pa.W512) and ("_w512" in route.source) == w512
                assert route.name.endswith("_f16") == (dtype == torch.float16)


def test_plans_ask_the_occupancy_of_the_padded_instantiation(monkeypatch):
    """``rpa_plan_for`` and ``fused_splits_for`` ask the card's occupancy
    with the head dim, which the C entry points answer for the
    instantiation that runs it (below its width the padded one), from the
    width's source; a padded head dim's ragged plan takes 8 warps (its
    instantiation's only), the width's own head dim 4 on decode rows."""
    asked = []
    monkeypatch.setattr(pa, "_rpa_slots", lambda kind, d, w, dev: asked.append(d) or 264)
    monkeypatch.setattr(pa, "_fused_slots", lambda kind, d, g, dev: asked.append(d) or 264)
    meta = tpar.torch_meta(dict(
        slot_mapping=np.zeros(8), block_tables=np.zeros((8, 128)), seq_lens=np.full(8, 2000),
        query_start_loc=np.arange(9), num_seqs=8, block_size=16, decode_only=True,
        max_q_len=1))
    for head_dim, width in ((80, 96), (100, 128), (120, 128), (192, 256), (8, 32), (128, 128),
                            (63, 64), (7, 32), (320, 512), (511, 512), (512, 512)):
        q = torch.empty((8, 8, head_dim), dtype=torch.bfloat16)
        plan = pa.rpa_plan_for(q, meta, 2, None)
        pa.fused_splits_for(q, meta, 2, None)
        assert asked[-2:] == [head_dim, head_dim]
        # The width 512: 4 warps over one 16-row tile, 4 q heads a token.
        assert plan.warps == (4 if head_dim == width or width == pa.W512 else 8)
        assert plan.tokens == (4 if width == pa.W512 else plan.warps * 16 // 4)
        assert pa._tc_kernel(pa._RAGGED_TC, torch.bfloat16, torch.int8, head_dim).source == (
            pa._tc_kernel(pa._RAGGED_TC, torch.bfloat16, torch.int8, width).source)


# ------------------------------------------------------------- the services
def _widths(head_dim, hq, hk, window=None, alibi=False):
    """A 2-layer Llama at ``head_dim`` (with a sliding window: a Mistral,
    whose embeddings are untied; with ``alibi``, ALiBi in place of RoPE)."""
    return dict(
        vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=hq, num_key_value_heads=hk, head_dim=head_dim,
        max_position_embeddings=2048, rope_theta=10000.0, rope_scaling=None,
        tie_word_embeddings=window is None, sliding_window=window, eos_token_ids=(1,),
        bos_token_id=0, use_alibi=alibi,
    )


# (head dim, q heads, kv heads, window[, ALiBi]): h2o-danube-1.8b's head dim
# with a window (Mistral), OpenLLaMA-3B's (as many kv heads as q heads),
# h2o-danube3-4b's; 144 q heads over one kv head; an odd head dim, which
# only ALiBi models have (RoPE halves the head dim).
SERVICES = {"D80-mistral": (80, 4, 2, 24), "D100": (100, 2, 2, None),
            "D120": (120, 4, 1, None), "G144": (8, 144, 1, None),
            "D63-alibi": (63, 4, 2, None, True)}


def _port_tokens(tmp_path, widths, async_scheduling, *, tp=1):
    """The port's greedy tokens on ``PROMPTS`` with JAX's f32 parameters at
    ``widths``, served as ``test_torch_fused_group._jax_tokens`` serves
    them (at ``tp``, ranks on gloo)."""
    import test_torch_fused_group as fg
    from atoma_infer_tpu_torch.engine.llm_service import LlmService, ModelFactory
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    path = tpar.save_params(tmp_path / "llama.npz", fg._jax_params(widths))
    factory = ModelFactory(config=LlamaConfig(**widths), build=tpar.npz_model,
                           args=(path, "llama", widths, torch.float32))
    config = tpar.tp_engine_config(
        tp, async_scheduling=async_scheduling,
        coordinator_address=tpar.rendezvous_file(tmp_path) if tp > 1 else None)
    service = LlmService.start(config, model_factory=factory, device="cpu")
    if tp == 1:
        assert service.engine.worker.model.config.head_dim == widths["head_dim"]
    return tpar.generate(service, fg.PROMPTS)


@pytest.mark.parametrize("name, async_scheduling", [
    pytest.param(name, a, id=f"{name}-{'async' if a else 'sync'}")
    for name in sorted(SERVICES) for a in ((False,) if name == "G144" else (False, True))])
def test_service_matches_jax(name, async_scheduling, tmp_path):
    """Tiny services at head dims 80 (a Mistral with a 24-key window, which
    the prompts pass), 100, 120 and 63 (with ALiBi), sync and async, and at
    144 q heads per kv head, synchronous, through the port's ``LlmService``
    and JAX's on the same f32 weights: greedy tokens identical."""
    import test_torch_fused_group as fg

    widths = _widths(*SERVICES[name])
    assert _port_tokens(tmp_path, widths, async_scheduling) == fg._jax_tokens(
        widths, async_scheduling)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_gemma2_service_at_head_dim_512_matches_jax(kv, tmp_path, monkeypatch):
    """A 4-layer Gemma-2 with 2 q heads over one kv head of 512 (soft caps
    50 and 30, query_pre_attn_scalar 256, a 16-key window on alternate
    layers, which the prompts pass) from one checkpoint directory through
    the port's and JAX's ``LlmService`` in f32, over an f32 and an INT8
    cache: greedy tokens identical."""
    import test_torch_families as tf

    monkeypatch.setitem(tf.CASES, "gemma2-d512", (dict(
        tf.CASES["gemma2-d256"][0], head_dim=512, num_hidden_layers=4), "Gemma2ForCausalLM"))
    tf._build_checkpoint("gemma2-d512", str(tmp_path))
    want = tf._serve_dir("atoma_infer_tpu", str(tmp_path), tf.SERVICE_PROMPTS, kv)
    got = tf._serve_dir("atoma_infer_tpu_torch", str(tmp_path), tf.SERVICE_PROMPTS, kv)
    assert got == want
    assert all(len(t) == 16 or t[-1] == 1 for t in got)


def test_service_at_head_dim_100_matches_jax_at_tp2(tmp_path):
    """OpenLLaMA-3B's head dim, 4 q heads over 2 kv heads at tp 2 (each
    rank one kv head), two ranks on gloo, against JAX's service at tp 2:
    greedy tokens identical."""
    import test_torch_fused_group as fg

    widths = _widths(100, 4, 2)
    assert _port_tokens(tmp_path, widths, False, tp=2) == fg._jax_tokens(widths, False, tp=2)


# ------------------------------------------------------- the shape checks
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("kind", [None, torch.int8, torch.float8_e4m3fn],
                         ids=["same", "int8", "fp8"])
def test_shape_check_admits_every_even_head_dim(dtype, kind):
    """Every head dim from 1 to 512 (the even ones from 8 to 256 among
    them), ragged and fused, for bf16, fp16 and f32 queries over each cache
    kind, and any group on the ragged kernel (the fused kernel up to 16)."""
    for head_dim in range(1, 513):
        for fused in (False, True):
            pa.check_kernel_shape(head_dim=head_dim, dtype=dtype, kind=kind, group=4,
                                  block_size=16, fused=fused)
    for group in (129, 144, 256, 1000):
        pa.check_kernel_shape(head_dim=128, dtype=dtype, kind=kind, group=group,
                              block_size=16, fused=False)


@pytest.mark.parametrize("head_dim", [7, 81, 99, 255, 258, 512, 6, 0, 513, 1024, -1])
def test_shape_check_refuses_odd_and_past_256(head_dim):
    """Odd head dims, head dims past 256 and under 8, once refused, are
    admitted on every route, and so, since the width-512 kernels take column
    slices, are head dims past 512 (513 and 1,024, refused before); under 1
    they are refused."""
    for fused in (False, True):
        shape = dict(head_dim=head_dim, dtype=torch.bfloat16, kind=torch.int8, group=2,
                     block_size=16, fused=fused)
        if head_dim >= 1:
            pa.check_kernel_shape(**shape)
            continue
        with pytest.raises(ValueError, match=f"unsupported head_dim {head_dim} .*head dims from 1"):
            pa.check_kernel_shape(**shape)


class _Loading(Exception):
    """Raised in place of building the model: the start got past its check."""


@pytest.mark.parametrize("hidden, heads, refused", [
    (2560, 32, False), (3200, 32, False), (3840, 32, False), (2592, 32, False),
    (8320, 32, False), (16384, 32, False), (16416, 32, False), (32768, 32, False),
    (16, 32, True)],
    ids=["80", "100", "120", "81", "260", "512", "513", "1024", "0"])
def test_cuda_service_checks_the_head_dim_before_loading(hidden, heads, refused, tmp_path,
                                                         monkeypatch):
    """``LlmService.start`` on the card, from a directory holding only a
    ``config.json`` (no weights, no tokenizer): at h2o-danube-1.8b's,
    OpenLLaMA-3B's and h2o-danube3-4b's head dims (hidden over heads: 80,
    100, 120), at 81, 260 and 512, and past 512 at 513 and 1,024 (refused
    before the width-512 kernels took column slices), the check passes and
    the start goes on to build the model; at a head dim of 0 the refusal
    comes from the config alone, before anything is read or allocated."""
    import json

    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine import llm_service
    from atoma_infer_tpu_torch.models import registry

    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=64, hidden_size=hidden, intermediate_size=256,
        num_hidden_layers=1, num_attention_heads=heads, num_key_value_heads=8)))
    monkeypatch.setattr(llm_service, "resolve_device", lambda device: torch.device("cuda"))

    def loading(*args, **kw):
        raise _Loading

    monkeypatch.setattr(registry, "get_model_cls", loading)
    config = EngineConfig.from_dict({
        "inference": {"model_name": str(tmp_path), "dtype": "bfloat16"},
        "scheduler": {"max_model_len": 2048},
    })
    if refused:
        with pytest.raises(ValueError, match="unsupported head_dim 0"):
            llm_service.LlmService.start(config, model_dir=str(tmp_path))
    else:
        with pytest.raises(_Loading):
            llm_service.LlmService.start(config, model_dir=str(tmp_path))


def test_split_workspace_reserve_covers_the_kernels_at_head_dim_100():
    """The graphs' reserve counts the split workspace the kernels write at
    head dim 100 (at the width 128): the most splits any plan takes over the
    pages, [splits, T, Hq, 100] f32 partials and their (m, l), strided by
    the head dim as the kernels and their merge index them; the width's
    columns are never written."""
    from atoma_infer_tpu_torch.engine.llm_service import split_workspace_bytes
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(head_dim=100, num_attention_heads=32, num_key_value_heads=32,
                      hidden_size=3200)
    T, P, bs = 256, 128, 16
    most = max(
        pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=q, max_keys=P * bs, group=1,
                        num_kv_heads=32, slots=s).splits
        for S in (1, 8, 64) for q in (1, 256) for s in (132, 264, 1 << 12))
    o, ml = pa.split_workspace_shapes(most, T, 32, 100)
    assert o == (most, T, 32, 100) and ml == (most, T, 32, 2)
    written = 4 * (math.prod(o) + math.prod(ml))
    reserve = split_workspace_bytes(T, cfg, P, bs)
    assert written <= reserve
    # The reserve's splits are the bound of every plan: up to RPA_MAX_SPLITS.
    assert reserve == 4 * pa.RPA_MAX_SPLITS * T * 32 * (100 + 2)


def test_split_workspace_reserve_covers_the_kernels_at_head_dim_512():
    """The same at the width 512 (Gemma-2-9B's widths with heads of 512: 8
    q heads over 4 kv heads), whose ragged plans tile 16 rows a block: the
    most splits any of its plans takes fits the reserve."""
    from atoma_infer_tpu_torch.engine.llm_service import split_workspace_bytes
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(head_dim=512, num_attention_heads=8, num_key_value_heads=4,
                      hidden_size=3584)
    T, P, bs = 256, 128, 16
    most = max(
        pa.rpa_mma_plan(num_seq_slots=S, num_tokens=T, max_q_len=q, max_keys=P * bs, group=2,
                        num_kv_heads=4, slots=s, split_cols=True).splits
        for S in (1, 8, 64) for q in (1, 256) for s in (132, 264, 1 << 12))
    o, ml = pa.split_workspace_shapes(most, T, 8, 512)
    assert 4 * (math.prod(o) + math.prod(ml)) <= split_workspace_bytes(T, cfg, P, bs)
