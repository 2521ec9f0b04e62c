"""Context-parallel (split-KV) decode attention in the port, against JAX's.

Mirrors ``tests/test_context_parallel.py``: the plain partial attention
(``ops/reference.py`` ``ragged_paged_attention_plain_partial``) against
JAX's ``ragged_paged_attention_xla_partial`` (page masks, window, soft cap,
ALiBi, INT8 scales); partials over an arbitrary page split, combined by the
log-sum-exp rule, against the full attention; a rank that owns none of a
row's pages stays finite and weighs nothing; and
``parallel/context_parallel.py`` ``cp_decode_attention_layer`` over 4 and 8
spawned gloo ranks against JAX's over as many virtual CPU devices: the
outputs within 2e-5 (f32), every rank's cache pages equal to JAX's sharded
cache and to the one-rank write, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tpar
from test_context_parallel import BS, HK, D, _decode_batch, _oracle

TOL = 2e-5


def _np_batch(rng, num_seqs, num_pages, max_pages):
    q, k_new, v_new, cache, meta = _decode_batch(rng, num_seqs, num_pages, max_pages)
    return dict(q=np.array(q), k_new=np.array(k_new), v_new=np.array(v_new),
                cache=np.array(cache), slots=np.array(meta.slot_mapping),
                tables=np.array(meta.block_tables), seq_lens=np.array(meta.seq_lens),
                bs=BS), (q, k_new, v_new, cache, meta)


def _written(b):
    """The cache after the step's write (plain), and its K/V views."""
    from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view, write_kv_cache

    cache = torch.from_numpy(b["cache"].copy())
    write_kv_cache(cache, torch.from_numpy(b["k_new"]), torch.from_numpy(b["v_new"]),
                   torch.from_numpy(b["slots"]))
    return cache, kv_cache_view(cache, HK, D)


def _partial(b, views, page_valid=None, **kw):
    from atoma_infer_tpu_torch.ops.reference import ragged_paged_attention_plain_partial

    S = b["seq_lens"].shape[0]
    return ragged_paged_attention_plain_partial(
        torch.from_numpy(b["q"]), *views, torch.from_numpy(b["tables"]),
        torch.from_numpy(b["seq_lens"]), torch.arange(S + 1, dtype=torch.int32),
        scale=D ** -0.5, block_size=BS, page_valid=page_valid, **kw)


@pytest.mark.parametrize("kw", [
    {}, {"soft_cap": 30.0}, {"sliding_window": 24}, {"alibi": True}, {"scales": True},
], ids=["plain", "soft-cap", "window", "alibi", "int8-scales"])
def test_plain_partial_matches_jax_partial(kw):
    from atoma_infer_tpu.ops.kv_cache import kv_cache_view as jax_view, write_kv_cache as jax_write
    from atoma_infer_tpu.ops.reference import ragged_paged_attention_xla_partial

    rng = np.random.RandomState(4)
    b, (q, k_new, v_new, cache, meta) = _np_batch(rng, 5, 48, 5)
    owner = rng.randint(0, 2, size=48)
    mine = owner[b["tables"]] == 1
    extra, jextra = {}, {}
    for key in ("soft_cap", "sliding_window"):
        if key in kw:
            extra[key] = jextra[key] = kw[key]
    if kw.get("alibi"):
        slopes = rng.uniform(0.01, 0.5, size=4).astype(np.float32)
        extra["alibi_slopes"], jextra["alibi_slopes"] = torch.from_numpy(slopes), jnp.asarray(slopes)
    if kw.get("scales"):
        slots = 48 * BS
        ks, vs = (rng.uniform(0.01, 0.1, size=slots).astype(np.float32) for _ in range(2))
        extra.update(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        jextra.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    _, views = _written(b)
    got = _partial(b, views, torch.from_numpy(mine), **extra)
    jcache = jax_write(cache, k_new, v_new, meta.slot_mapping)
    want = ragged_paged_attention_xla_partial(
        q, *jax_view(jcache, HK, D), meta.block_tables, meta.seq_lens, meta.query_start_loc,
        scale=D ** -0.5, block_size=BS, page_valid=jnp.asarray(mine), **jextra)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("ways", [2, 3, 5])
def test_partials_over_a_page_split_combine_to_the_full_attention(ways):
    """Disjoint page owners' partials, combined by the log-sum-exp rule,
    give the full attention (the port's plain version and JAX's oracle)."""
    from atoma_infer_tpu_torch.ops.reference import ragged_paged_attention_plain
    from atoma_infer_tpu_torch.parallel.context_parallel import combine_partials

    rng = np.random.RandomState(ways)
    b, (q, k_new, v_new, cache, meta) = _np_batch(rng, 6, 64, 6)
    want, _ = _oracle(q, k_new, v_new, cache, meta)
    _, views = _written(b)
    S = b["seq_lens"].shape[0]
    full = ragged_paged_attention_plain(
        torch.from_numpy(b["q"]), *views, torch.from_numpy(b["tables"]),
        torch.from_numpy(b["seq_lens"]), torch.arange(S + 1, dtype=torch.int32),
        scale=D ** -0.5, block_size=BS)
    owner = rng.randint(0, ways, size=64)
    parts = [_partial(b, views, torch.from_numpy(owner[b["tables"]] == s)) for s in range(ways)]
    num, m, l = (torch.stack(x) for x in zip(*parts))
    m_g = m.amax(dim=0)
    c = torch.exp(m - m_g)
    combined = (num * c[..., None]).sum(0) / (l * c).sum(0)[..., None]
    np.testing.assert_allclose(combined.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(combined.numpy(), full.numpy(), atol=TOL, rtol=TOL)
    # One rank: combine_partials over no group is the normalisation alone.
    one = combine_partials(*_partial(b, views), None)
    np.testing.assert_allclose(one.numpy(), full.numpy(), atol=TOL, rtol=TOL)


def test_empty_shard_is_finite_and_weighs_nothing():
    rng = np.random.RandomState(1)
    b, _ = _np_batch(rng, 3, 32, 4)
    _, views = _written(b)
    num, m, l = _partial(b, views, torch.zeros(b["tables"].shape, dtype=torch.bool))
    assert torch.isfinite(num).all()
    assert (num == 0).all() and (l == 0).all()
    assert (m <= -1e29).all()


def _jax_cp(n_shards, q, k_new, v_new, cache, meta, **kw):
    from atoma_infer_tpu.parallel.context_parallel import cp_decode_attention_layer
    from atoma_infer_tpu.parallel.mesh import TP_AXIS, make_mesh

    mesh = make_mesh(tp=n_shards, devices=jax.devices()[:n_shards])
    out, new_cache = jax.jit(lambda *a: cp_decode_attention_layer(
        *a, mesh=mesh, scale=D ** -0.5, axis=TP_AXIS, **kw))(q, cache, k_new, v_new, meta)
    return np.asarray(out), np.asarray(new_cache)


@pytest.mark.parametrize("n_ranks", [4, 8])
def test_cp_layer_over_gloo_ranks_matches_jax(n_ranks, tmp_path):
    rng = np.random.RandomState(2)
    b, jb = _np_batch(rng, 8, 64, 6)
    want, want_cache = _jax_cp(n_ranks, *jb)
    ref_out, _ = _oracle(*jb)
    one, _ = _written(b)
    ranks = tpar.spawn_ranks(tpar.cp_rank, n_ranks, tmp_path, b, {})
    pages = 64 // n_ranks
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["out"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["out"], np.asarray(ref_out), atol=TOL, rtol=TOL)
        assert got["collectives"] == 3
        assert np.array_equal(got["cache"], want_cache[r * pages:(r + 1) * pages])
        assert np.array_equal(got["cache"], one.numpy()[r * pages:(r + 1) * pages])


def test_cp_layer_soft_cap_and_window(tmp_path):
    rng = np.random.RandomState(3)
    b, jb = _np_batch(rng, 5, 32, 4)
    kw = dict(soft_cap=30.0, sliding_window=24)
    want, _ = _jax_cp(4, *jb, **kw)
    ref_out, _ = _oracle(*jb, **kw)
    for got in tpar.spawn_ranks(tpar.cp_rank, 4, tmp_path, b, kw):
        np.testing.assert_allclose(got["out"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["out"], np.asarray(ref_out), atol=TOL, rtol=TOL)
