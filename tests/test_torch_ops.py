"""PyTorch port ops vs the JAX package on identical numpy inputs.

The port's plain versions (what CPU tensors take, and what its CUDA kernels
are held against on the card) against the JAX XLA oracle and against the
Pallas TPU kernels they replace, run in interpret mode as the JAX package's
own tests run them. Tolerances:
- KV-cache write: bit-exact (a pure copy in both packages).
- Attention, f32: atol 1e-5 / rtol 1e-5 against the XLA oracle (same
  formulation, only summation order differs) and atol 1e-5 against the
  Pallas kernels (online softmax vs one-shot softmax in f32: ~1e-6 apart).
- RoPE tables and rotation, f32: atol 1e-5 (cos/sin of the same f32 angles;
  libm and XLA differ by an ulp).

The CUDA wrappers themselves run only on the card (``chip_smoke.py``); here
their input checks are exercised: each raises on what its kernel does not
take, and on a CPU tensor, instead of falling back.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from atoma_infer_tpu.ops.kv_cache import kv_cache_view as jax_kv_cache_view
from atoma_infer_tpu.ops.kv_cache import write_kv_cache as jax_write_kv_cache
from atoma_infer_tpu.ops.paged_attention import (
    ragged_paged_attention_fused,
    ragged_paged_attention_pallas,
)
from atoma_infer_tpu.ops.reference import ragged_paged_attention_xla
from atoma_infer_tpu.ops.rope import RopeScalingConfig as JaxRopeScaling
from atoma_infer_tpu.ops.rope import apply_rope as jax_apply_rope
from atoma_infer_tpu.ops.rope import compute_cos_sin_cache as jax_cos_sin
from atoma_infer_tpu_torch.ops import attention as port_attention
from atoma_infer_tpu_torch.ops.kv_cache import (
    copy_blocks_layer,
    gather_blocks_layer,
    scatter_blocks_layer,
    write_kv_cache,
)
from atoma_infer_tpu_torch.ops.paged_attention import (
    fused_decode_attention_plain,
    ragged_paged_attention_paged_plain,
)
from atoma_infer_tpu_torch.ops.rope import RopeScalingConfig, apply_rope, compute_cos_sin_cache

from torch_parity import jax_meta, ragged_case, torch_meta, valid_rows

torch.set_num_threads(2)

ATOL = 1e-5


# ------------------------------------------------------------------ KV write
def test_kv_write_bit_exact_vs_xla_scatter_and_pallas():
    from jax.experimental.pallas import tpu as pltpu

    from atoma_infer_tpu.ops.kv_write import write_kv_cache_pallas

    rng = np.random.default_rng(0)
    kv = np.zeros((8, 8, 2 * 2 * 32), np.float32)  # 8 pages × bs 8, Hk 2, D 32
    k_new = rng.standard_normal((8, 2, 32)).astype(np.float32)
    v_new = rng.standard_normal((8, 2, 32)).astype(np.float32)
    slots = np.asarray([5, 63, -1, 17, 0, -1, 33, 12], np.int32)

    want = np.asarray(
        jax_write_kv_cache(jnp.asarray(kv), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots))
    )
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(
            write_kv_cache_pallas(
                jnp.asarray(kv), jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots)
            )
        )
    got = torch.from_numpy(kv.copy())
    write_kv_cache(got, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_kv_write_drops_out_of_range_slots():
    cache = torch.zeros((2, 4, 8))
    k = torch.ones((3, 2, 2))
    write_kv_cache(cache, k, 2 * k, torch.tensor([-1, 8, 3], dtype=torch.int32))
    assert cache.sum().item() == 12.0  # only slot 3: K (4 ones) + V (4 twos)
    assert cache[0, 3].tolist() == [1, 1, 2, 2, 1, 1, 2, 2]


def test_block_copy_gather_scatter_in_place():
    cache = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3)
    orig = cache.clone()
    copy_blocks_layer(cache, [(0, 3), (-1, -1)])
    assert torch.equal(cache[3], orig[0]) and torch.equal(cache[:3], orig[:3])
    pages = gather_blocks_layer(cache, [1, 2])
    scatter_blocks_layer(cache, [0, 3], pages)
    assert torch.equal(cache[0], orig[1]) and torch.equal(cache[3], orig[2])


# ---------------------------------------------------------------- attention
ATTN_CASES = {
    # name: (seq_specs, kwargs for ragged_case, attention options)
    "causal_prefill": ([(37, 37)], {}, {}),
    "chunked_continuation": ([(20, 52), (9, 30)], {}, {}),
    "mixed_prefill_decode": ([(24, 24), (13, 13), (1, 7), (1, 50), (1, 1)], {}, {}),
    "mha": ([(16, 40), (1, 9)], dict(num_q_heads=4, num_kv_heads=4), {}),
    "num_seqs_lt_slots": ([(12, 12), (1, 33)], dict(pad_seqs_to=8), {}),
    "sliding_window": ([(30, 45), (1, 40)], {}, dict(sliding_window=11)),
    "soft_cap": ([(18, 18), (1, 25)], {}, dict(soft_cap=2.0)),
    "alibi": ([(18, 30), (1, 25)], {}, dict(alibi=True)),
}


def _options(opts, num_q_heads):
    jax_kw, torch_kw = {}, {}
    for key in ("sliding_window", "soft_cap"):
        if key in opts:
            jax_kw[key] = torch_kw[key] = opts[key]
    if opts.get("alibi"):
        slopes = np.asarray(jax_alibi_slopes(num_q_heads))
        jax_kw["alibi_slopes"] = jnp.asarray(slopes)
        torch_kw["alibi_slopes"] = port_attention.alibi_slopes(num_q_heads)
        np.testing.assert_allclose(torch_kw["alibi_slopes"].numpy(), slopes, rtol=1e-7)
    return jax_kw, torch_kw


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_plain_vs_xla_oracle_and_pallas(name):
    specs, case_kw, opts = ATTN_CASES[name]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(name))
    case = ragged_case(rng, specs, **case_kw)
    D = case["q"].shape[2]
    Hk = case["k_new"].shape[1]
    scale = D**-0.5
    jax_kw, torch_kw = _options(opts, case["q"].shape[1])
    n = valid_rows(case)

    got = ragged_paged_attention_paged_plain(
        torch.from_numpy(case["q"]), torch.from_numpy(case["kv_cache"]),
        torch_meta(case), scale=scale, **torch_kw,
    ).numpy()

    meta = jax_meta(case)
    cache = jnp.asarray(case["kv_cache"])
    k_view, v_view = jax_kv_cache_view(cache, Hk, D)
    oracle = np.asarray(
        ragged_paged_attention_xla(
            jnp.asarray(case["q"]), k_view, v_view, meta.block_tables, meta.seq_lens,
            meta.query_start_loc, scale=scale, block_size=meta.block_size, **jax_kw,
        )
    )
    pallas = np.asarray(
        ragged_paged_attention_pallas(
            jnp.asarray(case["q"]), cache, meta, scale=scale, interpret=True, **jax_kw
        )
    )
    np.testing.assert_allclose(got[:n], oracle[:n], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got[:n], pallas[:n], atol=ATOL, rtol=ATOL)


def test_attention_dispatch_takes_plain_path_on_cpu():
    rng = np.random.default_rng(11)
    case = ragged_case(rng, [(9, 20), (1, 5)])
    q = torch.from_numpy(case["q"])
    cache = torch.from_numpy(case["kv_cache"])
    meta = torch_meta(case)
    got = port_attention.ragged_paged_attention(q, cache, meta, scale=0.2)
    want = ragged_paged_attention_paged_plain(q, cache, meta, scale=0.2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [None, 24])
def test_fused_decode_plain_vs_pallas_fused(window):
    rng = np.random.default_rng(20)
    specs = [(1, kv) for kv in (1, 5, 16, 17, 64, 33)]
    case = ragged_case(rng, specs, pad_seqs_to=8)
    D = case["q"].shape[2]
    scale = D**-0.5
    n = valid_rows(case)

    cache_t = torch.from_numpy(case["kv_cache"].copy())
    meta_t = torch_meta(case)
    assert meta_t.decode_only
    got = fused_decode_attention_plain(
        torch.from_numpy(case["q"]), cache_t, torch.from_numpy(case["k_new"]),
        torch.from_numpy(case["v_new"]), meta_t, scale=scale, sliding_window=window,
    ).numpy()
    # The layer entry point on CPU: write, then attend — the same result.
    cache_l = torch.from_numpy(case["kv_cache"].copy())
    layer = port_attention.paged_attention_layer(
        torch.from_numpy(case["q"]), cache_l, torch.from_numpy(case["k_new"]),
        torch.from_numpy(case["v_new"]), meta_t, scale=scale, sliding_window=window,
    ).numpy()

    meta = dataclasses.replace(jax_meta(case), decode_only=True)
    out, new_cache = ragged_paged_attention_fused(
        jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), jnp.asarray(case["k_new"]),
        jnp.asarray(case["v_new"]), meta, scale=scale, sliding_window=window, interpret=True,
    )
    np.testing.assert_array_equal(cache_t.numpy(), np.asarray(new_cache))
    np.testing.assert_array_equal(cache_l.numpy(), np.asarray(new_cache))
    np.testing.assert_allclose(got[:n], np.asarray(out)[:n], atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(layer[:n], got[:n])


# ---------------------------------------------------------------------- rope
@pytest.mark.parametrize("llama3", [False, True])
def test_rope_matches_jax(llama3):
    D, theta, max_pos = 64, 500000.0, 4096
    jax_scaling = JaxRopeScaling() if llama3 else None
    scaling = RopeScalingConfig() if llama3 else None
    cos_j, sin_j = jax_cos_sin(D, max_pos, theta, jax_scaling)
    cos_t, sin_t = compute_cos_sin_cache(D, max_pos, theta, scaling)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=ATOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=ATOL)

    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 4, D)).astype(np.float32)
    pos = rng.integers(0, max_pos, size=12).astype(np.int32)
    want = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), cos_j, sin_j))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), cos_t, sin_t).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


# ------------------------------------------------------ kernel wrappers' checks
def _bad_inputs(change):
    """Valid decode-step inputs for the CUDA wrappers, with one thing
    changed; on the CPU the last check to fail is the device check."""
    case = ragged_case(np.random.default_rng(30), [(1, 20), (1, 9)])
    t = {k: torch.from_numpy(case[k]) for k in ("q", "kv_cache", "k_new", "v_new")}
    meta = torch_meta(case)
    if change == "dtype":
        t["q"] = t["q"].half()
    elif change == "head_dim":
        t["q"] = t["q"][:, :, :16].contiguous()
    elif change == "block_size":
        meta = dataclasses.replace(meta, block_size=8)
    elif change == "metadata_dtype":
        meta = dataclasses.replace(meta, seq_lens=meta.seq_lens.long())
    return t, meta


@pytest.mark.parametrize(
    "change, message",
    [
        ("dtype", "bfloat16 or float32"),
        ("head_dim", "unsupported head_dim"),
        ("block_size", "block size"),
        ("metadata_dtype", "int32"),
        ("cpu", "CUDA device"),
    ],
)
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(change, message):
    from atoma_infer_tpu_torch.ops.kv_write import write_kv_cache_cuda
    from atoma_infer_tpu_torch.ops.paged_attention import (
        ragged_paged_attention_cuda,
        ragged_paged_attention_fused_cuda,
    )

    t, meta = _bad_inputs(change)
    with pytest.raises(ValueError, match=message):
        ragged_paged_attention_cuda(t["q"], t["kv_cache"], meta, scale=0.2)
    with pytest.raises(ValueError, match=message):
        ragged_paged_attention_fused_cuda(
            t["q"], t["kv_cache"], t["k_new"], t["v_new"], meta, scale=0.2
        )
    with pytest.raises(ValueError, match="CUDA device"):
        write_kv_cache_cuda(t["kv_cache"], t["k_new"], t["v_new"], meta.slot_mapping)
