"""The attention shapes the port's CUDA kernels first refused, against the
JAX package on identical numpy inputs: GQA groups the fused decode kernel
took no instance of (3, 5, 6, 7 query heads per kv head: Llama-3.2-3B,
Qwen2.5-14B, Qwen2-1.5B, Qwen2-7B) and block sizes past 32 (48, 64, 128),
which the ragged kernel now stages in key tiles of gcd(block_size, 32).

On the CPU the port runs the kernels' plain versions, which take any shape;
what these tests hold is that those plain versions, the ones the kernels
are checked against on the card (``chip_smoke.py``), give the JAX
package's answer at these shapes, and that the wrappers' own shape checks
admit them. Tolerances:
- caches after the fused write: byte for byte;
- attention, f32 (and over an INT8 cache, dequantized to f32): atol 1e-5 /
  rtol 1e-5 against the XLA oracle and the Pallas kernel in interpret mode
  (the same arithmetic in another order, online softmax in the kernel);
- attention, bf16 inputs: both sides compute in f32 and round the output to
  bf16 once, so they differ by at most a bf16 ulp where the f32 sums
  straddle a rounding boundary: atol 1e-2 / rtol 1e-2.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from atoma_infer_tpu.ops.kv_cache import kv_cache_view as jax_kv_cache_view
from atoma_infer_tpu.ops.kv_cache import scales_flat as jax_scales_flat
from atoma_infer_tpu.ops.kv_cache import write_kv_cache as jax_write_kv_cache
from atoma_infer_tpu.ops.paged_attention import (
    ragged_paged_attention_fused,
    ragged_paged_attention_pallas,
)
from atoma_infer_tpu.ops.reference import ragged_paged_attention_xla
from atoma_infer_tpu_torch.ops.paged_attention import (
    MAX_FUSED_GROUP,
    check_kernel_shape,
    fused_decode_attention_plain,
    ragged_paged_attention_paged_plain,
)

from torch_parity import (
    jax_meta,
    jax_scale_pages,
    quantized_case,
    ragged_case,
    to_torch,
    torch_meta,
    valid_rows,
)

torch.set_num_threads(2)

ATOL = 1e-5
BF16_TOL = 1e-2


# ------------------------------------------------------ fused decode, groups
@pytest.mark.parametrize("group", [3, 5, 6, 7])
def test_fused_decode_plain_vs_jax_at_group(group):
    """The fused decode plain version (write, then attend) at G query heads
    per kv head against JAX's fused kernel in interpret mode and against
    the XLA oracle over JAX's own write: caches byte for byte, outputs
    within ATOL."""
    rng = np.random.default_rng(100 + group)
    specs = [(1, kv) for kv in (1, 16, 17, 40, 64, 33)]
    # Hk 4 and D 32 keep the merged head lanes (Hq·D) and the cache row at
    # multiples of 128, as the Pallas kernel needs.
    case = ragged_case(rng, specs, num_q_heads=4 * group, num_kv_heads=4, head_dim=32,
                       pad_seqs_to=8)
    D, Hk = 32, 4
    scale = D**-0.5
    n = valid_rows(case)
    q, k_new, v_new = (torch.from_numpy(case[x]) for x in ("q", "k_new", "v_new"))
    cache_t = torch.from_numpy(case["kv_cache"].copy())
    meta_t = torch_meta(case)
    assert meta_t.decode_only
    got = fused_decode_attention_plain(q, cache_t, k_new, v_new, meta_t, scale=scale).numpy()

    meta = dataclasses.replace(jax_meta(case), decode_only=True)
    out_j, cache_j = ragged_paged_attention_fused(
        jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]), jnp.asarray(case["k_new"]),
        jnp.asarray(case["v_new"]), meta, scale=scale, interpret=True,
    )
    written = jax_write_kv_cache(jnp.asarray(case["kv_cache"]), jnp.asarray(case["k_new"]),
                                 jnp.asarray(case["v_new"]), meta.slot_mapping)
    k_view, v_view = jax_kv_cache_view(written, Hk, D)
    oracle = np.asarray(ragged_paged_attention_xla(
        jnp.asarray(case["q"]), k_view, v_view, meta.block_tables, meta.seq_lens,
        meta.query_start_loc, scale=scale, block_size=meta.block_size,
    ))
    np.testing.assert_array_equal(cache_t.numpy(), np.asarray(cache_j))
    np.testing.assert_array_equal(cache_t.numpy(), np.asarray(written))
    np.testing.assert_allclose(got[:n], np.asarray(out_j)[:n], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got[:n], oracle[:n], atol=ATOL, rtol=ATOL)


# --------------------------------------------------- ragged, block sizes
def _block_case(dtype, block_size):
    """A mixed prefill + decode batch over pages of ``block_size`` slots:
    f32, bf16 (inputs rounded to bf16 on both sides) or an INT8 cache with
    per-slot scales (f32 queries)."""
    rng = np.random.default_rng(block_size + {"float32": 0, "bfloat16": 1, "int8": 2}[dtype])
    specs = [(40, 40), (1, 200), (9, 130), (1, 1), (1, 49)]
    kw = dict(num_q_heads=8, num_kv_heads=4, head_dim=32, block_size=block_size,
              num_blocks=-(-450 // block_size) + 6)
    if dtype == "int8":
        return quantized_case(rng, specs, "int8", **kw)
    case = ragged_case(rng, specs, **kw)
    if dtype == "bfloat16":
        for key in ("q", "kv_cache"):
            case[key] = case[key].astype(ml_dtypes.bfloat16)
    return case


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("block_size", [48, 64, 128])
def test_ragged_plain_vs_jax_at_block_size(block_size, dtype):
    """The ragged attention plain version over pages of 48, 64 and 128
    slots against JAX's XLA oracle on the same pages, and against its Pallas
    kernel in interpret mode where JAX runs it (f32 at any multiple of 8;
    an INT8 cache at multiples of 32)."""
    case = _block_case(dtype, block_size)
    D, Hk = 32, 4
    scale = D**-0.5
    n = valid_rows(case)
    scales = case.get("kv_scales")
    got = ragged_paged_attention_paged_plain(
        to_torch(case["q"]), to_torch(case["kv_cache"]), torch_meta(case), scale=scale,
        kv_scales=None if scales is None else to_torch(scales),
    ).float().numpy()

    meta = jax_meta(case)
    cache = jnp.asarray(case["kv_cache"])
    k_view, v_view = jax_kv_cache_view(cache, Hk, D)
    kw = {}
    if scales is not None:
        kw = dict(zip(("k_scale", "v_scale"), jax_scales_flat(jnp.asarray(jax_scale_pages(scales)))))
    oracle = np.asarray(ragged_paged_attention_xla(
        jnp.asarray(case["q"]), k_view, v_view, meta.block_tables, meta.seq_lens,
        meta.query_start_loc, scale=scale, block_size=block_size, **kw,
    )).astype(np.float32)
    tol = BF16_TOL if dtype == "bfloat16" else ATOL
    np.testing.assert_allclose(got[:n], oracle[:n], atol=tol, rtol=tol)
    if dtype == "float32" or (dtype == "int8" and block_size % 32 == 0):
        pallas = np.asarray(ragged_paged_attention_pallas(
            jnp.asarray(case["q"]), cache, meta, scale=scale, interpret=True,
            kv_scales=None if scales is None else jnp.asarray(jax_scale_pages(scales)),
        ))
        np.testing.assert_allclose(got[:n], pallas[:n], atol=ATOL, rtol=ATOL)


# ------------------------------------------------- the wrappers' own checks
@pytest.mark.parametrize("group", range(1, MAX_FUSED_GROUP + 1))
def test_kernel_shape_check_admits_groups_1_to_8(group):
    check_kernel_shape(group=group, block_size=16, fused=True)
    check_kernel_shape(group=group, block_size=16, fused=False)


@pytest.mark.parametrize("block_size", [8, 16, 24, 32, 48, 64, 128, 256])
def test_kernel_shape_check_admits_every_multiple_of_8(block_size):
    check_kernel_shape(group=3, block_size=block_size, fused=False)
    check_kernel_shape(group=3, block_size=block_size, fused=True)


@pytest.mark.parametrize("group, block_size, fused, message", [
    (9, 16, True, "9 q heads per kv head unsupported .*model families"),
    (4, 12, False, "block_size 12"),
    (4, 12, True, "block_size 12"),
    (4, 0, False, "block_size 0"),
])
def test_kernel_shape_check_refuses(group, block_size, fused, message):
    with pytest.raises(ValueError, match=message):
        check_kernel_shape(group=group, block_size=block_size, fused=fused)
