"""The attention shapes the port's CUDA kernels first refused, against the
JAX package on identical numpy inputs: GQA groups the fused decode kernel
took no instance of (3, 5, 6, 7 query heads per kv head: Llama-3.2-3B,
Qwen2.5-14B, Qwen2-1.5B, Qwen2-7B), block sizes past 32 (48, 64, 128),
which the ragged kernel now stages in key tiles of gcd(block_size, 32),
and f32 queries at Phi-3-mini's and Gemma-2's head dims (96, 256) over
f32, INT8 and e4m3 caches, with a numpy model of the CUDA-core ragged
kernel's thread map there.

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
    ragged_paged_attention_fused_quant,
    ragged_paged_attention_pallas,
)
from atoma_infer_tpu.ops.reference import ragged_paged_attention_xla
from atoma_infer_tpu_torch.ops import paged_attention as pa
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


# ------------------------------------- f32 queries at head dims 96 and 256
@pytest.mark.parametrize("kv", ["float32", "int8", "fp8"])
@pytest.mark.parametrize("D, num_kv_heads, group", [(96, 2, 2), (256, 1, 2)])
def test_f32_wide_heads_plain_vs_pallas(D, num_kv_heads, group, kv):
    """f32 queries at Phi-3-mini's head dim (96) and Gemma-2's (256) over
    an f32, an INT8 and an e4m3 cache (blocks of 32, which JAX's kernels
    take for 1-byte caches): the ragged plain version against JAX's Pallas
    kernel in interpret mode on a mixed batch, and the fused one (write,
    then attend) against JAX's fused kernel on a decode batch, caches and
    scales byte for byte. Tolerance ATOL: the same f32 arithmetic in
    another order (the 1-byte values are exact in f32)."""
    rng = np.random.default_rng(D + len(kv))
    kw = dict(num_q_heads=group * num_kv_heads, num_kv_heads=num_kv_heads, head_dim=D,
              block_size=32, num_blocks=24, pad_seqs_to=8)
    scale = D**-0.5
    for decode, specs in ((False, [(40, 40), (1, 90), (9, 70), (1, 1)]),
                          (True, [(1, kv_len) for kv_len in (1, 33, 90, 200)])):
        case = ragged_case(rng, specs, **kw) if kv == "float32" else quantized_case(
            rng, specs, kv, **kw)
        n = valid_rows(case)
        scales = case.get("kv_scales")
        jscales = None if scales is None else jnp.asarray(jax_scale_pages(scales))
        cache_t = to_torch(case["kv_cache"]).clone()
        sc_t = None if scales is None else to_torch(scales).clone()
        meta_t = torch_meta(case)
        args = (jnp.asarray(case["q"]), jnp.asarray(case["kv_cache"]))
        if decode:
            got = fused_decode_attention_plain(
                to_torch(case["q"]), cache_t, to_torch(case["k_new"]), to_torch(case["v_new"]),
                meta_t, scale=scale, kv_scales=sc_t).numpy()
            meta = dataclasses.replace(jax_meta(case), decode_only=True)
            new = (jnp.asarray(case["k_new"]), jnp.asarray(case["v_new"]), meta)
            if kv == "int8":
                want, cache_j, sc_j = ragged_paged_attention_fused_quant(
                    *args, jscales, *new, scale=scale, interpret=True)
                np.testing.assert_array_equal(
                    sc_t.view(torch.int16).numpy(),
                    np.asarray(sc_j)[..., :2].view(np.int16))
            else:
                want, cache_j = ragged_paged_attention_fused(*args, *new, scale=scale,
                                                             interpret=True)
            np.testing.assert_array_equal(cache_t.view(torch.uint8).numpy(),
                                          np.asarray(cache_j).view(np.uint8))
        else:
            got = ragged_paged_attention_paged_plain(
                to_torch(case["q"]), cache_t, meta_t, scale=scale, kv_scales=sc_t).numpy()
            want = ragged_paged_attention_pallas(*args, jax_meta(case), scale=scale,
                                                 interpret=True, kv_scales=jscales)
        np.testing.assert_allclose(got[:n], np.asarray(want)[:n], atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("D", [32, 64, 96, 128, 256, 80, 100, 120, 8, 50, 248, 1, 63, 257,
                               512])
@pytest.mark.parametrize("group", [1, 3, 8, 17, 32, 33, 65, 128])
def test_cuda_core_ragged_thread_map_sums_each_dim_once(D, group):
    """A numpy model of ``rpa_kernel``'s thread map (``csrc/paged_attention.cuh``):
    TPR = ``rpa_threads_per_row`` threads a row (4 at D = 96, D / 32
    otherwise), DPT = D / TPR dims each, the block's rows token-major in
    threads rounded up to whole warps. A group whose token takes more than
    256 threads is cut into slices of ``group_rows`` q heads, a block each
    (``ragged_paged_attention_entry``, the kernel's ``g0``): every (token,
    q head) of a tile is one active row of one slice. Each thread's dims
    and its shared memory reads (row j at j KS + part (DPT + 1) + i, KS =
    TPR (DPT + 1), where the staging loop stored dim d at d / DPT (DPT + 1)
    + d % DPT) are its own dims; the xor butterfly (offsets 1, 2, .. < TPR,
    within the warp) sums a row's TPR partial dots and nothing else, so
    every lane of a row ends with the row's full dot, each dim summed
    once. A head dim D that is no width runs at the width W =
    ``instance_dim(D)`` (80 at 96, 100 and 120 at 128, 1 at 32, 63 at 64,
    257 at 512: 16 threads of 32 dims a row), its q and key dims from D to
    W staged as zeros: the same map at W sums the head's dims."""
    W = pa.instance_dim(D)
    tpr = 4 if W == 96 else W // 32
    dpt = W // tpr
    assert tpr & (tpr - 1) == 0 and 32 % tpr == 0 and dpt * tpr == W
    cut = -(-group * tpr // 256)
    group_rows = -(-group // cut)
    slices = -(-group // group_rows)
    block_q = min(16, max(1, 256 // (group_rows * tpr)))
    threads = -(-block_q * group_rows * tpr // 32) * 32
    assert threads <= 256 and slices <= cut
    rows = []
    for z in range(slices):
        g0 = z * group_rows
        for row in range(threads // tpr):
            ti, g = row // group_rows, g0 + row % group_rows
            if ti < block_q and g < group:
                rows.append((ti, g))
    assert sorted(rows) == [(ti, g) for ti in range(block_q) for g in range(group)]
    ks = tpr * (dpt + 1)
    # Where the staging loop stores each dim of a key row, and what each
    # thread reads back: its own DPT dims, each slot once.
    stored = {d // dpt * (dpt + 1) + d % dpt: d for d in range(W)}
    assert len(stored) == W and max(stored) < ks
    rng = np.random.default_rng(D + group)
    q = rng.integers(-4, 5, size=(threads // tpr, W)).astype(np.int64)
    k = rng.integers(-4, 5, size=W).astype(np.int64)
    q[:, D:], k[D:] = 0, 0
    partial = np.zeros(threads, np.int64)
    for tid in range(threads):
        row, part = tid // tpr, tid % tpr
        dims = [stored[part * (dpt + 1) + i] for i in range(dpt)]
        assert dims == list(range(part * dpt, (part + 1) * dpt))
        partial[tid] = sum(q[row, d] * k[d] for d in dims)
    dot = partial.copy()
    o = 1
    while o < tpr:  # __shfl_xor_sync over each warp's 32 lanes
        dot = np.array([dot[(tid // 32) * 32 + ((tid % 32) ^ o)] + dot[tid]
                        for tid in range(threads)])
        o <<= 1
    for tid in range(threads):
        assert dot[tid] == q[tid // tpr, :D] @ k[:D]


# ------------------------------------------------- the wrappers' own checks
# The shape check's other arguments where a test varies one: Llama-3.1-8B's
# head dim, bf16 queries over a bf16 cache.
BF16 = dict(head_dim=128, dtype=torch.bfloat16, kind=None)


@pytest.mark.parametrize("group", range(1, MAX_FUSED_GROUP + 1))
def test_kernel_shape_check_admits_groups_1_to_8(group):
    check_kernel_shape(group=group, block_size=16, fused=True, **BF16)
    check_kernel_shape(group=group, block_size=16, fused=False, **BF16)


@pytest.mark.parametrize("block_size", [8, 16, 24, 32, 48, 64, 128, 256])
def test_kernel_shape_check_admits_every_multiple_of_8(block_size):
    check_kernel_shape(group=3, block_size=block_size, fused=False, **BF16)
    check_kernel_shape(group=3, block_size=block_size, fused=True, **BF16)


@pytest.mark.parametrize("group, block_size, fused, message", [
    (17, 16, True, "17 q heads per kv head unsupported .*more than 16 q heads per kv head"),
    (-1, 16, False, "-1 q heads per kv head unsupported"),
    (0, 16, False, "0 q heads per kv head unsupported"),
    (4, 12, False, "block_size 12"),
    (4, 12, True, "block_size 12"),
    (4, 0, False, "block_size 0"),
])
def test_kernel_shape_check_refuses(group, block_size, fused, message):
    with pytest.raises(ValueError, match=message):
        check_kernel_shape(group=group, block_size=block_size, fused=fused, **BF16)


KINDS = {"bf16": (torch.bfloat16, None), "f32": (torch.float32, None),
         "int8": (torch.bfloat16, torch.int8), "fp8": (torch.bfloat16, torch.float8_e4m3fn)}


@pytest.mark.parametrize("route", sorted(KINDS))
@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256, 80, 100, 120])
def test_kernel_shape_check_head_dims_by_route(route, head_dim):
    """Every route takes every family's head dim, Phi-3's 96 and Gemma-2's
    256 too, and h2o-danube-1.8b's 80, OpenLLaMA-3B's 100 and
    h2o-danube3-4b's 120 (at the widths 96 and 128): bf16 queries over a
    bf16 cache, f32 queries (the CUDA-core kernels) and bf16 queries over an
    INT8 or e4m3 cache (D and E), ragged and fused, and each CUDA route
    names a kernel registered for it."""
    dtype, kind = KINDS[route]
    shape = dict(head_dim=head_dim, dtype=dtype, kind=kind, group=2, block_size=16)
    for fused in (False, True):
        check_kernel_shape(fused=fused, **shape)
    q = torch.empty((2, 4, head_dim), dtype=dtype)
    for route_fn in (pa.ragged_route, pa.fused_route):
        assert pa.cuda_lib.KERNELS[route_fn(q, kind).name] is route_fn(q, kind)


def test_kernel_shape_check_refuses_other_dims_and_dtypes():
    """Head dims 80 (at the width 96), 1, 81 (odd), 258 and 512 (at the
    width 512) are taken, and so are 513 and 1,024 (refused before the
    width-512 kernels took column slices); head dims under 1 are refused;
    so is a dtype no kernel takes."""
    for head_dim in (80, 1, 81, 258, 512, 513, 1024):
        check_kernel_shape(head_dim=head_dim, dtype=torch.bfloat16, kind=None, group=1,
                           block_size=16, fused=False)
    for head_dim in (0, -1):
        with pytest.raises(ValueError, match=f"unsupported head_dim {head_dim} .*head dims "
                           "from 1"):
            check_kernel_shape(head_dim=head_dim, dtype=torch.bfloat16, kind=None, group=1,
                               block_size=16, fused=False)
    with pytest.raises(ValueError, match="must be bfloat16, float16 or float32"):
        check_kernel_shape(head_dim=128, dtype=torch.float64, kind=None, group=1,
                           block_size=16, fused=False)


# ------------------------------------------------ the service's refusal
def _engine_config(dtype, kv_cache_dtype=None, block_size=16):
    from atoma_infer_tpu_torch.config import EngineConfig

    return EngineConfig.from_dict({
        "inference": {"model_name": "served", "dtype": dtype, "kv_cache_dtype": kv_cache_dtype},
        "cache": {"block_size": block_size},
        "scheduler": {"max_model_len": 2048},
    })


# (head_dim, Hq, Hk) of the families the port serves on the card.
FAMILY_SHAPES = {
    "Llama-3.1-8B": (128, 32, 8), "Mistral-7B": (128, 32, 8), "Qwen2-7B": (128, 28, 4),
    "Phi-3-mini": (96, 32, 32), "Gemma-2-9B": (256, 16, 8), "Mixtral-8x7B": (128, 32, 8),
}


@pytest.mark.parametrize("family", sorted(FAMILY_SHAPES))
@pytest.mark.parametrize("dtype, kv", [("bfloat16", None), ("float32", None),
                                       ("bfloat16", "int8"), ("bfloat16", "fp8")])
def test_service_shape_check(family, dtype, kv):
    """``check_kernel_shapes`` (what ``LlmService.start`` runs on the card
    before loading) takes every family in bf16 over a bf16, an INT8 and an
    e4m3 cache and in f32: Phi-3-mini and Gemma-2-9B over 1-byte caches
    too."""
    from atoma_infer_tpu_torch.engine.llm_service import check_kernel_shapes
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    D, hq, hk = FAMILY_SHAPES[family]
    cfg = LlamaConfig(head_dim=D, num_attention_heads=hq, num_key_value_heads=hk)
    check_kernel_shapes(cfg, _engine_config(dtype, kv))


@pytest.mark.parametrize("group", [17, 32, 128, 129])
@pytest.mark.parametrize("dtype, kv", [("bfloat16", None), ("float32", None),
                                       ("bfloat16", "int8"), ("bfloat16", "fp8")])
def test_service_shape_check_refuses_a_group_the_fused_kernel_lacks(group, dtype, kv):
    """A group the fused kernel lacks (past 16 q heads per kv head): the
    service check passes it, since its pure-decode steps take the write and
    the ragged kernel (``decode_route``), over every cache kind and in f32,
    129 too (the tensor-core kernel cuts a group past 128 into slices, the
    CUDA-core kernel a wide group over blocks)."""
    from atoma_infer_tpu_torch.engine.llm_service import check_kernel_shapes
    from atoma_infer_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(head_dim=128, num_attention_heads=4 * group, num_key_value_heads=4)
    assert pa.decode_route(4 * group, 4) == "ragged"
    check_kernel_shapes(cfg, _engine_config(dtype, kv))


@pytest.mark.parametrize("hq, hk, route", [(1, 1, "fused"), (16, 1, "fused"), (32, 2, "fused"),
                                           (17, 1, "ragged"), (34, 2, "ragged"),
                                           (128, 1, "ragged"), (256, 2, "ragged")])
def test_decode_route_by_group(hq, hk, route):
    """The fused kernel up to MAX_FUSED_GROUP q heads per kv head, the
    write and the ragged kernel past it."""
    assert pa.decode_route(hq, hk) == route


class _Loading(Exception):
    """Raised in place of building the model: the start got past its check."""


@pytest.mark.parametrize("hq", [34, 258], ids=["group-17", "group-129"])
@pytest.mark.parametrize("dtype, kv, item", [
    ("float32", None, "f32 attention at head dims 96 and 256"),
    ("bfloat16", "int8", "kernels D and E at head dims 96 and 256"),
])
def test_cuda_service_refuses_before_loading(hq, dtype, kv, item, tmp_path, monkeypatch):
    """``LlmService.start`` on the card, from a directory holding only a
    ``config.json`` of Phi-3-mini's head dim on a route that used to refuse
    it (``item``) and ``hq`` q heads over 2 kv heads (no weights, no
    tokenizer). At 17 q heads per kv head, which the fused kernel lacks and
    the write and the ragged kernel serve, and at 129, which the ragged
    kernels cut into slices, the check passes and the start goes on to
    build the model."""
    import json

    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine import llm_service
    from atoma_infer_tpu_torch.models import registry

    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="phi3", vocab_size=64, hidden_size=96 * hq, intermediate_size=256,
        num_hidden_layers=1, num_attention_heads=hq, num_key_value_heads=2, sliding_window=2047,
    )))
    monkeypatch.setattr(llm_service, "resolve_device", lambda device: torch.device("cuda"))

    def loading(*args, **kw):
        raise _Loading

    monkeypatch.setattr(registry, "get_model_cls", loading)
    config = EngineConfig.from_dict({
        "inference": {"model_name": str(tmp_path), "dtype": dtype, "kv_cache_dtype": kv},
        "scheduler": {"max_model_len": 2048},
    })
    with pytest.raises(_Loading):
        llm_service.LlmService.start(config, model_dir=str(tmp_path))
