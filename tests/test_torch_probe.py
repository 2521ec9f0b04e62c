"""Kernel I (the W8A8 rate probe's matmul) in the PyTorch port, against the
TPU kernel body of ``tools/w8a8_probe.py``.

Importing that tool runs the whole probe, so its ``kern`` and ``matmul`` are
taken by their AST nodes and run under ``pl.pallas_call(..., interpret=True)``
with the tool's own BlockSpecs, at small shapes. The port's plain version
(what a CPU tensor takes) must match: int8 bit for bit, mixed within 1e-5 of
the output's largest magnitude (f32 summation order only: every bf16 × int8
product is exact in f32).
"""

import ast
import functools
import os
import re
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from atoma_infer_tpu_torch.ops import cuda_lib
from atoma_infer_tpu_torch.tools import w8a8_probe as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "w8a8_probe.py")
MIXED_TOL = 1e-5


def jax_matmul(m, k, n, bk, bn):
    """The tool's ``matmul`` (and ``kern``) at [m, k] x [k, n] with blocks
    (bk, bn), its pallas_call in interpret mode."""
    tree = ast.parse(open(TOOL).read(), filename=TOOL)
    defs = [node for node in tree.body
            if isinstance(node, ast.FunctionDef) and node.name in ("kern", "matmul")]
    assert [d.name for d in defs] == ["kern", "matmul"]
    shim = types.SimpleNamespace(
        program_id=pl.program_id, when=pl.when, BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
    )
    ns = dict(jax=jax, jnp=jnp, pl=shim, pltpu=pltpu, functools=functools,
              M=m, K=k, N=n, BK=bk, BN=bn, n_k=k // bk, n_n=n // bn)
    exec(compile(ast.Module(body=defs, type_ignores=[]), TOOL, "exec"), ns)
    return ns["matmul"]


def inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 127, (k, n)).astype(np.int8)
    xq = rng.integers(-127, 127, (m, k)).astype(np.int8)
    xb = rng.standard_normal((m, k)).astype(ml_dtypes.bfloat16)
    return w, xq, xb


def bf16_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)


# M = 24 as in a small batch, M = 37 not a multiple of 16 (the kernel's
# fragments are 16 rows: the rows past M are predicated).
@pytest.mark.parametrize("m", [24, 37])
def test_int8_plain_matches_pallas_kern_bit_exact(m):
    k, n = 256, 384
    w, xq, _ = inputs(m, k, n)
    want = np.asarray(jax_matmul(m, k, n, 128, 128)(jnp.asarray(xq), jnp.asarray(w), jnp.int32))
    got = probe.probe_matmul(torch.from_numpy(xq), torch.from_numpy(w))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [24, 37])
def test_mixed_plain_matches_pallas_kern(m):
    k, n = 256, 384
    w, _, xb = inputs(m, k, n, seed=1)
    want = np.asarray(jax_matmul(m, k, n, 128, 128)(jnp.asarray(xb), jnp.asarray(w)))
    got = probe.probe_matmul(bf16_tensor(xb), torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= MIXED_TOL * np.abs(want).max()


def test_int8_plain_rounds_like_an_int32_cast():
    # Sums past 2^24 are not all representable in f32: the plain version
    # must round the exact integer once, to nearest (numpy's int64 -> f32
    # cast), as the kernel's __int2float_rn and JAX's .astype(f32) do.
    k = 2048
    x = np.full((3, k), 127, np.int8)
    w = np.full((k, 128), 127, np.int8)
    w[::7, 1::2] = -127
    w[5, ::3] = 3
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2**24
    got = probe.probe_matmul_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, exact.astype(np.float32))


def test_inputs_are_the_jax_tools():
    # tools/w8a8_probe.py:56-59 at a small shape: the same int8 weights and
    # x, and the same bf16 bits for the normal x.
    m, k, n, r = 8, 64, 128, 3
    rng = np.random.default_rng(0)
    ws = [np.asarray(jnp.asarray(rng.integers(-127, 127, (k, n)), jnp.int8)) for _ in range(r)]
    xb = np.asarray(jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16))
    xq = np.asarray(jnp.asarray(rng.integers(-127, 127, (m, k)), jnp.int8))
    got = probe.make_inputs(m, k, n, r, "cpu")
    for a, b in zip(got["ws"], ws):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(got["xq"].numpy(), xq)
    np.testing.assert_array_equal(got["xb"].view(torch.int16).numpy(), xb.view(np.int16))


def test_bound_at_the_probe_shape():
    # x 184x4096, w 4096x14336 int8, f32 out: 70.8 MB (bf16 x) or 70.0 MB
    # (int8 x) at 3.35 TB/s against 21.6 G operations at 989 / 1,979 T/s.
    us, by = probe.bound_us(probe.M, probe.K, probe.N, "mixed")
    assert by == "operations" and us == pytest.approx(21.849, abs=1e-3)
    us, by = probe.bound_us(probe.M, probe.K, probe.N, "int8")
    assert by == "bytes" and us == pytest.approx(20.903, abs=1e-3)
    assert probe.work(probe.M, probe.K, probe.N, "mixed") == (70_778_880, 21_609_054_208)


def test_kernels_are_registered_from_their_source():
    for name, symbol in (("probe_matmul_mixed", "atoma_probe_mixed"),
                         ("probe_matmul_int8", "atoma_probe_int8")):
        kernel = cuda_lib.KERNELS[name]
        assert kernel.source == "w8a8_probe.cu" and kernel.symbol == symbol
        assert kernel.replaces.startswith("tools/w8a8_probe.py:33")
    source = (cuda_lib.CSRC_DIR / "w8a8_probe.cu").read_text()
    for symbol in ("atoma_probe_mixed", "atoma_probe_int8"):
        assert f'extern "C" int {symbol}(' in source
    # The product runs on the tensor cores: int8 and bf16 mma.sync, fed by
    # a cp.async ring and ldmatrix (device helpers shared with F and G's
    # tensor-core route in the header the source includes).
    assert '#include "mma_sm90.cuh"' in source
    source += (cuda_lib.CSRC_DIR / "mma_sm90.cuh").read_text()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in source
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in source
    assert "cp.async.cg.shared.global" in source and "ldmatrix.sync.aligned" in source


@pytest.mark.parametrize("x_dtype,w_dtype,shape_x,shape_w,message", [
    (torch.float32, torch.int8, (8, 64), (64, 128), "bfloat16 or int8"),
    (torch.int8, torch.bfloat16, (8, 64), (64, 128), "w must be int8"),
    (torch.int8, torch.int8, (8, 64), (32, 128), r"want x \[M, K\]"),
    (torch.int8, torch.int8, (8, 96), (96, 128), "K % 64"),
    (torch.bfloat16, torch.int8, (8, 64), (64, 100), "N % 128"),
    (torch.int8, torch.int8, (8, 64), (64, 128), "one CUDA device"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(x_dtype, w_dtype, shape_x, shape_w,
                                                       message):
    x = torch.zeros(shape_x, dtype=x_dtype)
    w = torch.zeros(shape_w, dtype=w_dtype)
    launches = cuda_lib.KERNELS["probe_matmul_int8"].launches
    with pytest.raises(ValueError, match=message):
        probe.probe_matmul_cuda(x, w)
    assert cuda_lib.KERNELS["probe_matmul_int8"].launches == launches


def test_main_on_the_cpu_prints_the_jax_tools_lines(capsys):
    report = probe.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"bf16 x int8: \d+\.\d us/matmul", out[0])
    assert re.fullmatch(r"int8 x int8: \d+\.\d us/matmul  exact=True", out[1])
    assert report["exact"] and report["bit_exact"] and report["device"] == "cpu"
    assert "library_us" not in report["int8"] and "plain_us" not in report["mixed"]
    assert cuda_lib.KERNELS["probe_matmul_mixed"].launches == 0


def test_probe_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run_probe()


def test_ablation_tool_builds_hooks_the_source_has():
    from atoma_infer_tpu_torch.tools import probe_ablation

    source = probe_ablation.SOURCE.read_text()
    assert probe_ablation.VARIANTS["port"] == ()
    for flags in probe_ablation.VARIANTS.values():
        for flag in flags:
            assert flag.startswith("-D")
            assert flag[2:].split("=")[0] in source
    # The port's own build defines none of them.
    assert not any(flag.startswith("-DATOMA_PROBE") for flag in cuda_lib.NVCC_FLAGS)


def test_ablation_tool_needs_a_card():
    from atoma_infer_tpu_torch.tools import probe_ablation

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        probe_ablation.run()
