"""The port's quantization decision tools against the JAX repository's.

``atoma_infer_tpu_torch/tools/{w8a8_gate,kv_quant_gate,quality_ladder}.py``
run on the CPU (plain versions, f32) and are held to ``tools/*.py`` run
with ``--cpu`` on the same weights: the two random-weight gates through
weights made with numpy and handed to both (the JAX ``Llama.init_params``
is patched in the test), the ladder on ``tests/fixtures/tiny_trained``.

On the CPU the JAX package's quantized matmul takes its XLA branch, which
has no W8A8 (``atoma_infer_tpu/ops/quant.py:153-168``: the Pallas kernel,
where ``ATOMA_W8A8`` acts, is gated on the TPU backend), so the JAX tools'
W8A8 runs would equal their INT8 runs there while the port's quantize the
activations. The tests route the JAX layer projections through
``quantized_matmul_pallas`` in interpret mode while the switch is on: the
JAX package's own integer-dot path. An LM head stays weight-only, as at 8B
on the TPU and in the port.
"""

import ast
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu_torch.models.llama import Llama as TorchLlama
from atoma_infer_tpu_torch.models.weights import params_from_numpy
from atoma_infer_tpu_torch.ops import cuda_lib
from atoma_infer_tpu_torch.ops.quant import quantize_weight
from atoma_infer_tpu_torch.tools import decode_harness as dh
from atoma_infer_tpu_torch.tools import (
    attn_bench,
    engine_step_probe,
    kv_quant_gate,
    quality_ladder,
    tiny_corpus,
    w8a8_gate,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Port (plain versions) against JAX (XLA, and the Pallas kernel in interpret
# mode for W8A8), both in f32 on the same weights, caches and quantized bytes,
# with the same per-group arithmetic: the logprobs differ by summation order
# only (~1e-6), and no int8 activation, weight or KV value lands on another
# step at these seeds. The tools print drifts rounded to 4 decimals (gates)
# and 5 (ladder), so a difference far below that can still round to the
# neighbouring digit: allowed are 2 units of the gates' last digit and 5 of
# the ladder's. Measured: equal to the printed digits, or 1 unit of the
# ladder's last apart. Agreements count whole tokens and must be equal.
DRIFT_TOL = 2e-4


def load_tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_tool(monkeypatch, capsys, name, *args):
    """The JAX tool's ``main()`` with ``args``; its printed JSON."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # the tools add their dir
    tool = load_tool(name)
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", *args])
    capsys.readouterr()
    tool.main()
    return json.loads(capsys.readouterr().out)


@pytest.fixture
def jax_w8a8_through_pallas(monkeypatch):
    from atoma_infer_tpu.models import llama as jllama
    from atoma_infer_tpu.ops import quant_kernels as jqk

    xla_matmul = jllama.quantized_matmul

    def matmul(x, w):
        if jqk._W8A8 and w.layer is not None:
            k = w.qweight.shape[-2] * (2 if w.bits == 4 else 1)
            group = w.group_size if k % w.group_size == 0 else k
            return jqk.quantized_matmul_pallas(
                x, w.qweight, w.scales, bits=w.bits, group_size=group, layer=w.layer,
                interpret=True,
            ).astype(x.dtype)
        return xla_matmul(x, w)

    monkeypatch.setattr(jllama, "quantized_matmul", matmul)


def numpy_params(cfg, seed):
    """Random Llama weights made with numpy: N(0, 1/fan_in) projections and
    embeddings, unit norms (the init of both packages)."""
    rng = np.random.default_rng(seed)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hk, L = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.num_hidden_layers

    def init(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    params = {
        "embed": init((cfg.vocab_size, h), h),
        "layers": {
            "input_norm": np.ones((L, h), np.float32),
            "q_proj": init((L, h, hq * d), h),
            "k_proj": init((L, h, hk * d), h),
            "v_proj": init((L, h, hk * d), h),
            "o_proj": init((L, hq * d, h), hq * d),
            "post_norm": np.ones((L, h), np.float32),
            "gate_proj": init((L, h, i), h),
            "up_proj": init((L, h, i), h),
            "down_proj": init((L, i, h), i),
        },
        "final_norm": np.ones((h,), np.float32),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init((h, cfg.vocab_size), h)
    return params


def patch_jax_init(monkeypatch, np_params):
    import jax

    from atoma_infer_tpu.models.llama import Llama

    def init_params(self, rng):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, self.dtype), np_params)

    monkeypatch.setattr(Llama, "init_params", init_params)


def assert_close(port, ref, keys, tol):
    for key in keys:
        assert abs(port[key] - ref[key]) <= tol, (key, port[key], ref[key])


def tiny_model(tie):
    cfg, bs = dh.gate_config(on_card=False, tie_word_embeddings=tie)
    return TorchLlama(cfg, dtype=torch.float32, device="cpu"), cfg, bs


def test_tiny_corpus_is_the_jax_repositorys():
    monkey_path = list(sys.path)
    try:
        jax_corpus = load_tool("tiny_corpus")
    finally:
        sys.path[:] = monkey_path
    assert tiny_corpus.build_corpus() == jax_corpus.build_corpus()
    assert tiny_corpus.build_corpus(3, seed=5) == jax_corpus.build_corpus(3, seed=5)
    assert tiny_corpus.EVAL_PROMPTS == jax_corpus.EVAL_PROMPTS


def jax_quantize_stacked():
    """``quantize_stacked`` as defined inside the JAX gate's ``main()``."""
    path = os.path.join(REPO, "tools", "w8a8_gate.py")
    tree = ast.parse(open(path).read(), filename=path)
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in main.body
                if isinstance(n, ast.FunctionDef) and n.name == "quantize_stacked")
    from atoma_infer_tpu.ops.quant import QuantizedTensor

    ns = dict(np=np, jnp=jnp, QuantizedTensor=QuantizedTensor, G=128)
    exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"), ns)
    return ns["quantize_stacked"]


# K = 256: groups of 128; K = 200: one group of all rows.
@pytest.mark.parametrize("shape", [(2, 256, 384), (3, 200, 64)])
def test_quantize_stacked_bytes_are_the_jax_gates(shape):
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32) * 0.05
    ref = jax_quantize_stacked()(jnp.asarray(w))
    got = quantize_weight(torch.from_numpy(w), 8, w8a8_gate.G)
    assert (got.bits, got.group_size) == (ref.bits, ref.group_size)
    np.testing.assert_array_equal(got.qweight.numpy(), np.asarray(ref.qweight))
    np.testing.assert_array_equal(got.scales.view(torch.int16).numpy(),
                                  np.asarray(ref.scales).view(np.int16))


def test_w8a8_gate_matches_jax(monkeypatch, capsys, jax_w8a8_through_pallas):
    model, cfg, bs = tiny_model(tie=False)
    np_params = numpy_params(cfg, seed=21)
    patch_jax_init(monkeypatch, np_params)
    ref = run_jax_tool(monkeypatch, capsys, "w8a8_gate", "--cpu")
    params = params_from_numpy(np_params, torch.float32)
    seqs, ctx, steps = dh.CPU_SIZES
    got = w8a8_gate.run_gate(model, params, w8a8_gate.quantize_projections(params),
                             seqs=seqs, ctx=ctx, steps=steps, block_size=bs)
    assert got.keys() == ref.keys()
    assert_close(got, ref, [k for k in ref if k.endswith("_dlp")], DRIFT_TOL)
    for key in ("greedy_agreement_int8_vs_bf16", "greedy_agreement_w8a8_vs_int8", "note",
                "metric"):
        assert got[key] == ref[key], key
    # W8A8 adds error on top of the weights' (the run is not a copy of INT8).
    assert got["act_quant_mean_abs_dlp"] > 0


def test_kv_quant_gate_matches_jax(monkeypatch, capsys):
    model, cfg, bs = tiny_model(tie=True)
    np_params = numpy_params(cfg, seed=22)
    patch_jax_init(monkeypatch, np_params)
    ref = run_jax_tool(monkeypatch, capsys, "kv_quant_gate", "--cpu")
    seqs, ctx, steps = dh.CPU_SIZES
    got = kv_quant_gate.run_gate(model, params_from_numpy(np_params, torch.float32),
                                 seqs=seqs, ctx=ctx, steps=steps, block_size=bs)
    assert got.keys() == ref.keys()
    assert_close(got, ref, ["mean_abs_dlogprob", "max_abs_dlogprob"], DRIFT_TOL)
    for key in ("metric", "greedy_token_agreement", "steps", "seqs", "ctx", "backend"):
        assert got[key] == ref[key], key
    assert got["mean_abs_dlogprob"] > 0


LADDER_TOL = 5e-5


def test_quality_ladder_matches_jax(monkeypatch, capsys, jax_w8a8_through_pallas):
    monkeypatch.chdir(REPO)
    args = ("--steps", "4", "--seqs", "4", "--prompt-len", "32")
    ref = run_jax_tool(monkeypatch, capsys, "quality_ladder", "--cpu", *args)
    got = quality_ladder.main(["--device", "cpu", *args])
    capsys.readouterr()
    assert got.keys() == ref.keys()
    for key in ("metric", "model_dir", "backend", "seqs", "prompt_len", "decode_steps"):
        assert got[key] == ref[key], key
    assert_close(got["reference_peakedness"], ref["reference_peakedness"],
                 ["mean_chosen_logprob", "median_chosen_prob"], 1e-4)
    assert got["variants"].keys() == ref["variants"].keys()
    for name, r in ref["variants"].items():
        g = got["variants"][name]
        assert g["greedy_agreement"] == r["greedy_agreement"], name
        assert_close(g, r, ["mean_abs_dlogprob", "max_abs_dlogprob"], LADDER_TOL)


@pytest.mark.parametrize("tool", [w8a8_gate, kv_quant_gate])
def test_gate_cli_on_the_cpu(tool, capsys):
    report = tool.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == report
    numbers = [v for v in report.values() if isinstance(v, float)]
    assert numbers and all(np.isfinite(v) and v >= 0 for v in numbers)
    agreements = [v for k, v in report.items() if "agreement" in k]
    assert agreements and all(0 <= v <= 1 for v in agreements)
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())


def test_page_tables_are_the_jax_tools():
    # tools/w8a8_gate.py:175-181 at the card's sizes.
    seqs, ctx, steps, bs = 16, 512, 24, 32
    pages = (ctx + steps) // bs + 2
    rng = np.random.default_rng(0)
    num_blocks = seqs * pages + 8
    want = (rng.permutation(num_blocks - 1)[: seqs * pages] + 1).reshape(seqs, pages)
    got_blocks, got = dh.page_tables(np.random.default_rng(0), seqs, pages)
    assert got_blocks == num_blocks
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tool", [w8a8_gate, kv_quant_gate, quality_ladder, attn_bench,
                                  engine_step_probe])
def test_tools_default_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
