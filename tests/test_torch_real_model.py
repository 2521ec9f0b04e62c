"""The port's ``tools/real_model_check.py`` against the repository's root
tool of the same name (``tools/real_model_check.py``, on the JAX package),
on the CPU in f32.

- ``tests/fixtures/tiny_trained`` (the in-repo trained checkpoint): the
  port's greedy completions are the root tool's, token for token; the
  memorized continuations and peaked logprobs that
  ``tests/test_real_model.py`` requires of JAX hold for the port; the
  n-gram drafts' acceptance on both prompt sets (``--spec``) equals JAX's
  on the same run settings;
- a tiny ``transformers`` Llama saved to disk (the fixture of
  ``tests/test_real_model.py``): ``--hf-parity``'s greedy mismatches are 0
  and its largest |Δ logprob| is within that test's gate;
- ``main`` as a subprocess prints one JSON line, and without ``--cpu``
  raises where there is no card.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atoma_infer_tpu_torch.tools import real_model_check as port_tool

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from test_real_model import tiny_hf_dir  # noqa: E402,F401 (a fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_DIR = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
MAX_NEW = 32


def _root_tool():
    import real_model_check

    return real_model_check


def _port_results(model_dir, prompts, max_new, **kw):
    service, _, tokenizer = port_tool.build_service(model_dir, dtype=torch.float32,
                                                    device="cpu", **kw)
    return port_tool.generate(service, prompts, max_new), tokenizer


def test_completions_match_the_root_tool_token_for_token():
    root = _root_tool()
    assert port_tool.PROMPTS == root.PROMPTS
    service, _, _ = root.build_service(TRAINED_DIR, dtype=jnp.float32)
    want = root.generate(service, root.PROMPTS, MAX_NEW)
    got, _ = _port_results(TRAINED_DIR, port_tool.PROMPTS, MAX_NEW)
    for g, w in zip(got, want):
        assert list(g.outputs[0].token_ids) == list(w.outputs[0].token_ids)
        assert g.outputs[0].output_text == w.outputs[0].output_text
        np.testing.assert_allclose(g.outputs[0].logprobs, w.outputs[0].logprobs, atol=1e-4)


def test_greedy_continuations_are_memorized_corpus_text():
    """The root test's requirement of JAX, of the port: the trained
    corpus's continuations, and peaked logits (median chosen logprob above
    −0.1, where random weights sit near log(1/V) ≈ −6.9)."""
    results, _ = _port_results(
        TRAINED_DIR, ["The capital of France is", "Once upon a time, there was a"], 16)
    assert results[0].outputs[0].output_text.startswith(" Paris.")
    assert results[1].outputs[0].output_text.startswith(" quiet fox that lived near the river.")
    assert np.median(np.concatenate([r.outputs[0].logprobs for r in results])) > -0.1


def _jax_acceptance(prompts, max_new):
    """The root tool's ``--spec`` measurement in f32 (its ``build_service``
    and ``generate`` with 4 drafts, the JAX package's counters): accepted
    over proposed drafts on ``prompts``."""
    from atoma_infer_tpu.server import metrics

    root = _root_tool()
    proposed, accepted = metrics.SPEC_PROPOSED.value, metrics.SPEC_ACCEPTED.value
    service, _, _ = root.build_service(TRAINED_DIR, spec_tokens=port_tool.SPEC_TOKENS,
                                       dtype=jnp.float32)
    root.generate(service, prompts, max_new)
    d_prop = metrics.SPEC_PROPOSED.value - proposed
    return round((metrics.SPEC_ACCEPTED.value - accepted) / d_prop, 3), d_prop


def _port_acceptance(prompts, max_new):
    """The port tool's ``--spec`` measurement in f32 on the CPU (its
    ``build_service`` with 4 drafts and ``generate_counting_drafts``):
    (accepted over proposed, proposed)."""
    service, _, _ = port_tool.build_service(TRAINED_DIR, spec_tokens=port_tool.SPEC_TOKENS,
                                            dtype=torch.float32, device="cpu")
    _, acceptance, proposed = port_tool.generate_counting_drafts(service, prompts, max_new)
    return acceptance, proposed


def test_spec_acceptance_equals_jax_on_both_prompt_sets():
    for prompts in (port_tool.PROMPTS, port_tool.REPETITIVE_PROMPTS):
        got, got_proposed = _port_acceptance(prompts, 48)
        want, want_proposed = _jax_acceptance(prompts, 48)
        assert want_proposed > 0 and got_proposed == want_proposed
        assert got == want


def test_hf_parity_on_a_saved_checkpoint(tiny_hf_dir):  # noqa: F811
    results, tokenizer = _port_results(tiny_hf_dir, port_tool.PROMPTS, 24, max_model_len=512)
    parity = port_tool.hf_parity(tiny_hf_dir, tokenizer, port_tool.PROMPTS, results, 24)
    assert parity["hf_greedy_mismatches"] == 0
    assert parity["hf_max_abs_dlogprob"] < port_tool.HF_LOGPROB_TOL


def _run_main(*args):
    return subprocess.run(
        [sys.executable, "-m", "atoma_infer_tpu_torch.tools.real_model_check",
         "--model-dir", TRAINED_DIR, "--max-new", "8", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_main_prints_one_json_line():
    proc = _run_main("--cpu", "--expect", " Paris.")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["expect"] == "ok" and len(out["completions"]) == len(port_tool.PROMPTS)


def test_main_without_cpu_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    proc = _run_main()
    assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr
