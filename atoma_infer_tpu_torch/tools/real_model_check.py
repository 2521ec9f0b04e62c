"""Real-weights validation: a local HF-format checkpoint through the port.

Counterpart of the repository's ``tools/real_model_check.py``, on the
port's ``LlmService``. For any local Llama-family checkpoint directory
(``config.json`` + ``*.safetensors`` + ``tokenizer.json``, such as the
in-repo trained ``tests/fixtures/tiny_trained``):

  1. Greedy decode through the full serving engine; prints the text so a
     human (or the ``--expect`` substring) can confirm coherence.
  2. ``--hf-parity``: token-exact greedy comparison and a logprob gate
     against the ``transformers`` implementation on the same weights (on the
     CPU; raises where ``transformers`` is not installed).
  3. ``--spec``: n-gram prompt-lookup acceptance (4 drafts a step) on the
     model's own text, on short natural prompts and on repetitive ones,
     from ``server/metrics.py``'s ``SPEC_PROPOSED`` and ``SPEC_ACCEPTED``.

The checkpoint loads through ``models/weights.py`` and the ``tokenizers``
tokenizer, as ``LlmService.start`` loads one. It runs on the card unless
``--cpu`` is given; without a card the default raises. Prints one JSON line.

Usage:
  python -m atoma_infer_tpu_torch.tools.real_model_check --model-dir DIR \\
      [--cpu] [--hf-parity] [--spec] [--max-new 48] [--expect TEXT]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
from typing import List, Optional

import numpy as np
import torch

PROMPTS = [
    "The capital of France is",
    "Once upon a time, there was a",
    "The quick brown fox jumps over",
]
# The second ``--spec`` workload: repetitive prompts, n-gram prompt
# lookup's design case (continuations that echo the prompt's patterns).
REPETITIVE_PROMPTS = [
    "The capital of France is Paris.\n"
    "The capital of Japan is Tokyo.\n"
    "The capital of Italy is Rome.\n"
    "The capital of Spain is",
    "Every morning the fox walked to the river to look for bread.\n"
    "Every morning the bird walked to the market to look for "
    "apples.\nEvery morning the fox walked to",
]
SPEC_TOKENS = 4
# The logprob gate of the repository's test against ``transformers``
# (``tests/test_real_model.py``): max |Δ logprob| of the chosen tokens.
HF_LOGPROB_TOL = 2e-3


def build_service(model_dir: str, *, spec_tokens: int = 0, max_model_len: int = 1024,
                  dtype: Optional[torch.dtype] = None, device=None):
    """The port's ``LlmService`` on the checkpoint in ``model_dir``, in
    ``dtype`` (bf16 by default), on ``device`` (the card by default), with
    ``spec_tokens`` n-gram drafts a step: (service, model config,
    tokenizer)."""
    from tokenizers import Tokenizer

    from ..config import CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig
    from ..engine.llm_service import LlmService
    from ..models.registry import get_model_cls
    from ..models.weights import load_hf_config, load_llama_params
    from ..utils.device import resolve_device

    dtype = dtype or torch.bfloat16
    device = resolve_device(device)
    cfg = load_hf_config(model_dir)
    model = get_model_cls(cfg.architecture or "llama")(cfg, dtype=dtype, device=device)
    params = load_llama_params(model_dir, cfg, dtype=dtype, device=device)
    tokenizer = Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))
    config = EngineConfig(
        model=ModelConfig(model_name=model_dir,
                          dtype="float32" if dtype == torch.float32 else "bfloat16"),
        cache=CacheConfig(block_size=32, num_host_blocks_override=32),
        scheduler=SchedulerConfig(max_num_batched_tokens=4096, max_num_sequences=8,
                                  max_model_len=max_model_len,
                                  num_speculative_tokens=spec_tokens),
        validation=ValidationConfig(max_input_tokens=max_model_len - 256,
                                    max_total_tokens=max_model_len),
    )
    service = LlmService.start(config, model=model, params=params, tokenizer=tokenizer,
                               device=device)
    return service, cfg, tokenizer


def generate(service, prompts: List[str], max_new: int, top_n: int = 0):
    """Greedy ``prompts`` through the running service (each token's
    ``top_n`` most likely alternatives asked too, where given); stops it at
    the end of the wave. Returns the results in order."""
    from ..types import GenerateParameters, GenerateRequest

    async def go():
        task = asyncio.create_task(service.engine.run())
        futs = [await service.handle_request(GenerateRequest(
            request_id=f"real-{i}", inputs=prompt,
            parameters=GenerateParameters(max_new_tokens=max_new, top_n_tokens=top_n or None)))
            for i, prompt in enumerate(prompts)]
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=3600)
        service.stop()
        task.cancel()
        return results

    return asyncio.run(go())


def generate_counting_drafts(service, prompts: List[str], max_new: int):
    """:func:`generate`, and the drafts it proposed and accepted: (results,
    accepted / proposed rounded to 3 places or None, proposed)."""
    from ..server import metrics

    proposed, accepted = metrics.SPEC_PROPOSED.value, metrics.SPEC_ACCEPTED.value
    results = generate(service, prompts, max_new)
    d_prop = metrics.SPEC_PROPOSED.value - proposed
    d_acc = metrics.SPEC_ACCEPTED.value - accepted
    return results, (round(d_acc / d_prop, 3) if d_prop else None), d_prop


def hf_parity(model_dir: str, tokenizer, prompts: List[str], results, max_new: int) -> dict:
    """Greedy tokens and teacher-forced logprobs of ``transformers``'
    model on the same checkpoint (f32, the CPU) against ``results``:
    mismatched greedy tokens and the largest |Δ logprob|."""
    try:
        from transformers import AutoModelForCausalLM
    except ImportError as e:
        raise RuntimeError("--hf-parity needs the transformers package") from e

    hf = AutoModelForCausalLM.from_pretrained(model_dir, torch_dtype=torch.float32)
    hf.eval()
    mismatches, max_dlp = 0, 0.0
    for prompt, r in zip(prompts, results):
        ids = tokenizer.encode(prompt).ids
        ours = list(r.outputs[0].token_ids)
        with torch.no_grad():
            hf_out = hf.generate(torch.tensor([ids]), max_new_tokens=max_new, do_sample=False,
                                 temperature=None, top_p=None)
            logits = hf(torch.tensor([ids + ours[:-1]])).logits[0]
        hf_tokens = hf_out[0, len(ids):].tolist()
        n = min(len(hf_tokens), len(ours))
        mismatches += sum(1 for a, b in zip(hf_tokens[:n], ours[:n]) if a != b)
        lp = torch.log_softmax(logits.float(), dim=-1)
        hf_lps = [float(lp[len(ids) - 1 + j, t]) for j, t in enumerate(ours)]
        dlp = float(np.max(np.abs(np.array(hf_lps) - np.array(r.outputs[0].logprobs))))
        max_dlp = max(max_dlp, dlp)
    return {"hf_greedy_mismatches": mismatches, "hf_max_abs_dlogprob": round(max_dlp, 4)}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    parser.add_argument("--max-new", type=int, default=48)
    parser.add_argument("--hf-parity", action="store_true")
    parser.add_argument("--spec", action="store_true")
    parser.add_argument("--expect", default=None,
                        help="substring that must appear in the first completion")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None

    out = {}
    service, _, tokenizer = build_service(
        args.model_dir, spec_tokens=SPEC_TOKENS if args.spec else 0, device=device)
    results, acceptance, proposed = generate_counting_drafts(service, PROMPTS, args.max_new)
    for prompt, r in zip(PROMPTS, results):
        print(f"--- {prompt!r}\n    -> {r.outputs[0].output_text!r}")
    out["completions"] = [r.outputs[0].output_text for r in results]
    if args.expect is not None:
        text = results[0].outputs[0].output_text
        if args.expect not in text:
            raise AssertionError(f"expected {args.expect!r} in {text!r}")
        out["expect"] = "ok"

    if args.spec:
        out["spec_acceptance"] = acceptance
        out["spec_proposed"] = proposed
        # generate() stops its service at the end of the wave: a fresh one
        # for the second workload.
        service2, _, _ = build_service(args.model_dir, spec_tokens=SPEC_TOKENS, device=device)
        rep_results, rep_acceptance, _ = generate_counting_drafts(
            service2, REPETITIVE_PROMPTS, args.max_new)
        out["repetitive_completions"] = [r.outputs[0].output_text for r in rep_results]
        out["spec_acceptance_repetitive"] = rep_acceptance

    if args.hf_parity:
        out.update(hf_parity(args.model_dir, tokenizer, PROMPTS, results, args.max_new))

    print(json.dumps(out))


if __name__ == "__main__":
    main()
