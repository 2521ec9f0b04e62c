"""Quantization quality ladder on the peaked-logit in-repo trained model.

Counterpart of ``tools/quality_ladder.py``: the whole ladder on a trained
checkpoint (default ``tests/fixtures/tiny_trained``: real text, peaked
logits, self-consistent greedy):

  reference: dense weights + a KV cache in the model's dtype, the real
             prompts prefilled through the paged cache in one ragged step,
             then N greedy decode steps.
  variants (each fed the reference's tokens, so Δlogprob isolates
  quantization numerics):
    int8      — weight-only INT8 (kernel F)
    int8_w8a8 — + dynamic per-token INT8 activations (kernel H)
    int4      — weight-only INT4 (kernel G)
    kv8       — dense weights + INT8 KV pages (kernel D and the INT8 write)
    kvfp8     — dense weights + e4m3 KV pages (kernel E and the e4m3 write)
    int8_kv8  — INT8 weights over INT8 KV
  per variant: mean / max |Δ logprob of the reference-chosen token| and the
  greedy token agreement with the reference.

The model runs in bf16 on the card and in f32 on the CPU.

Usage:
    python -m atoma_infer_tpu_torch.tools.quality_ladder [--model-dir DIR]
        [--device cuda|cpu] [--steps 32] [--seqs 16] [--prompt-len 96]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.llama import Llama
from ..models.weights import load_hf_config, load_llama_params
from ..ops.attention import AttentionMetadata
from ..ops.kv_cache import alloc_kv_scales
from ..utils.device import resolve_device
from . import decode_harness as dh
from .tiny_corpus import build_corpus

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests", "fixtures", "tiny_trained"
)
BLOCK_SIZE = 32

# name -> (weight quantization, W8A8, KV cache dtype)
VARIANTS = {
    "int8": ("int8", False, None),
    "int8_w8a8": ("int8", True, None),
    "int4": ("int4", False, None),
    "kv8": (None, False, "int8"),
    "kvfp8": (None, False, "fp8"),
    "int8_kv8": ("int8", False, "int8"),
}


def corpus_prompts(tokenizer_path: str, seqs: int, prompt_len: int) -> np.ndarray:
    """``seqs`` windows of ``prompt_len`` tokens of the corpus, at spread
    offsets: [seqs, prompt_len] int32."""
    from tokenizers import Tokenizer

    stream = Tokenizer.from_file(tokenizer_path).encode(build_corpus()).ids
    stride = (len(stream) - prompt_len - 1) // seqs
    return np.stack(
        [stream[i * stride: i * stride + prompt_len] for i in range(seqs)]
    ).astype(np.int32)


def run_ladder(model: Llama, params_by_quant: Dict[Optional[str], Any], prompts: np.ndarray,
               steps: int) -> Dict[str, Any]:
    """Reference and every variant over the prompts; returns
    ``{"reference_peakedness": …, "variants": …}``."""
    dev = model.device
    S, P = prompts.shape
    bs = BLOCK_SIZE
    pages_per_seq = -(-(P + steps + 1) // bs)
    # Permuted (non-contiguous) physical pages: block-table indirection is
    # part of what the ladder must not perturb.
    num_blocks, tables = dh.page_tables(np.random.default_rng(0), S, pages_per_seq)
    L = model.config.num_layers

    def fresh_cache(kv_dtype):
        cache = model.alloc_kv_cache(
            num_blocks, bs, dtype={"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(kv_dtype))
        scales = ([alloc_kv_scales(num_blocks, bs, dev) for _ in range(L)]
                  if kv_dtype == "int8" else None)
        return cache, scales

    # The whole prompt batch in one ragged prefill step.
    slot_rows = tables[:, np.arange(P) // bs] * bs + np.arange(P) % bs
    prefill_meta = AttentionMetadata(
        slot_mapping=dh.ints(slot_rows.reshape(-1), dev),
        block_tables=dh.ints(tables, dev),
        seq_lens=dh.ints(np.full(S, P), dev),
        query_start_loc=dh.ints(np.arange(S + 1) * P, dev),
        num_seqs=dh.ints([S], dev),
        block_size=bs,
        max_q_len=P,
    )
    prefill_positions = dh.ints(np.tile(np.arange(P), S), dev)
    last_rows = torch.arange(1, S + 1, device=dev) * P - 1
    prompt_ids = dh.ints(prompts.reshape(-1), dev)

    def run_variant(quant, w8a8: bool, kv_dtype, teacher=None):
        """Prefill + N decode steps: (greedy tokens, logprobs of the
        teacher's tokens, or of its own without one), each [steps + 1, S];
        row 0 is the prefill's next-token prediction."""
        p = params_by_quant[quant]
        kv, sc = fresh_cache(kv_dtype)

        def chosen(r):
            return None if teacher is None else dh.ints(teacher[r], dev)

        with dh.w8a8(w8a8), torch.inference_mode():
            toks, lps = dh.logprob_step(model, p, prompt_ids, prefill_positions, kv,
                                        prefill_meta, kv_scales=sc, rows=last_rows,
                                        chosen=chosen(0))
            all_toks, all_lps = [toks.cpu().numpy()], [lps.cpu().numpy()]
            feed = toks
            for i in range(steps):
                if teacher is not None:
                    feed = dh.ints(teacher[i], dev)
                positions, meta = dh.decode_step_inputs(tables, P + i, bs, dev)
                toks, lps = dh.logprob_step(model, p, feed, positions, kv, meta,
                                            kv_scales=sc, chosen=chosen(i + 1))
                all_toks.append(toks.cpu().numpy())
                all_lps.append(lps.cpu().numpy())
                feed = toks
        return np.stack(all_toks), np.stack(all_lps)

    ref_toks, chosen_ref = run_variant(None, False, None)
    # Peakedness evidence: the reference's own confidence in its greedy
    # choices (flat-logit random weights sit near log(1/V)).
    peak = {
        "mean_chosen_logprob": round(float(chosen_ref.mean()), 4),
        "median_chosen_prob": round(float(np.median(np.exp(chosen_ref))), 4),
    }
    report = {}
    for name, (quant, w8a8, kv_dtype) in VARIANTS.items():
        toks, lps = run_variant(quant, w8a8, kv_dtype, teacher=ref_toks)
        dlp = np.abs(lps - chosen_ref)
        report[name] = {
            "mean_abs_dlogprob": round(float(dlp.mean()), 5),
            "max_abs_dlogprob": round(float(dlp.max()), 5),
            "greedy_agreement": round(float((toks == ref_toks).mean()), 4),
        }
    return {"reference_peakedness": peak, "variants": report}


def ladder(model_dir: str = DEFAULT_DIR, device=None, *, steps: int = 32, seqs: int = 16,
           prompt_len: int = 96, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Load the checkpoint dense, INT8 and INT4 on ``device`` (bf16 on the
    card, f32 on the CPU, unless ``dtype`` is given), run the ladder, and
    return the tool's JSON as a dict."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model_dir = os.path.abspath(model_dir)
    cfg = load_hf_config(model_dir)
    model = Llama(cfg, dtype=dtype, device=dev)
    params_by_quant = {
        q: load_llama_params(model_dir, cfg, dtype=dtype, device=dev, quantization=q)
        for q in (None, "int8", "int4")
    }
    prompts = corpus_prompts(os.path.join(model_dir, "tokenizer.json"), seqs, prompt_len)
    out = run_ladder(model, params_by_quant, prompts, steps)
    return {
        "metric": "quality_ladder_peaked_logits",
        "model_dir": os.path.relpath(model_dir),
        "backend": dh.device_name(dev),
        "seqs": seqs,
        "prompt_len": prompt_len,
        "decode_steps": steps,
        **out,
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model-dir", default=DEFAULT_DIR)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, bf16; 'cpu' runs the plain "
                             "versions in f32)")
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--seqs", type=int, default=16)
    parser.add_argument("--prompt-len", type=int, default=96)
    args = parser.parse_args(argv)
    report = ladder(args.model_dir, args.device, steps=args.steps, seqs=args.seqs,
                    prompt_len=args.prompt_len)
    print(json.dumps(report, indent=2), flush=True)
    return report


if __name__ == "__main__":
    main()
