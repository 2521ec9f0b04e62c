"""W8A8 quality gate: logprob drift of int8 activations against weight-only INT8.

Counterpart of ``tools/w8a8_gate.py``, on the same worst-case setup (random
weights, so flat logits):

  (a) bf16 weights                      — the reference
  (b) INT8 weights, bf16 activations    — kernel F
  (c) INT8 weights + W8A8 activations   — kernel H (``ATOMA_W8A8``)

All three decode the same teacher-forced token stream (run (a)'s greedy
choices) over the same bf16 KV rows, so (b)−(a) isolates weight quantization
and (c)−(b) the activation quantization that W8A8 adds.

Usage:
    python -m atoma_infer_tpu_torch.tools.w8a8_gate                # 1B widths on the card
    python -m atoma_infer_tpu_torch.tools.w8a8_gate --device cpu   # tiny, plain versions
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.llama import Llama
from ..ops.quant import quantize_weight
from ..utils.device import resolve_device
from . import decode_harness as dh

G = 128
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def quantize_projections(params: Dict[str, Any]) -> Dict[str, Any]:
    """The seven projections quantized to INT8, one scale a group of 128 rows
    (all rows where 128 does not divide them); embeddings, norms and the LM
    head stay dense. The tool's own ``quantize_stacked``
    (``w8a8_gate.py:77-89``) has ``quantize_weight``'s arithmetic (the f32
    absmax / 127, at least 1e-8, divides; half-to-even rounding; the scale
    stored as bf16 after), and gives the same bytes
    (``tests/test_torch_tools.py``)."""
    layers = dict(params["layers"])
    for key in PROJECTIONS:
        layers[key] = quantize_weight(params["layers"][key].float(), 8, G)
    return dict(params, layers=layers)


def run_gate(model: Llama, params: Dict[str, Any], qparams: Dict[str, Any], *,
             seqs: int, ctx: int, steps: int, block_size: int) -> Dict[str, Any]:
    """The gate on given dense and quantized weights; returns the tool's
    JSON as a dict."""
    dev = model.device
    bs = block_size
    rng = np.random.default_rng(0)
    num_blocks, tables = dh.page_tables(rng, seqs, (ctx + steps) // bs + 2)
    L, _, bs_, row = model.kv_cache_shape(num_blocks, bs)
    base_rows = rng.standard_normal((num_blocks, bs_, row)).astype(np.float32) * 0.3

    def fresh_cache():
        return [torch.from_numpy(base_rows * (1 + 0.01 * i)).to(dev, model.dtype)
                for i in range(L)]

    def run(p, w8a8: bool, teacher=None):
        """Greedy tokens and the logprobs of the teacher's tokens (of its
        own, without one), [steps, S] each."""
        kv = fresh_cache()
        tokens = torch.zeros(seqs, dtype=torch.int32, device=dev)
        toks_all, lps_all = [], []
        with dh.w8a8(w8a8), torch.inference_mode():
            for i in range(steps):
                positions, meta = dh.decode_step_inputs(tables, ctx + i, bs, dev)
                chosen = None if teacher is None else dh.ints(teacher[i], dev)
                toks, lps = dh.logprob_step(model, p, tokens, positions, kv, meta, chosen=chosen)
                toks_all.append(toks.cpu().numpy())
                lps_all.append(lps.cpu().numpy())
                tokens = toks if teacher is None else chosen
        return np.stack(toks_all), np.stack(lps_all)

    ref_toks, ref_lps = run(params, False)
    int8_toks, int8_lps = run(qparams, False, teacher=ref_toks)
    w8a8_toks, w8a8_lps = run(qparams, True, teacher=ref_toks)

    d_w = np.abs(ref_lps - int8_lps).reshape(-1)
    d_a = np.abs(int8_lps - w8a8_lps).reshape(-1)
    return {
        "metric": "w8a8_logprob_gate",
        "weight_quant_mean_abs_dlp": round(float(np.mean(d_w)), 4),
        "weight_quant_max_abs_dlp": round(float(np.max(d_w)), 4),
        "act_quant_mean_abs_dlp": round(float(np.mean(d_a)), 4),
        "act_quant_max_abs_dlp": round(float(np.max(d_a)), 4),
        "greedy_agreement_int8_vs_bf16": round(float(np.mean(int8_toks == ref_toks)), 4),
        "greedy_agreement_w8a8_vs_int8": round(float(np.mean(w8a8_toks == int8_toks)), 4),
        "note": "random weights = flat logits, worst case",
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the tiny model "
                             "through the plain versions, as the JAX tool's --cpu)")
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--seqs", type=int, default=16)
    parser.add_argument("--ctx", type=int, default=512)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg, bs = dh.gate_config(on_card, tie_word_embeddings=False)
    if not on_card:
        args.seqs, args.ctx, args.steps = dh.CPU_SIZES
    model = Llama(cfg, dtype=torch.bfloat16 if on_card else torch.float32, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    report = run_gate(model, params, quantize_projections(params), seqs=args.seqs,
                      ctx=args.ctx, steps=args.steps, block_size=bs)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
