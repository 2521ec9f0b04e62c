"""INT8-KV quality gate: logprob drift against a bf16 KV cache at matched weights.

Counterpart of ``tools/kv_quant_gate.py``. Runs the same model, weights and
prompt cache twice — once over a bf16 KV cache, once over that cache
quantized to INT8 pages with per-(slot, K/V) scales (the fused
quantize/write/attend decode kernel on the card) — decodes N steps, the
second run fed the first's tokens, and reports:

  - mean / max |Δ logprob| of the bf16 run's chosen token
  - greedy token agreement between the two runs

Usage:
    python -m atoma_infer_tpu_torch.tools.kv_quant_gate                # 1B widths on the card
    python -m atoma_infer_tpu_torch.tools.kv_quant_gate --device cpu   # tiny, plain versions
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.llama import Llama
from ..ops.kv_cache import SCALE_DTYPE, kv_quant_scales, quantize_kv_rows
from ..utils.device import resolve_device
from . import decode_harness as dh


def run_gate(model: Llama, params: Dict[str, Any], *, seqs: int, ctx: int, steps: int,
             block_size: int) -> Dict[str, Any]:
    """The gate on given weights; returns the tool's JSON as a dict."""
    dev = model.device
    bs = block_size
    cfg = model.config
    D, Hk = cfg.head_dim, cfg.num_key_value_heads
    rng = np.random.default_rng(0)
    num_blocks, tables = dh.page_tables(rng, seqs, (ctx + steps) // bs + 2)
    L, _, bs_, row = model.kv_cache_shape(num_blocks, bs)
    # A shared "prompt" cache: plausible KV rows (zero-mean, unit-ish scale).
    base_rows = rng.standard_normal((num_blocks, bs_, row)).astype(np.float32) * 0.3
    layer_rows = [base_rows * (1 + 0.01 * i) for i in range(L)]
    kv_bf16 = [torch.from_numpy(r).to(dev, model.dtype) for r in layer_rows]
    # The INT8 cache quantized from the same f32 rows with the engine's
    # helpers, so any divergence is quantization error. Rows are
    # head-interleaved [K_h | V_h]; scales are [pages, bs, 2] (K, V).
    kv_int8, kv_sc = [], []
    for r in layer_rows:
        flat = torch.from_numpy(r).to(dev).reshape(num_blocks * bs_, Hk, 2 * D)
        k_rows, v_rows = flat[:, :, :D], flat[:, :, D:]
        sc = kv_quant_scales(k_rows, v_rows)
        kv_int8.append(quantize_kv_rows(k_rows, v_rows, sc).reshape(num_blocks, bs_, row))
        kv_sc.append(sc.to(SCALE_DTYPE).reshape(num_blocks, bs_, 2))

    def rollout(kv_cache, kv_scales, forced=None):
        """Decode ``steps`` tokens. With ``forced`` = (inputs, greedy tokens)
        of the bf16 run the rollout is teacher-forced: both runs see the
        same contexts every step. Returns (inputs, greedy tokens, logprobs
        of the chosen tokens: its own, or forced, the bf16 run's)."""
        toks = torch.zeros(seqs, dtype=torch.int32, device=dev)
        inputs, all_toks, all_lps = [], [], []
        with torch.inference_mode():
            for i in range(steps):
                if forced is not None:
                    toks = dh.ints(forced[0][i], dev)
                inputs.append(toks.cpu().numpy())
                positions, meta = dh.decode_step_inputs(tables, ctx + i, bs, dev)
                chosen = None if forced is None else dh.ints(forced[1][i], dev)
                toks, lps = dh.logprob_step(model, params, toks, positions, kv_cache, meta,
                                            kv_scales=kv_scales, chosen=chosen)
                all_toks.append(toks.cpu().numpy())
                all_lps.append(lps.cpu().numpy())
        return np.stack(inputs), np.stack(all_toks), np.stack(all_lps)

    inputs_b, toks_b, chosen_b = rollout(kv_bf16, None)
    _, toks_q, chosen_q = rollout(kv_int8, kv_sc, forced=(inputs_b, toks_b))

    dlp = np.abs(chosen_b - chosen_q)
    return {
        "metric": "int8_kv_logprob_drift",
        "mean_abs_dlogprob": round(float(dlp.mean()), 5),
        "max_abs_dlogprob": round(float(dlp.max()), 5),
        "greedy_token_agreement": round(float((toks_b == toks_q).mean()), 4),
        "steps": steps,
        "seqs": seqs,
        "ctx": ctx,
        "backend": dh.device_name(dev),
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
    cfg, bs = dh.gate_config(on_card, tie_word_embeddings=True)
    if not on_card:
        args.seqs, args.ctx, args.steps = dh.CPU_SIZES
    model = Llama(cfg, dtype=torch.bfloat16 if on_card else torch.float32, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    report = run_gate(model, params, seqs=args.seqs, ctx=args.ctx, steps=args.steps,
                      block_size=bs)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
