#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``atoma_infer_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases (each one
raises on failure; nothing is caught):

1. The card's name and power limit (``nvidia-smi``), then the kernels'
   build: every ``atoma_infer_tpu_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a``, all sources in parallel.
2. Every kernel against its plain PyTorch version on the card.
   Attention and KV write: first every compiled instantiation at small sizes
   (head_dim 32/64/128 × block size 8/16/32/48/64/128 × GQA group 1 to 8,
   bf16 and f32, and head dims 96 and 256 in bf16 with one window and one
   soft-cap case each; a 1,600-key row cut into several KV splits, short
   rows leaving splits empty), then Llama-3.2-1B
   attention shapes (Hq=32, Hk=8, D=64, block 16) with a mixed
   prefill+decode batch and a pure-decode batch: the KV write bit-exact, the
   attention kernels within the tolerances below (plus one case each with a
   sliding window, a soft cap and ALiBi); the KV writes timed in CUDA
   graphs beside ``index_copy_`` (their eager, host-inclusive times on an
   earlier line). The ragged kernel takes the tensor cores for bf16 queries
   and the CUDA cores for f32 ones: the mixed batches time the tensor-core
   kernel beside the CUDA-core one by a direct launch, and the CUDA-core one
   on f32 queries; a 256-query prefill chunk at positions 1,792-2,047 (8B
   shapes, bf16/INT8/e4m3 caches) is timed eagerly and in a CUDA graph
   beside its bound, the CUDA-core kernel and flash SDPA over the same keys
   gathered contiguous. The fused decode kernel takes the split kernel for
   bf16 queries (a 1,600-key row of the variant grids cut into KV splits,
   short rows whole, caches and scales bit-exact) and the unsplit one for
   f32 queries; the decode batches time the split kernel beside the
   unsplit one by a direct launch, and the merge of split rows is checked
   and timed at the services' 8-row decode shape. Quantized matmuls: a
   sweep at small sizes (8/4-bit weights × group 128 and one group ×
   bf16/f32 × M in 1, 8, 64, 300, plus ragged N; F, G and H on their route
   and on the CUDA cores), W8A8's integer dots checked exact on both of
   H's routes, F, G and H's tensor-core routes over groups of 16 to 512 × M
   from 1 to 300 × N in 72, 144, 200, 2048, 14336 (each call's route
   checked by the launch counters; misaligned and f32 inputs on the CUDA
   cores), ``quantize_weight`` on the card byte-identical to the CPU, then
   the Llama-3.1-8B projection and LM-head shapes at decode (M = 8, 64) and
   one prefill chunk (M = 256), F, G and H on both routes, and F and G's
   CUDA-core route on its own traffic (f32, ``tiny_trained``'s gate
   projection, 8 rows).
   INT8 and e4m3 KV caches (kernels D, E and their
   writes): every instantiation at small sizes on a mixed and a decode
   batch, then the Llama-3.1-8B attention shapes (Hq=32, Hk=8, D=128, block
   16); the writes and the fused kernels' caches and scales bit-exact, the
   attention within the tolerances below. A, B, D and E at the
   Llama-3.2-3B attention shapes (3 query heads per kv head), the ragged
   kernels at blocks of 16 and of 64. A, B, C and the merge at the
   Phi-3-mini (D = 96, 32 kv heads, window 2,047) and Gemma-2-9B (D = 256,
   soft cap 50) attention shapes, and at Gemma-2-9B's widths with heads
   of 512 (every ``*_w512`` kernel, bf16, fp16 and f32 queries, and C):
   the write bit-exact, A on a mixed batch
   and B on 64 decode rows against their plain versions, each timed beside
   its bound, and the merge after a split launch. Head dims at a padded
   width (``check_head_dim_variants``): A, B, D, E and the merge at head
   dims 80, 100, 112, 120, 160, 192, 8, 50 and 248 (groups 1, 4, 12, 20),
   at odd ones and those of the width 512 (3, 9, 63, 127, 255, 257, 320,
   384, 511, 512; groups 4 and 12, and 20 at 63, 320 and 512)
   and at 144 and 256 q heads per kv head (head dims 32, 80, 128), bf16,
   fp16 and f32 queries over every cache kind, mixed and decode batches,
   each call's route read from the launch counters; then A, B and the
   1-byte caches' D or E at h2o-danube-1.8b's, OpenLLaMA-3B's,
   h2o-danube3-4b's and an ALiBi Llama-3.2-1B's at head dim 63 attention
   shapes (``HEAD_DIM_SHAPES``), timed beside their bounds, the merge
   where those shapes' plans split, and A and B at head dims below their
   width beside the width's own (``time_padding``). Kernel I (the W8A8 rate probe's
   matmul, both forms) at small shapes (M = 1 to 400) and at the probe's
   (184 × 4096 × 14336): int8 bit-exact, mixed within its tolerance. The
   kernels of a speculative verify step on a 64-sequence verify batch (K =
   4 drafts, 5 query rows a sequence, keys 16-2,047, T = 320): C and A at
   the 1B shapes (B on the same sequences as decode rows beside them), the
   INT8 write and D at the 8B shapes, F at M = 320, and the merge after A
   on 8 such sequences of 1,800-2,047 keys. Tensor parallelism's per-rank
   shapes (``TP_ATTENTION_SHAPES``: Llama-3.1-8B at tp = 2, Llama-3.1-70B
   at tp = 8): the INT8 write and the split fused D with ``scales_new``
   (the scales of the model's kv heads, not the rank's), caches and scales
   bit-exact; at 8B tp = 2 also E (an e4m3 cache: its write, ragged and
   split fused kernels) and H at the row-parallel K (o_proj 2,048,
   down_proj 7,168; M = 8, beside torch.mm); F at 70B's per-rank
   projections at tp = 8 (M = 8); then C alone at 8,192 rows, timed
   against its bytes bound; a one-rank NCCL group built on the card, its
   collectives run. float16 (the ``*_f16``
   instantiations of A–H): every attention instantiation at small sizes
   (head dims 32-256 over an fp16 cache, 32-128 over INT8 and e4m3, blocks
   of 16 and 64, groups 1, 3, 8; writes and fused caches bit-exact), their
   occupancy equal to the bf16 ones' (the plans read the bf16 answer), then
   the bf16 rows' shapes: C, A (window, soft cap, ALiBi) and B at the 1B
   shapes, the merge after A's split 8B prefill chunk, the INT8 and e4m3
   writes, D and E at the 8B shapes, F, G and H at the 8B gate projection
   (M = 8 and 256) beside ``torch.mm`` in fp16, each on its route by the
   launch counters, within ``ATTN_TOL``/``QMM_TOL["float16"]``. Groups of
   9 to 128 q heads per kv head (``check_group_variants``,
   ``check_group_kernels``): the fused kernels (the split kernel's two-half
   tile for bf16 and fp16 queries, the unsplit f32 one) up to 16 and the
   ragged ones (the tensor-core kernels and their merge; the f32
   ``rpa_kernel``, a token's group cut over blocks past 256 threads) at G
   9, 12, 16, 17, 32, 128 × D 64, 96, 128, 256 over every cache kind, a
   decode batch past 16 on the write and the ragged kernel, writes and
   scales bit-exact (a window, a soft cap and ALiBi at three shapes); then
   B at Mistral-Large-2's shape (96 q heads over 8) and D (with
   ``scales_new``) and E at Llama-3.1-405B's per-rank shape at tp = 8 (16
   over 1) on 64 decode rows, and A, D, E on a mixed batch there; the write
   and A and D at Llama-3.1-8B's widths with one kv head (G = 32) on 64
   decode rows; the f32 ``rpa_kernel`` at G 17 and 32; timed beside their
   bounds. Times with CUDA events: kernel, plain version and,
   where one PyTorch call computes the same function, that call.
3. The port's ``Llama`` with 2 layers at full width: Llama-3.2-1B and
   Llama-3.2-3B dense, and
   Llama-3.1-8B quantized (INT8, INT4, and INT8 over an INT8 and an e4m3
   KV cache), prefill plus 3 decode steps on the card (kernels) against the
   same f32 weights on the CPU (plain versions). Then services on the card
   against the same on the CPU, greedy tokens identical: the tiny random
   model with a pool tight enough that groups are swapped out and back,
   ``tiny_trained`` quantized to INT8 and to INT4 on load, and ``tiny_trained`` over an
   INT8 KV cache (INT8 weights) and an e4m3 one, swapped out and back.
   ``tiny_trained`` is served in f32, so its quantized services (INT8 and
   INT4) are F and G's CUDA-core route: their launches in the kernels line
   come from those runs, their times from that model's shape (phase 2).
   Then the quality ladder on ``tiny_trained`` in f32 at reduced sizes on
   the card against the CPU: greedy agreements identical, drifts within
   ``LADDER_CARD_TOL``. Each model family (Mistral-7B-v0.1, Qwen2-7B,
   Phi-3-mini-4k-instruct, Gemma-2-9B, Mixtral-8x7B-v0.1) with 2 layers at
   its published widths, bf16, against the same model attending through
   the plain versions on the card: logits finite and within
   ``FAMILY_MODEL_TOL``. The verify step: the 1B model (bf16) at 2
   layers, one verify step of 8 sequences with 4 drafts each against 5
   decode steps over the same tokens, logits within ``SPEC_VERIFY_TOL``
   (the same at 16 layers printed). ``tiny_trained`` (f32) with 4 drafts on
   the card against the same without drafts (all tokens, the seeded
   request's too) and against the CPU (greedy tokens).
4. Services through ``LlmService.start``, each with 8 requests of 256
   tokens (128 but for the 1B bf16 and 8B INT8 services; chunked prefill,
   one seeded sampled, the second half admitted before engine step 7 while
   the first decodes):
   the full-width bf16 Llama-3.2-1B (16 layers, KV pool sized from
   ``torch.cuda.mem_get_info``), the full-width bf16 Llama-3.2-3B (28
   layers, 3 query heads per kv head) and the 1B again with blocks of 64,
   then the full-width Llama-3.1-8B (8 of its 32 layers,
   ``QUANT_MAIN_LAYERS``, bf16 activations, llama3 rope scaling, untied
   per-channel INT8 LM head) with INT8 weights, then at 4 of its layers
   (``QUANT_HALF_LAYERS``) with INT4 weights and INT8 weights under W8A8
   over a bf16 KV cache, and INT8 weights over an INT8 KV cache (pool sized
   from free memory) and an e4m3 one; random weights from a
   ``torch.Generator``, quantized with the port's ``quantize_weight``.
   Every request must finish at its length or on
   EOS, every block must return to the pool, and every kernel of the path
   must have been launched during that service's run (launch counts are set
   to 0 just before it and read just after), every ragged launch on the
   tensor cores and every fused one on the split kernel (the f32 services
   of phase 3 on the CUDA-core and unsplit kernels), every W8A8 launch on
   H's tensor-core route. Each runs (a) synchronous and eager (the smoke
   takes the worker's CUDA graphs away), printing the worker's step wall
   times and one pure-decode and one mixed step's device time by kernel
   (``torch.profiler``), the decode step's fused attention and H time, the
   mixed step's ragged attention and H share; then (b) on its real card
   path, every step replaying a CUDA graph of its key (pure-decode,
   prefill, mixed and penalty steps; verify steps with drafts): the 1B
   bf16 and the 8B INT8 services with async scheduling (depth 2) after
   ``warmup()``, the others synchronous as ``LlmService.start`` gives them,
   each graph captured at its key's first step; the 1B service's eighth
   request asks repetition and frequency penalties for its 32 tokens. (b)'s
   greedy and seeded tokens must be identical to (a)'s, its launches are
   counted through the replays, no step may run eagerly after its key's
   capture, and it prints the number of graphs, ``SHAPE_COUNTS``, the
   replays and first captures by step kind, the captures and evictions
   inside the traffic's window, the capture seconds and the graphs' memory
   (static inputs, pool, outputs, instantiated graphs) against the reserve
   the KV pool left them, which it must not pass. In (b) the widest keys a user can
   reach are captured and replayed, each giving its eager step's outputs:
   the widest pure-decode key (every row sampled with every option and the
   most top-n alternatives), the widest mixed key (a chunk filling the
   token budget beside the other rows, penalties too; the pool after it
   held to the pool the reserve counts) and a prefill key (one chunk of the
   budget ending at ``max_model_len``). Both modes print the steady-decode
   period p50/p99 (wall between successive pure-decode dispatches), the
   steps with a prefill chunk p50/p99 (each such dispatch to the next,
   first captures apart), the warmup's seconds, the tokens/s over the whole
   traffic window, and the device idle share over a window of 8
   pure-decode steps (``torch.profiler``).
   After the 1B services, the port's HTTP server: ``build_app(service,
   warmup=True)`` over the 1B service with async scheduling, on
   127.0.0.1, answers one plain and one streamed (SSE)
   ``POST /v1/chat/completions``; both bodies checked, each request's time
   to first token and total printed. Last, one bf16 service per model
   family at its published widths (``FAMILIES``: 4 layers each, for the
   smoke's time limit), eager
   and then synchronous with graphs, the same checks; Phi-3-mini's second
   prompt passes its 2,047-key window. Then the published checkpoints with
   9 to 16 q heads per kv head (``run_group_services``,
   ``GROUP_FAMILIES``): Mistral-Large-Instruct-2407 at 4 of 88 layers in
   bf16 and Llama-3.1-405B at 4 of 126 with INT8 weights over an INT8 and
   an e4m3 cache; and Llama-3.1-8B's widths with its 32 q heads over one kv
   head (G = 32) at 4 of 32 layers over a bf16 and an INT8 cache; each with
   the plain attention, eager and with graphs: tokens identical eager and
   with graphs, within the near-tie rule of the plain attention's, every
   pure-decode step on the split fused kernel and no decode step on the
   ragged one, or at G = 32 every step on the write and the ragged kernel
   and none on the fused one; the graphs' memory within the reserve. Then
   the published checkpoints whose head dims run at a padded width
   (``run_head_dim_services``, ``HEAD_DIM_FAMILIES``, 4 layers each):
   h2o-danube-1.8b (D = 80, window 4,096) over a bf16 and an INT8 cache,
   OpenLLaMA-3B (D = 100) over a bf16 and an e4m3 cache, h2o-danube3-4b
   (D = 120) over a bf16 cache, and Llama-3.1-70B's widths with head dim
   32 and its 256 q heads over one kv head (G = 256); then widths with
   heads no published checkpoint has: Gemma-2-9B's with heads of 512 over
   a bf16 and an INT8 cache, Llama-3.1-8B's with heads of 512 over an
   e4m3 cache, and Llama-3.2-1B's with ALiBi and heads of 63 over a bf16
   and an INT8 cache; the same three runs and checks, every ragged call of
   the G = 256 service planned in two slices a token. Speculative decoding (K = 4, 8
   sequences, prompts echoing their first half): the 1B bf16 service (a)
   eager and (b) async with graphs after ``warmup()``, and after the 8B
   services the INT8 + INT8 KV one synchronous with graphs, each against
   the same service without drafts whose requests ask the top 2 logprobs:
   every greedy request identical up to a position where those are closer
   than ``SPEC_TIE_TOL``, the seeded one identical, and the 1B one also
   synchronous with graphs, its tokens identical to (a)'s; drafts proposed
   and accepted, the verify steps' wall (a) and replay time beside a decode
   replay at the same S (b), every verify step (beside a prefill chunk
   too) through a graph, none eager after its key's capture,
   keys first captured in the traffic listed, the widest verify key's
   replay identical to its eager step, graph memory under the reserve.
   Tensor parallelism (``run_tp_services``): ``LlmService.start`` with
   ``tensor_parallel_size`` 2, the second rank spawned on this card (gloo,
   collectives through pinned host memory: not a TP speed), every rank
   replaying its steps as CUDA graphs captured in segments between the
   collectives: ``tiny_trained`` f32 from its directory, each rank loading
   its shard, tokens identical to tp = 1 on the card and, greedy, on the
   CPU; then Llama-3.1-8B INT8 + INT8 KV at full width and ``TP_LAYERS``
   of its 32 layers, every
   rank drawing the same seeded weights, the 8 requests at 64 tokens,
   every rank eager and then with graphs after ``warmup()`` (tokens
   identical), against the same service at tp = 1 with graphs under the
   near-tie rule; the backend, the ranks' devices, the KV blocks,
   collectives a step, the period and tokens/s of both runs, replays and
   first captures by step kind, segments a graph, collectives and kernel
   launches a pure-decode step eager and replayed (equal), a decode key's
   segments replayed alone and the idle share, and each rank's graph
   memory against the reserve printed; then at ``TP_KERNEL_LAYERS`` layers
   INT8 weights over
   an e4m3 cache (E) and under W8A8 (H), with graphs, against tp = 1 under
   the near-tie rule; a follower that fails or does not exit fails the
   run. Then pipeline and context parallelism (``run_pp_services``, its
   pp = 2 × tp = 2 run with segmented stage graphs against every stage
   eager; ``run_cp_layer``). float16
   (``run_fp16_services``): the 1B model in fp16 at 16 layers, its steps'
   logits through the kernels against the plain attention on the card
   within ``FP16_MODEL_TOL``, then its service eager and synchronous with
   graphs; the 8B widths at ``FP16_8B_LAYERS`` layers with INT8 weights
   over an INT8 KV cache, eager and with graphs; eager, INT4 weights over
   an e4m3 cache and INT8 weights under W8A8: tokens identical eager and
   with graphs, every launch an fp16 kernel's. Prefix caching
   (``run_prefix_cache``): the 1B bf16 service and the 8B INT8 + INT8 KV
   one (``PREFIX_LAYERS_8B`` layers), with caching and without, on 16
   requests sharing a 1,536-byte prefix (the second 8 admitted once the
   first 8 have their first token) and the prefix alone: tokens within the
   near-tie rule, fewer prefill tokens with caching, and with caching
   identical eager and with graphs (both waves); the prefill tokens,
   the second wave's time to first token, the mixed-step wall, and the
   bytes of the shared block the whole-prefix request rewrote (max |Δ| of
   K/V and of the INT8 scales; non-zero is a finding). The host ms of one
   ``schedule()`` on each block manager at 64 and 256 sequences
   (``time_schedulers``). Every service the smoke starts reports its block
   manager (``track_block_managers``): one that did not ask for the Python
   manager (speculative decoding does) must run on the native core.
5. The quantization decision tools (``atoma_infer_tpu_torch/tools``): the
   W8A8 rate probe's ``main()`` (its path through kernel I, both forms
   launched, int8 exact), then the W8A8 and INT8-KV gates at their card
   defaults and the quality ladder on ``tiny_trained`` in bf16, each
   printing its JSON; every number finite, every agreement in [0, 1], and
   each tool's kernels launched in its own run (F and H; D; A to H). Then
   ``tools/real_model_check.py``'s path on ``tiny_trained``
   (``run_real_model_check``): f32 on the card token for token the CPU's,
   bf16 within the near-tie rule, and the n-gram drafts' acceptance on both
   prompt sets (f32 equal to the CPU's; bf16) beside JAX's.
6. The smoke's wall, then a ``{"kernels": [...]}`` JSON line (each
   kernel's launches from its own path's run in (b), graph replays
   counted; the fp16 instantiations' launches from the fp16 services; A, B
   and the merge at head dims 96 and 256 as rows of their
   own, their launches from the Phi-3-mini and Gemma-2-9B services; C, A,
   the INT8 write, D, F and the merge on verify rows as rows of their own,
   their launches from the spec services' runs with graphs; the
   tensor-parallel shapes' rows, their launches from the 8B tp = 2
   services' rank 0 (E's and H's from the e4m3 and W8A8 runs); the group rows, their launches from the group
   services' runs with graphs), then
   as the last line ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, without a CUDA device or outside the
repository.
"""

from __future__ import annotations

import asyncio
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

try:
    from atoma_infer_tpu_torch.engine.cuda_graphs import StepGraphs as _StepGraphs
except ImportError:  # outside the repository: main() refuses to run
    _StepGraphs = object


class EagerStepGraphs(_StepGraphs):
    """Step graphs that never capture: every step of every rank eager. A
    tensor-parallel service's eager baseline, handed to every rank through
    its ``ModelFactory`` (``step_graphs``)."""

    def run(self, key, step, packed, sampling, sampling_version, gumbel, prev_tokens,
            hidden=None):
        return step(packed, sampling, gumbel, prev_tokens,
                    *(() if hidden is None else (hidden,)))


class SerialStepGraphs(_StepGraphs):
    """The port's step graphs, whose captures the ranks that share this card
    take one after another (a barrier on the payload group before each
    rank's turn), so that each rank's measure of its capture's memory
    (``captured_bytes``, from the device's free memory) holds no other
    rank's; after each capture the rank writes its graphs' figures to
    ``$SMOKE_GRAPH_STATS/rank<r>.json``. Handed to every rank through the
    service's ``ModelFactory``."""

    def _capture(self, step, views):
        group = self.group
        for turn in range(group.tp):
            group.barrier()
            if turn == group.rank:
                entry = super()._capture(step, views)
        group.barrier()
        out = os.environ.get("SMOKE_GRAPH_STATS")
        if out:
            stats = dict(captured_bytes=self.captured_bytes, static_bytes=self.static_bytes,
                         captures=self.evictions + len(self.graphs) + 1,
                         evictions=self.evictions, capture_seconds=self.capture_seconds,
                         segments=max(len(e.segments) for e in
                                      [entry, *self.graphs.values()]))
            with open(os.path.join(out, f"rank{group.rank}.json"), "w") as f:
                json.dump(stats, f)
        return entry

# Tolerances of the kernels against their plain versions, by dtype. bf16:
# inputs and outputs are bf16 (one rounding of the output, 2^-8 relative)
# and both sides accumulate in f32 in different orders; f32: summation
# order only; fp16: as bf16 with 3 more mantissa bits (P and the output
# rounded to 2^-11 relative, against the plain version's f32 P), so 4× under
# bf16's.
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-4, "float16": 5e-3}
# Model check: f32 weights on both sides; logits differ by summation order
# through 2 layers and a 2048- or 4096-wide LM head.
MODEL_TOL = 1e-3
# Quantized matmuls against their plain versions: max |err| over the
# output's largest magnitude. bf16: one rounding of the output to bf16 on
# both sides (half an ulp each, up to 2^-8 of a value) after f32 sums in
# another order; f32: summation order only; fp16: one rounding to 2^-11.
QMM_TOL = {"bfloat16": 1e-2, "float32": 1e-5, "float16": 2e-3}

# Published H100 SXM peaks (NVIDIA data sheet) for the roofline bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "int8": 1979e12}

# Llama-3.2-1B (the configuration bench.py runs), attention shapes.
HQ, HK, D, BS = 32, 8, 64, 16

# Llama-3.1-8B widths (meta-llama/Llama-3.1-8B config.json) and its
# quantized matmul shapes: name -> (K, N, group size).
LLAMA_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_attention_heads=32, num_key_value_heads=8, head_dim=128,
    rope_theta=500000.0, max_position_embeddings=131072, tie_word_embeddings=False,
)
QMM_SHAPES = {
    "q_proj/o_proj": (4096, 4096, 128),
    "k_proj/v_proj": (4096, 1024, 128),
    "gate_proj/up_proj": (4096, 14336, 128),
    "down_proj": (14336, 4096, 128),
    "lm_head": (4096, 128256, 4096),
}
# Llama-3.2-3B widths (meta-llama/Llama-3.2-3B config.json; BASELINE.json
# config #2): 24 q heads over 8 kv heads (3 a group), tied embeddings, llama3
# rope scaling with factor 32.
LLAMA_3B = dict(
    vocab_size=128256, hidden_size=3072, intermediate_size=8192,
    num_attention_heads=24, num_key_value_heads=8, head_dim=128,
    rope_theta=500000.0, max_position_embeddings=131072, tie_word_embeddings=True,
)
# The shape and row count whose numbers go into the kernels line.
QMM_LINE_SHAPE, QMM_LINE_M = "gate_proj/up_proj", 8

# The service's pure-decode step (0-based, among pure-decode steps) that
# runs under torch.profiler: past the first wave's warm-up, with the second
# wave decoding.
PROFILED_DECODE_STEP = 12


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms, its launches captured in a CUDA
    graph and replayed, so the host's launch cost is not in the number."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def profile_device(torch, fn):
    """Run ``fn`` once under ``torch.profiler``. Returns (its result, wall
    ms, device busy ms, [(kernel, device ms)] largest first). Busy time is
    the sum of the device events' own times (one stream: they do not
    overlap); the wall clock includes the profiler's own overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    return out, wall_ms, sum(t for _, t in kernels), kernels


# --------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def build_kernels() -> float:
    from atoma_infer_tpu_torch.ops import cuda_lib

    t0 = time.monotonic()
    logs = cuda_lib.build_all()
    seconds = time.monotonic() - t0
    # Slowest first: the first sets the build's wall.
    walls = {source: float(re.match(r"built in (\S+) s", text).group(1))
             for source, text in logs.items()}
    for source in sorted(logs, key=lambda src: -walls[src]):
        text = logs[source]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", text))
        log(f"built {source} at {walls[source]:.1f} s: {len(regs)} kernels, max "
            f"{max(regs, default=0)} registers, {spills} bytes of spill stores")
        # Kernel by kernel, their registers and spills under __launch_bounds__
        # (PERF.md): the 1-byte caches' wide instantiations, the width 512's,
        # and in every source the fused kernels' instantiation for groups of
        # 9 to 16.
        for entry in re.split(r"Compiling entry function", text)[1:]:
            name = re.match(r"\s*'_ZN5atoma\d*(\w+?)I", entry)
            used = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            if name and used:
                args = ",".join(re.findall(r"Li(\d+)E", entry.split("'")[1]))
                wide_group = name.group(1).startswith("fused_") and args.endswith(",16")
                if "_wide" in source or "_w512" in source or wide_group:
                    log(f"  {source} {name.group(1)}<{args}>: {used.group(1)} registers, "
                        f"{spill.group(1) if spill else 0} bytes of spill stores, "
                        f"{smem.group(1) if smem else 0} bytes of static shared memory")
    log(f"kernel build: {seconds:.1f} s")
    return seconds


# --------------------------------------------------------------- phase 2
def make_batch(rng, specs, *, dtype, num_blocks, decode_only, device,
               hq=HQ, hk=HK, d=D, bs=BS, T=None):
    """A ragged batch at the main path's bucketed shapes: ``specs`` is a
    list of (q_len, kv_len); every sequence on random disjoint pages. ``T``
    overrides the token bucket (a verify step's is S·(1+K))."""
    import numpy as np
    import torch

    from atoma_infer_tpu_torch.engine.input_prep import bucket
    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata

    n = len(specs)
    S = bucket(n, dense=decode_only)
    T = S if decode_only else (T or bucket(sum(q for q, _ in specs)))
    P = bucket(max(-(-kv // bs) for _, kv in specs))
    perm = rng.permutation(num_blocks)
    tables = np.zeros((S, P), np.int32)
    seq_lens = np.zeros(S, np.int32)
    qsl = np.zeros(S + 1, np.int32)
    slots = np.full(T, -1, np.int32)
    used = 0
    for s, (q_len, kv) in enumerate(specs):
        pages = -(-kv // bs)
        tables[s, :pages] = perm[used: used + pages]
        used += pages
        seq_lens[s] = kv
        qsl[s + 1] = qsl[s] + q_len
        for i in range(q_len):
            pos = kv - q_len + i
            slots[qsl[s] + i] = tables[s, pos // bs] * bs + pos % bs
    assert used <= num_blocks
    qsl[n + 1:] = qsl[n]
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    meta = AttentionMetadata(
        slot_mapping=ints(slots), block_tables=ints(tables), seq_lens=ints(seq_lens),
        query_start_loc=ints(qsl), num_seqs=ints([n]), block_size=bs,
        decode_only=decode_only, max_q_len=max(q for q, _ in specs),
    )
    return dict(
        q=randn(T, hq, d), k=randn(T, hk, d), v=randn(T, hk, d),
        cache=randn(num_blocks, bs, 2 * hk * d), meta=meta, specs=specs,
        rows=int(qsl[n]), dtype=dtype,
    )


def kernel_line_specs(rng, max_keys: int = 2048):
    """The (q_len, kv_len) sequences of the kernels line's two batches: a
    mixed step (prefill chunks of 300, 128 and 57 tokens and 29 decode rows
    of 16 to ``max_keys`` − 1 keys) and 64 decode rows of 16 to 2,047 keys,
    drawn from ``rng``."""
    mixed = [(300, 300), (128, 700), (57, 57)] + [
        (1, int(k)) for k in rng.integers(16, max_keys, size=29)]
    return mixed, [(1, int(k)) for k in rng.integers(16, 2048, size=64)]


# The attention kernels' shape grid at small sizes: block sizes (the
# CUDA-core ragged kernel stages 8, 16, 32 a whole page and 48, 64, 128 in key
# tiles of gcd(bs, 32); the tensor-core one gathers 64-key tiles across
# pages) and GQA groups (the fused kernel is instantiated for 1 to 8).
VARIANT_BLOCK_SIZES = (8, 16, 32, 48, 64, 128)
VARIANT_GROUPS = tuple(range(1, 9))
# The head dims of Phi-3-mini (96) and Gemma-2 (256), which every route
# takes; the 1-byte caches' tensor-core kernels there are their own
# instantiations (``*_wide``).
WIDE_HEAD_DIMS = (96, 256)
ALL_HEAD_DIMS = (32, 64, 96, 128, 256)
# The widest width, whose kernels (``*_w512``) run head dims 257 to 512.
W512 = 512
# The CUDA-core ragged kernel's bf16 form (dtype 1, timed beside the tensor
# cores, never routed) is instantiated at these head dims only.
CUDA_CORE_BF16_DIMS = (32, 64, 128)
# The ragged batches of the grids: chunks, decode rows, and one decode row of
# 1,600 keys, which the tensor-core route cuts into several KV splits while
# the short rows leave splits empty.
VARIANT_MIXED = [(20, 45), (1, 30), (7, 7), (1, 1), (33, 70), (1, 1600)]
# The decode batches' 1,600-key row is cut into several KV splits by the
# split fused kernel (bf16 queries); the short rows stay whole.
VARIANT_DECODE = [(1, 45), (1, 17), (1, 1), (1, 64), (1, 100), (1, 1600)]


def variant_blocks(specs, bs):
    """Pages enough for ``specs`` at block size ``bs``, and a few spare."""
    return sum(-(-kv // bs) for _, kv in specs) + 8


class SplitCount:
    """Counts, over the bf16 calls of a variant grid, those whose plan cut a
    decode row into several KV splits and those that left a split empty
    (the kernel's rule: min(splits, ceil(key tiles / RPA_MIN_TILES)))."""

    def __init__(self):
        self.multi = self.empty = 0

    def add(self, b):
        from atoma_infer_tpu_torch.ops import paged_attention as pa

        q, meta = b["q"], b["meta"]
        if q.element_size() != 2:  # f32 queries take the CUDA cores
            return
        hk = b["cache"].shape[2] // (2 * q.shape[2])
        kind = None if b["cache"].dtype == q.dtype else b["cache"].dtype
        plan = pa.rpa_plan_for(q, meta, hk, kind)
        for q_len, kv in b["specs"]:
            if q_len != 1:
                continue
            tiles = (kv - 1) // pa.RPA_KEY_TILE + 1
            nsplit = max(1, min(plan.splits, -(-tiles // pa.RPA_MIN_TILES)))
            self.multi += nsplit > 1
            self.empty += nsplit < plan.splits

    def check(self, label):
        log(f"{label}: {self.multi} decode rows in several KV splits, {self.empty} with "
            "empty splits")
        if not (self.multi and self.empty):
            raise AssertionError(f"{label}: no multi-split or no empty-split case")


class FusedSplitCount:
    """Counts, over the bf16 decode calls of a variant grid, the rows the
    split fused kernel cut into several KV splits and the rows it left whole
    (its rule: ``split_key_ranges`` under the call's plan)."""

    def __init__(self):
        self.multi = self.whole = 0

    def add(self, b):
        from atoma_infer_tpu_torch.ops import paged_attention as pa

        q, meta = b["q"], b["meta"]
        if q.element_size() != 2:  # f32 queries take the unsplit kernel
            return
        hk = b["cache"].shape[2] // (2 * q.shape[2])
        kind = None if b["cache"].dtype == q.dtype else b["cache"].dtype
        splits = pa.fused_splits_for(q, meta, hk, kind)
        for _, kv in b["specs"]:
            n = len(pa.split_key_ranges(kv - 1, None, splits, pa.FUSED_MIN_TILES))
            self.multi += n > 1
            self.whole += n == 1

    def check(self, label):
        log(f"{label}: {self.multi} decode rows in several KV splits, {self.whole} whole")
        if not (self.multi and self.whole):
            raise AssertionError(f"{label}: no multi-split or no whole row")


def cuda_core_fused(q, cache, k, v, meta, *, scale, kv_scales=None):
    """The unsplit fused kernel (``fused_decode_kernel``, B, D or E by the
    cache's dtype) by a direct launch, whatever the queries' dtype: the
    route sends bf16 queries to the split kernel, so this is how the old
    kernel is timed beside the new one. Writes the cache like the route."""
    import torch

    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    T, Hq, D = q.shape
    S, P = meta.block_tables.shape
    nb, bs, row = cache.shape
    out = torch.empty_like(q)
    kind = None if cache.dtype == q.dtype else cache.dtype
    pa.FUSED_DECODE[kind](
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        cache.data_ptr(), None if kv_scales is None else kv_scales.data_ptr(),
        meta.slot_mapping.data_ptr(), meta.block_tables.data_ptr(), meta.seq_lens.data_ptr(),
        meta.query_start_loc.data_ptr(), meta.num_seqs.data_ptr(), None, out.data_ptr(),
        S, Hq, row // (2 * D), D, P, bs, nb * bs, float(scale), 0, 0.0,
        cuda_lib.current_stream_handle(q.device), device=q.device)
    return out


def fused_old_vs_new(torch, label, new_ms, old_fn, ref, n):
    """The unsplit fused kernel by a direct launch on the same inputs as a
    split-kernel row (the cache already holds the step's rows, which it
    rewrites with the same bytes): checked against the plain version,
    timed, the ratio logged. Returns the old kernel's ms."""
    got = old_fn()
    tol = ATTN_TOL["bfloat16"]
    if not torch.allclose(got[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"{label}: the unsplit fused kernel disagrees")
    old_ms = cuda_ms(old_fn)
    log(f"{label}: split kernel {new_ms:.4f} ms, unsplit fused_decode_kernel by a direct "
        f"launch {old_ms:.4f} ms ({old_ms / new_ms:.2f}x)")
    return old_ms


def cuda_core_attention(q, cache, meta, *, scale, kv_scales=None):
    """The CUDA-core ragged kernel (``rpa_kernel``, A, D or E by the cache's
    dtype) by a direct launch, whatever the queries' dtype: the route sends
    bf16 queries to the tensor cores, so this is how the old kernel is
    timed beside the new one."""
    import torch

    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rpa_kernel takes bf16 or f32 queries, not {q.dtype}")
    T, Hq, D = q.shape
    S, P = meta.block_tables.shape
    out = torch.empty_like(q)
    kind = None if cache.dtype == q.dtype else cache.dtype
    pa.RAGGED_ATTENTION[kind](
        int(q.dtype == torch.bfloat16), q.data_ptr(), cache.data_ptr(),
        None if kv_scales is None else kv_scales.data_ptr(), meta.block_tables.data_ptr(),
        meta.seq_lens.data_ptr(), meta.query_start_loc.data_ptr(), meta.num_seqs.data_ptr(),
        None, out.data_ptr(), S, Hq, cache.shape[2] // (2 * D), D, P, meta.block_size,
        int(meta.max_q_len), float(scale), 0, 0.0, cuda_lib.current_stream_handle(q.device),
        device=q.device)
    return out


def old_vs_new(torch, label, new_ms, old_fn, ref, n):
    """The CUDA-core kernel by a direct launch on the same inputs as a
    tensor-core row: checked against the plain version, timed, and the
    speed-up logged. Returns the old kernel's ms."""
    got = old_fn()
    tol = ATTN_TOL["bfloat16"]
    if not torch.allclose(got[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"{label}: the CUDA-core kernel disagrees")
    old_ms = cuda_ms(old_fn)
    log(f"{label}: tensor cores {new_ms:.4f} ms, CUDA-core rpa_kernel by a direct launch "
        f"{old_ms:.4f} ms ({old_ms / new_ms:.1f}x)")
    return old_ms


def check_kernel_variants(torch):
    """Every compiled instantiation against its plain version at small
    sizes: head_dim 32/64/96/128/256 × block size 8/16/32/48/64/128 × 1 to
    8 query heads per kv head, bf16 (the ragged kernel on the tensor cores)
    and f32 (on the CUDA cores), with a 1,600-key decode row that the
    tensor-core route cuts into several KV splits (the main-path shapes are
    checked at full size in :func:`check_kernels`)."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write, paged_attention

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    mixed_specs, decode_specs = VARIANT_MIXED, VARIANT_DECODE
    splits, fused_splits = SplitCount(), FusedSplitCount()
    wide_splits, wide_fused_splits = SplitCount(), FusedSplitCount()
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = ATTN_TOL[dtype_name]
        worst, cases = 0.0, 0
        dims = ALL_HEAD_DIMS
        for d in dims:
            for bs in VARIANT_BLOCK_SIZES:
                for group in VARIANT_GROUPS:
                    shape = dict(hq=2 * group, hk=2, d=d, bs=bs, dtype=dtype,
                                 num_blocks=variant_blocks(mixed_specs + decode_specs, bs), device=dev)
                    label = f"{dtype_name} D={d} bs={bs} G={group}"
                    # At the new head dims, one window case and one soft-cap
                    # case (Phi-3's and Gemma-2's score modifiers).
                    mods = [{}]
                    if d in WIDE_HEAD_DIMS and bs == 16 and group == 2:
                        mods += [dict(sliding_window=40), dict(soft_cap=50.0)]
                    b = make_batch(rng, mixed_specs, decode_only=False, **shape)
                    (wide_splits if d in WIDE_HEAD_DIMS else splits).add(b)
                    m, n = b["meta"], b["rows"]
                    got, want = b["cache"].clone(), b["cache"].clone()
                    kv_write.write_kv_cache_cuda(got, b["k"], b["v"], m.slot_mapping)
                    kv_write.write_kv_cache_plain(want, b["k"], b["v"], m.slot_mapping)
                    if not torch.equal(got, want):
                        raise AssertionError(f"reshape_and_cache {label} is not bit-exact")
                    for kw in mods:
                        out = paged_attention.ragged_paged_attention_cuda(
                            b["q"], got, m, scale=d ** -0.5, **kw)
                        ref = paged_attention.ragged_paged_attention_paged_plain(
                            b["q"], got, m, scale=d ** -0.5, **kw)
                        if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol,
                                              rtol=tol):
                            raise AssertionError(f"ragged_paged_attention {label} {kw} disagrees")
                        worst = max(worst, (out[:n].float() - ref[:n].float()).abs().max().item())

                    b = make_batch(rng, decode_specs, decode_only=True, **shape)
                    (wide_fused_splits if d in WIDE_HEAD_DIMS else fused_splits).add(b)
                    m, n = b["meta"], b["rows"]
                    for kw in mods:
                        got, want = b["cache"].clone(), b["cache"].clone()
                        out = paged_attention.ragged_paged_attention_fused_cuda(
                            b["q"], got, b["k"], b["v"], m, scale=d ** -0.5, **kw)
                        ref = paged_attention.fused_decode_attention_plain(
                            b["q"], want, b["k"], b["v"], m, scale=d ** -0.5, **kw)
                        if not torch.equal(got, want):
                            raise AssertionError(f"fused_decode_attention {label} {kw}: cache "
                                                 "differs")
                        if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol,
                                              rtol=tol):
                            raise AssertionError(f"fused_decode_attention {label} {kw} disagrees")
                        worst = max(worst, (out[:n].float() - ref[:n].float()).abs().max().item())
                    cases += 1
        log(f"kernel variants {dtype_name}: {cases} shapes (head dims {dims}) × 3 kernels "
            f"agree, max |err| {worst:.3e} (tol {tol}); the ragged kernel on "
            f"{'the tensor cores' if dtype_name == 'bfloat16' else 'the CUDA cores'}, the "
            f"fused one {'split' if dtype_name == 'bfloat16' else 'unsplit'}")
    splits.check("kernel variants, tensor-core route")
    fused_splits.check("kernel variants, split fused route")
    wide_splits.check(f"kernel variants at D={WIDE_HEAD_DIMS}, tensor-core route")
    wide_fused_splits.check(f"kernel variants at D={WIDE_HEAD_DIMS}, split fused route")


def attention_work(specs, window, elt, *, fused, kv_elt=None, slot_extra=0,
                   hq=HQ, hk=HK, d=D):
    """(bytes, flops) the attention needs for these sequences: each needed
    K/V row read once (``kv_elt`` bytes an element, default ``elt``, plus
    ``slot_extra`` bytes of scales a slot), q read and out written once
    (``elt`` bytes an element); 4·D flops per (query head, key) pair.
    ``fused`` adds the new rows' read and the cache row's write."""
    row = 2 * hk * d * (kv_elt or elt) + slot_extra
    nbytes = flops = 0
    for q_len, kv in specs:
        first = kv - q_len
        lo = max(0, first - window + 1) if window else 0
        kv_read = kv - lo - (1 if fused else 0)
        nbytes += kv_read * row + 2 * q_len * hq * d * elt
        if fused:
            nbytes += 2 * hk * d * elt + row  # k_new/v_new in, the new row out
        for pos in range(first, kv):
            keys = min(pos + 1, window) if window else pos + 1
            flops += keys * hq * 4 * d
    return nbytes, flops


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch):
    """Phase 2; returns the per-kernel rows of the kernels line (without
    the launch counts)."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write, paged_attention
    from atoma_infer_tpu_torch.ops.attention import alibi_slopes

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    mixed_specs, decode_specs = kernel_line_specs(rng)
    rows = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = ATTN_TOL[dtype_name]
        elt = torch.tensor([], dtype=dtype).element_size()
        mixed = make_batch(rng, mixed_specs, dtype=dtype, num_blocks=4096,
                           decode_only=False, device=dev)
        decode = make_batch(rng, decode_specs, dtype=dtype, num_blocks=8192,
                            decode_only=True, device=dev)
        m = mixed["meta"]

        # C: reshape_and_cache, bit-exact.
        got = mixed["cache"].clone()
        want = mixed["cache"].clone()
        kv_write.write_kv_cache_cuda(got, mixed["k"], mixed["v"], m.slot_mapping)
        kv_write.write_kv_cache_plain(want, mixed["k"], mixed["v"], m.slot_mapping)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"reshape_and_cache ({dtype_name}) is not bit-exact")
        log(f"reshape_and_cache {dtype_name}: bit-exact on {mixed['rows']} rows")
        cache = got  # holds this step's rows for the attention checks
        if dtype_name == "bfloat16":
            valid = m.slot_mapping >= 0
            slots = m.slot_mapping[valid].long()
            fused_rows = torch.stack([mixed["k"], mixed["v"]], 2).reshape(
                mixed["k"].shape[0], -1)[valid]
            flat = cache.view(-1, cache.shape[-1])
            n = mixed["rows"]
            c_bytes = n * 2 * (2 * HK * D * elt) + m.slot_mapping.numel() * 4

            def write():
                kv_write.write_kv_cache_cuda(cache, mixed["k"], mixed["v"], m.slot_mapping)

            def copy():
                flat.index_copy_(0, slots, fused_rows)

            log(f"reshape_and_cache: eager, host-inclusive {cuda_ms(write):.4f} ms "
                f"(index_copy_ {cuda_ms(copy):.4f} ms)")
            # The kernel and index_copy_ in CUDA graphs (device time); the
            # plain version selects rows by a boolean mask, which waits on
            # the host, so it cannot be captured and is timed eagerly.
            rows["reshape_and_cache"] = dict(
                max_abs_err=0.0, ms=graph_ms(torch, write),
                plain_ms=cuda_ms(lambda: kv_write.write_kv_cache_plain(
                    cache, mixed["k"], mixed["v"], m.slot_mapping)),
                library_ms=graph_ms(torch, copy), bytes=c_bytes, flops=0,
            )

        # A: ragged paged attention on the mixed batch.
        variants = [("base", {})]
        if dtype_name == "bfloat16":
            variants += [
                ("sliding_window", dict(sliding_window=256)),
                ("soft_cap", dict(soft_cap=30.0)),
                ("alibi", dict(alibi_slopes=alibi_slopes(HQ, device=dev))),
            ]
        scale = D ** -0.5
        for label, kw in variants:
            out = paged_attention.ragged_paged_attention_cuda(
                mixed["q"], cache, m, scale=scale, **kw)
            ref = paged_attention.ragged_paged_attention_paged_plain(
                mixed["q"], cache, m, scale=scale, **kw)
            n = mixed["rows"]
            err = (out[:n].float() - ref[:n].float()).abs().max().item()
            ok = torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol)
            log(f"ragged_paged_attention {dtype_name} {label}: max |err| {err:.3e} "
                f"(tol {tol})")
            if not ok:
                raise AssertionError(f"ragged_paged_attention {dtype_name} {label} disagrees")
            if label == "base":
                # bf16 queries take the tensor cores (the main path's
                # kernel); f32 queries the CUDA cores, whose launches come
                # from the f32 services.
                nbytes, flops = attention_work(mixed_specs, None, elt, fused=False)
                name = ("ragged_paged_attention_mma" if dtype_name == "bfloat16"
                        else "ragged_paged_attention")
                rows[name] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: paged_attention.ragged_paged_attention_cuda(
                        mixed["q"], cache, m, scale=scale)),
                    plain_ms=cuda_ms(lambda: paged_attention.ragged_paged_attention_paged_plain(
                        mixed["q"], cache, m, scale=scale), iters=5, warmup=1),
                    library_ms=None, bytes=nbytes, flops=flops, dtype=dtype_name,
                )
                if dtype_name == "bfloat16":
                    old_vs_new(torch, "ragged_paged_attention 1B mixed", rows[name]["ms"],
                               lambda: cuda_core_attention(mixed["q"], cache, m, scale=scale),
                               ref, n)

        # B: fused decode write + attention on the pure-decode batch.
        dm = decode["meta"]
        for label, kw in variants:
            got_cache = decode["cache"].clone()
            want_cache = decode["cache"].clone()
            out = paged_attention.ragged_paged_attention_fused_cuda(
                decode["q"], got_cache, decode["k"], decode["v"], dm, scale=scale, **kw)
            ref = paged_attention.fused_decode_attention_plain(
                decode["q"], want_cache, decode["k"], decode["v"], dm, scale=scale, **kw)
            n = decode["rows"]
            err = (out[:n].float() - ref[:n].float()).abs().max().item()
            ok = torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol)
            log(f"fused_decode_attention {dtype_name} {label}: max |err| {err:.3e} "
                f"(tol {tol}), cache bit-exact {torch.equal(got_cache, want_cache)}")
            if not ok or not torch.equal(got_cache, want_cache):
                raise AssertionError(f"fused_decode_attention {dtype_name} {label} disagrees")
            if label == "base":
                # bf16 queries take the split kernel (the main path's), f32
                # queries the unsplit one, whose launches come from the f32
                # services.
                nbytes, flops = attention_work(decode_specs, None, elt, fused=True)
                c = got_cache
                name = ("fused_decode_attention_split" if dtype_name == "bfloat16"
                        else "fused_decode_attention")
                rows[name] = dict(
                    max_abs_err=err,
                    ms=cuda_ms(lambda: paged_attention.ragged_paged_attention_fused_cuda(
                        decode["q"], c, decode["k"], decode["v"], dm, scale=scale)),
                    plain_ms=cuda_ms(lambda: paged_attention.fused_decode_attention_plain(
                        decode["q"], c, decode["k"], decode["v"], dm, scale=scale),
                        iters=5, warmup=1),
                    library_ms=None, bytes=nbytes, flops=flops, dtype=dtype_name,
                )
                if dtype_name == "bfloat16":
                    fused_old_vs_new(torch, "fused_decode_attention 1B decode", rows[name]["ms"],
                                     lambda: cuda_core_fused(decode["q"], c, decode["k"],
                                                             decode["v"], dm, scale=scale),
                                     ref, n)
        del mixed, decode, cache
        torch.cuda.empty_cache()
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"),
                                             r.pop("dtype", "bfloat16"))
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}), bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rows


# ------------------------------------- phase 2: INT8 and FP8 KV caches (D, E)
KV8_DTYPES = ("int8", "fp8")


def same_bytes(torch, a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def kv8_cache(torch, cache, kv, d):
    """A 1-byte cache from a random ``make_batch`` cache: each slot's K and V
    halves quantized to INT8 with their scales by the port's plain
    quantization (returns (cache, scales)), or rounded to e4m3 (scales
    None)."""
    from atoma_infer_tpu_torch.ops.kv_cache import FP8_MAX, kv_quant_scales, quantize_kv_rows

    if kv == "fp8":
        return cache.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn), None
    nb, bs, row = cache.shape
    flat = cache.view(nb * bs, row // (2 * d), 2, d)
    k, v = flat[:, :, 0], flat[:, :, 1]
    scales = kv_quant_scales(k, v)
    q = quantize_kv_rows(k, v, scales).view(nb, bs, row)
    return q, scales.to(torch.bfloat16).view(nb, bs, 2)


def kv8_write(cache, scales, k, v, slots, *, cuda):
    """The KV write of a 1-byte cache, kernel or plain version, in place."""
    from atoma_infer_tpu_torch.ops import kv_write

    if scales is not None:
        fn = kv_write.write_kv_cache_quant_cuda if cuda else kv_write.write_kv_cache_quant_plain
        fn(cache, scales, k, v, slots)
    else:
        fn = kv_write.write_kv_cache_cuda if cuda else kv_write.write_kv_cache_plain
        fn(cache, k, v, slots)


def clone(t):
    return None if t is None else t.clone()


def check_kv8(torch, b, kv, label, tol, *, decode, **mods):
    """One batch through the kernels of a 1-byte cache against their plain
    versions, with the score modifiers ``mods``. Mixed: the write kernel
    (cache and scales bit-exact), then ragged attention over the written
    cache. Decode: the fused kernel (cache and scales bit-exact with
    write-then-plain-attention, so the current token is attended in the
    cache's type). Returns (max |err|, the post-write cache and scales)."""
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    m, n, d = b["meta"], b["rows"], b["q"].shape[2]
    scale = d ** -0.5
    cache, scales = kv8_cache(torch, b["cache"], kv, d)
    got_c, got_s, want_c, want_s = cache, scales, clone(cache), clone(scales)
    if decode:
        out = pa.ragged_paged_attention_fused_cuda(
            b["q"], got_c, b["k"], b["v"], m, scale=scale, kv_scales=got_s, **mods)
        ref = pa.fused_decode_attention_plain(
            b["q"], want_c, b["k"], b["v"], m, scale=scale, kv_scales=want_s, **mods)
        what = f"fused_decode_attention_{kv}"
    else:
        kv8_write(got_c, got_s, b["k"], b["v"], m.slot_mapping, cuda=True)
        kv8_write(want_c, want_s, b["k"], b["v"], m.slot_mapping, cuda=False)
        what = f"reshape_and_cache_{kv}"
    if not same_bytes(torch, got_c, want_c) or (
            scales is not None and not same_bytes(torch, got_s, want_s)):
        raise AssertionError(f"{what} {label}: cache or scales not bit-exact")
    if not decode:
        out = pa.ragged_paged_attention_cuda(b["q"], got_c, m, scale=scale, kv_scales=got_s,
                                             **mods)
        ref = pa.ragged_paged_attention_paged_plain(b["q"], got_c, m, scale=scale,
                                                    kv_scales=got_s, **mods)
        what = f"ragged_paged_attention_{kv}"
    err = (out[:n].float() - ref[:n].float()).abs().max().item()
    if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what} {label} disagrees: max |err| {err:.3e}")
    return err, got_c, got_s


def check_kv8_variants(torch):
    """Every compiled INT8/e4m3 instantiation against its plain version at
    small sizes: head_dim 32/64/96/128/256 × block size 8/16/32/48/64/128 ×
    1 to 8 query heads per kv head × bf16 (tensor cores; the ``*_wide``
    instantiations at 96 and 256) / f32 (CUDA cores) queries, on a mixed
    batch with a row cut into several KV splits and on a pure-decode batch;
    at the wide head dims also a window and a soft-cap case (Phi-3's and
    Gemma-2's score modifiers)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    mixed_specs, decode_specs = VARIANT_MIXED, VARIANT_DECODE
    for kv in KV8_DTYPES:
        splits, fused_splits = SplitCount(), FusedSplitCount()
        wide_splits, wide_fused_splits = SplitCount(), FusedSplitCount()
        for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            tol = ATTN_TOL[dtype_name]
            worst, cases = 0.0, 0
            for d in ALL_HEAD_DIMS:
                wide = d in WIDE_HEAD_DIMS
                for bs in VARIANT_BLOCK_SIZES:
                    for group in VARIANT_GROUPS:
                        shape = dict(hq=2 * group, hk=2, d=d, bs=bs, dtype=dtype,
                                     num_blocks=variant_blocks(mixed_specs + decode_specs, bs), device=dev)
                        label = f"{dtype_name} D={d} bs={bs} G={group}"
                        mods = [{}]
                        if wide and bs == 16 and group == 2:
                            mods += [dict(sliding_window=40), dict(soft_cap=50.0)]
                        for decode, specs in ((False, mixed_specs), (True, decode_specs)):
                            b = make_batch(rng, specs, decode_only=decode, **shape)
                            for kw in mods:
                                err, cache, _ = check_kv8(torch, b, kv, f"{label} {kw}", tol,
                                                          decode=decode, **kw)
                                worst = max(worst, err)
                            counts = ((wide_fused_splits if decode else wide_splits) if wide
                                      else (fused_splits if decode else splits))
                            counts.add(dict(b, cache=cache))
                        cases += 1
            log(f"{kv} KV variants {dtype_name}: {cases} shapes (head dims {ALL_HEAD_DIMS}) × "
                f"3 kernels agree, writes and fused caches bit-exact, max |err| {worst:.3e} "
                f"(tol {tol})")
        splits.check(f"{kv} KV variants, tensor-core route")
        fused_splits.check(f"{kv} KV variants, split fused route")
        wide_splits.check(f"{kv} KV variants at D={WIDE_HEAD_DIMS}, tensor-core route")
        wide_fused_splits.check(f"{kv} KV variants at D={WIDE_HEAD_DIMS}, split fused route")


def check_kv8_kernels(torch):
    """D and E (and the 1-byte writes) at the Llama-3.1-8B attention shapes
    (Hq=32, Hk=8, D=128, block 16), bf16 queries: a mixed batch and 64
    decode sequences, each kernel against its plain version, then timed
    (CUDA events); the ragged kernel on the tensor cores beside the
    CUDA-core one by a direct launch, and the CUDA-core one on f32 queries
    (its own traffic). Returns the kernels line's rows."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    mixed_specs, decode_specs = kernel_line_specs(rng)
    shape = dict(hq=32, hk=8, d=128, bs=16, dtype=torch.bfloat16, device=dev)
    mixed = make_batch(rng, mixed_specs, num_blocks=4096, decode_only=False, **shape)
    decode = make_batch(rng, decode_specs, num_blocks=8192, decode_only=True, **shape)
    tol, scale = ATTN_TOL["bfloat16"], 128 ** -0.5
    rows = {}
    for kv in KV8_DTYPES:
        extra = 4 if kv == "int8" else 0  # bytes of scales a slot
        work = dict(kv_elt=1, slot_extra=extra, hq=32, hk=8, d=128)
        m, dm = mixed["meta"], decode["meta"]
        err, cache, scales = check_kv8(torch, mixed, kv, "8B mixed", tol, decode=False)
        n = mixed["rows"]
        log(f"reshape_and_cache_{kv} 8B: bit-exact on {n} rows; ragged_paged_attention_{kv} "
            f"8B mixed: max |err| {err:.3e} (tol {tol})")
        row_in, row_out = 2 * 8 * 128 * 2, 2 * 8 * 128 + extra

        def write(cache=cache, scales=scales):
            kv8_write(cache, scales, mixed["k"], mixed["v"], m.slot_mapping, cuda=True)

        log(f"reshape_and_cache_{kv} 8B: eager, host-inclusive {cuda_ms(write):.4f} ms")
        rows[f"reshape_and_cache_{kv}"] = dict(
            max_abs_err=0.0, ms=graph_ms(torch, write),  # device time, as C's
            plain_ms=cuda_ms(lambda: kv8_write(cache, scales, mixed["k"], mixed["v"],
                                               m.slot_mapping, cuda=False)),
            library_ms=None, bytes=n * (row_in + row_out) + m.slot_mapping.numel() * 4, flops=0,
        )
        # bf16 queries: the tensor cores, the main path's kernel, beside the
        # CUDA-core kernel by a direct launch.
        nbytes, flops = attention_work(mixed_specs, None, 2, fused=False, **work)
        ref = pa.ragged_paged_attention_paged_plain(mixed["q"], cache, m, scale=scale,
                                                    kv_scales=scales)
        rows[f"ragged_paged_attention_{kv}_mma"] = row = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                mixed["q"], cache, m, scale=scale, kv_scales=scales)),
            plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                mixed["q"], cache, m, scale=scale, kv_scales=scales), iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops,
        )
        old_vs_new(torch, f"ragged_paged_attention_{kv} 8B mixed", row["ms"],
                   lambda: cuda_core_attention(mixed["q"], cache, m, scale=scale,
                                               kv_scales=scales), ref, n)
        # f32 queries: the CUDA cores, whose launches come from the f32
        # services.
        q32 = mixed["q"].float()
        got = pa.ragged_paged_attention_cuda(q32, cache, m, scale=scale, kv_scales=scales)
        want = pa.ragged_paged_attention_paged_plain(q32, cache, m, scale=scale, kv_scales=scales)
        err32 = (got[:n] - want[:n]).abs().max().item()
        tol32 = ATTN_TOL["float32"]
        if not torch.allclose(got[:n], want[:n], atol=tol32, rtol=tol32):
            raise AssertionError(f"ragged_paged_attention_{kv} 8B mixed f32 disagrees: {err32:.3e}")
        nbytes, flops = attention_work(mixed_specs, None, 4, fused=False, **work)
        rows[f"ragged_paged_attention_{kv}"] = dict(
            max_abs_err=err32,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                q32, cache, m, scale=scale, kv_scales=scales)),
            plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                q32, cache, m, scale=scale, kv_scales=scales), iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops, dtype="float32",
        )
        del ref, want, got, q32
        err, dcache, dscales = check_kv8(torch, decode, kv, "8B decode", tol, decode=True)
        dn = decode["rows"]
        log(f"fused_decode_attention_{kv}_split 8B decode: max |err| {err:.3e} (tol {tol}), "
            f"cache and scales bit-exact, {pa.fused_splits_for(decode['q'], dm, 8, dcache.dtype)} "
            "splits at most")
        nbytes, flops = attention_work(decode_specs, None, 2, fused=True, **work)
        rows[f"fused_decode_attention_{kv}_split"] = row = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                kv_scales=dscales)),
            plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                kv_scales=dscales), iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops,
        )
        ref = pa.fused_decode_attention_plain(decode["q"], clone(dcache), decode["k"], decode["v"],
                                              dm, scale=scale, kv_scales=clone(dscales))
        fused_old_vs_new(torch, f"fused_decode_attention_{kv} 8B decode", row["ms"],
                         lambda: cuda_core_fused(decode["q"], dcache, decode["k"], decode["v"],
                                                 dm, scale=scale, kv_scales=dscales), ref, dn)
        # f32 queries: the unsplit kernel, whose launches come from the f32
        # services; cache and scales bit-exact, f32 tolerance.
        q32, k32, v32 = (decode[x].float() for x in ("q", "k", "v"))
        got_c, got_s, want_c, want_s = clone(dcache), clone(dscales), clone(dcache), clone(dscales)
        got = pa.ragged_paged_attention_fused_cuda(q32, got_c, k32, v32, dm, scale=scale,
                                                   kv_scales=got_s)
        want = pa.fused_decode_attention_plain(q32, want_c, k32, v32, dm, scale=scale,
                                               kv_scales=want_s)
        err32 = (got[:dn] - want[:dn]).abs().max().item()
        tol32 = ATTN_TOL["float32"]
        if not (same_bytes(torch, got_c, want_c) and (got_s is None or same_bytes(
                torch, got_s, want_s)) and torch.allclose(got[:dn], want[:dn], atol=tol32,
                                                         rtol=tol32)):
            raise AssertionError(f"fused_decode_attention_{kv} 8B decode f32 disagrees: "
                                 f"{err32:.3e}")
        nbytes, flops = attention_work(decode_specs, None, 4, fused=True, **work)
        rows[f"fused_decode_attention_{kv}"] = dict(
            max_abs_err=err32,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                q32, got_c, k32, v32, dm, scale=scale, kv_scales=got_s)),
            plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                q32, got_c, k32, v32, dm, scale=scale, kv_scales=got_s), iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops, dtype="float32",
        )
        del cache, scales, dcache, dscales, got_c, got_s, want_c, want_s, ref
    # The bf16 cache at the same shapes, for the bytes a 1-byte cache saves:
    # the split kernel and the unsplit one by a direct launch.
    dm = decode["meta"]
    bf16_cache = decode["cache"].clone()
    bf16_ms = cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
        decode["q"], bf16_cache, decode["k"], decode["v"], dm, scale=scale))
    old_ms = cuda_ms(lambda: cuda_core_fused(decode["q"], bf16_cache, decode["k"], decode["v"], dm,
                                             scale=scale))
    bound_ms, _ = bound(*attention_work(decode_specs, None, 2, fused=True, hq=32, hk=8, d=128),
                        "bfloat16")
    log(f"fused_decode_attention_split (bf16 cache) 8B decode: {bf16_ms:.4f} ms, unsplit "
        f"fused_decode_kernel by a direct launch {old_ms:.4f} ms, bound {bound_ms:.4f} ms")
    combine_row = check_split_combine(torch)
    del mixed, decode, bf16_cache
    torch.cuda.empty_cache()
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"),
                                             r.pop("dtype", "bfloat16"))
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library none), "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    rows["paged_attention_split_combine"] = combine_row
    return rows


def check_split_combine(torch):
    """The merge of split rows where the main path runs it: after the
    tensor-core ragged kernel on a 256-query prefill chunk at positions
    1,792-2,047 (Llama-3.1-8B attention shapes, bf16 cache, the route's plan,
    which splits its key tiles). Returns its kernels line row."""
    return split_combine_row(torch, "8B", hq=32, hk=8, d=128)


def split_combine_row(torch, label, *, hq, hk, d, window=None, soft_cap=None, decode=False,
                      splits=None, specs=None, T=None, dtype=None):
    """A split attention launch by a direct call, for its workspace, then
    the merge against its plain version on it, timed in a CUDA graph: the
    ragged kernel on a 256-query prefill chunk at positions 1,792-2,047 (or
    on ``specs``, (q_len, kv_len) a sequence, in a token bucket of ``T``),
    or (``decode``) the fused kernel on 8 decode rows of 1,800-2,047 keys
    (bf16 cache, block 16), with the route's plan, which must split, or with
    ``splits`` where the plan takes none at this shape. Returns its kernels
    line row; the bound counts the split rows' partials read once and their
    outputs written once. ``dtype``: the queries', cache's and output's
    (bf16 by default; fp16 runs the fp16 instantiations)."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    specs = specs or ([(1, int(k)) for k in rng.integers(1800, 2048, size=8)] if decode
                      else [(256, 2048)])
    dtype = dtype or torch.bfloat16
    dtype_name = str(dtype).split(".")[1]
    b = make_batch(rng, specs, hq=hq, hk=hk, d=d, bs=16, dtype=dtype,
                   num_blocks=max(256, variant_blocks(specs, 16)), decode_only=decode, device=dev,
                   T=T)
    q, m, cache = b["q"], b["meta"], b["cache"]
    T, Hq, D = q.shape
    S, P = m.block_tables.shape
    Hk = cache.shape[2] // (2 * D)
    stream = cuda_lib.current_stream_handle(dev)
    if decode:
        planned, bq, min_tiles = pa.fused_splits_for(q, m, Hk, None), 1, pa.FUSED_MIN_TILES
        what = f"8 decode rows, fused kernel, the plan's {planned} splits"
    else:
        plan = pa.rpa_plan_for(q, m, Hk, None)
        planned, bq, min_tiles = plan.splits, plan.tokens, pa.RPA_MIN_TILES
        what = (f"{'prefill chunk' if len(specs) == 1 else f'{len(specs)} sequences'}, "
                f"{plan.warps} warps, the plan's {planned} splits")
    if splits is None:
        splits = planned
        if splits < 2:
            raise AssertionError(f"split combine {label}: the plan takes {splits} split "
                                 f"({what})")
    else:
        what += f", launched with {splits}"
    ws_o = torch.empty((splits, T, Hq, D), dtype=torch.float32, device=dev)
    ws_ml = torch.empty((splits, T, Hq, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    common = (m.block_tables.data_ptr(), m.seq_lens.data_ptr(), m.query_start_loc.data_ptr(),
              m.num_seqs.data_ptr(), None, out.data_ptr(), ws_o.data_ptr(), ws_ml.data_ptr())
    if decode:
        pa.fused_route(q, None)(
            q.data_ptr(), b["k"].data_ptr(), b["v"].data_ptr(), cache.data_ptr(), None, None,
            m.slot_mapping.data_ptr(), *common, T, S, Hq, Hk, D, P, m.block_size,
            cache.shape[0] * m.block_size, splits, min_tiles, D ** -0.5, window or 0,
            soft_cap or 0.0, stream, device=dev)
    else:
        pa.ragged_route(q, None)(
            q.data_ptr(), cache.data_ptr(), None, *common, T, S, Hq, Hk, D, P, m.block_size,
            plan.warps, splits, min_tiles, D ** -0.5, window or 0, soft_cap or 0.0, stream,
            device=dev)
    before = out.clone()
    kw = dict(bq=bq, splits=splits, min_tiles=min_tiles, window=window)

    def run():
        pa.split_combine(ws_o, ws_ml, out, m, num_kv_heads=Hk, **kw)

    def plain():
        return pa.split_combine_plain(ws_o, ws_ml, before.clone(), m, **kw)

    run()
    want = plain()
    n = b["rows"]
    err = (out[:n].float() - want[:n].float()).abs().max().item()
    tol = ATTN_TOL[dtype_name]
    if not torch.allclose(out[:n].float(), want[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"{pa.combine_route(out).name} {label} disagrees: max |err| "
                             f"{err:.3e}")
    # The query tiles' split counts, as the kernels cut them: each
    # sequence's query rows in tiles of bq.
    nbytes = merged = 0
    tiles = [(kv - q + t0, kv - q + t0 + min(bq, q - t0) - 1, min(bq, q - t0))
             for q, kv in specs for t0 in range(0, q, bq)]
    for first, last, ntok in tiles:
        lo = max(0, first - window + 1) if window else 0
        n_tiles = last // pa.RPA_KEY_TILE + 1 - lo // pa.RPA_KEY_TILE
        k = max(1, min(splits, -(-n_tiles // min_tiles)))
        if k > 1:
            merged += k
            nbytes += k * ntok * Hq * (D + 2) * 4 + ntok * Hq * D * out.element_size()
    ms = graph_ms(torch, run)
    plain_ms = cuda_ms(plain, iters=2, warmup=1)
    bound_ms, by = bound(nbytes, 0, "float32")
    log(f"{pa.combine_route(out).name} {label} (D={D}, {what}, {merged} partial tiles): "
        f"{ms:.4f} ms in a CUDA graph (plain {plain_ms:.4f} ms), bound {bound_ms:.4f} ms by "
        f"{by}, max |err| {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                bound_by=by)


# ------------------------------------------------ phase 2: float16 (A–H)
# The fp16 variant grid: every head dim over a cache in the queries' dtype,
# 32/64/128 over the 1-byte caches, block sizes of one and of several pages
# a key tile, GQA groups 1, 3 and 8.
FP16_VARIANT_BLOCK_SIZES = (16, 64)
FP16_VARIANT_GROUPS = (1, 3, 8)


def check_fp16_occupancy(torch):
    """The plans read the bf16 instantiations' occupancy for fp16 calls too
    (``ops/paged_attention.py`` ``_rpa_slots``, ``_fused_slots``): the card's
    occupancy calculator must give the fp16 ones the same blocks an SM."""
    import ctypes

    from atoma_infer_tpu_torch.ops import cuda_lib

    checked, pairs = 0, []
    for suffix, dims in (("", (64, 96, 128, 256)), ("_int8", (64, 128)), ("_fp8", (64, 128)),
                         ("_int8_wide", WIDE_HEAD_DIMS), ("_fp8_wide", WIDE_HEAD_DIMS)):
        for stem, entry, args in (
                ("paged_attention", "atoma_rpa_mma_blocks_per_sm", [(d, w) for d in dims
                                                                   for w in (4, 8)]),
                ("fused_decode_split", "atoma_fused_split_blocks_per_sm",
                 [(d, g) for d in dims for g in (1, 4, 8, 12, 16)])):
            # The bf16 tensor-core ragged kernels at the narrow widths build
            # in sources of their own (``paged_attention{,_int8,_fp8}_mma.cu``).
            own = stem == "paged_attention" and "wide" not in suffix
            pairs.append((getattr(cuda_lib.load(f"{stem}{suffix}{'_mma' if own else ''}.cu"),
                                  f"{entry}{suffix}"),
                          getattr(cuda_lib.load(f"{stem}{suffix}_f16.cu"), f"{entry}{suffix}_f16"),
                          f"{entry}{suffix}", args))
    # The width 512: both entries in each (cache kind, queries' dtype) source.
    for suffix in ("", "_int8", "_fp8"):
        for entry, args in (("atoma_rpa_mma_blocks_per_sm", [(d, 4) for d in (320, 512)]),
                            ("atoma_fused_split_blocks_per_sm",
                             [(d, g) for d in (320, 512) for g in (1, 4, 16)])):
            pairs.append((getattr(cuda_lib.load(f"paged_attention{suffix}_w512.cu"),
                                  f"{entry}{suffix}_w512"),
                          getattr(cuda_lib.load(f"paged_attention{suffix}_w512_f16.cu"),
                                  f"{entry}{suffix}_w512_f16"),
                          f"{entry}{suffix}_w512", args))
    for bf, hf, name, args in pairs:
        for fn in (bf, hf):
            fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for a, b in args:
            if bf(a, b) != hf(a, b) or bf(a, b) < 1:
                raise AssertionError(f"{name}({a}, {b}): bf16 {bf(a, b)} blocks an SM, fp16 "
                                     f"{hf(a, b)}")
            checked += 1
    log(f"fp16 occupancy: {checked} instantiations hold as many blocks an SM as their bf16 ones")


def check_fp16_variants(torch):
    """Every fp16 attention instantiation at small sizes against its plain
    version (``FP16_VARIANT_*``): A, B and C over an fp16 cache, D and E
    (and their writes) over INT8 and e4m3 caches, at head dims
    32/64/96/128/256, on a mixed batch with a row cut into KV splits and on
    a pure-decode batch; writes and fused caches bit-exact."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    tol = ATTN_TOL["float16"]
    worst, cases = 0.0, 0
    for kv in (None,) + KV8_DTYPES:
        for d in ALL_HEAD_DIMS:
            for bs in FP16_VARIANT_BLOCK_SIZES:
                for group in FP16_VARIANT_GROUPS:
                    shape = dict(hq=2 * group, hk=2, d=d, bs=bs, dtype=torch.float16,
                                 num_blocks=variant_blocks(VARIANT_MIXED + VARIANT_DECODE, bs),
                                 device=dev)
                    label = f"float16 {kv or 'fp16'} cache D={d} bs={bs} G={group}"
                    for decode, specs in ((False, VARIANT_MIXED), (True, VARIANT_DECODE)):
                        b = make_batch(rng, specs, decode_only=decode, **shape)
                        if kv is not None:
                            err, _, _ = check_kv8(torch, b, kv, label, tol, decode=decode)
                        else:
                            err = check_same_cache_attention(torch, b, label, tol, decode=decode)
                        worst = max(worst, err)
                    cases += 1
    log(f"fp16 variants: {cases} shapes × 3 kernels agree (C, A, B over fp16, INT8 and e4m3 "
        f"caches), writes and fused caches bit-exact, max |err| {worst:.3e} (tol {tol})")


def check_same_cache_attention(torch, b, label, tol, *, decode, **kw):
    """One batch over a cache of its queries' dtype: mixed, the write C
    bit-exact then the ragged kernel on the written cache; decode, the
    fused kernel with its cache bit-exact. Returns the max |err| against the
    plain version."""
    from atoma_infer_tpu_torch.ops import kv_write
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    m, n, d = b["meta"], b["rows"], b["q"].shape[2]
    scale = d ** -0.5
    got_c, want_c = b["cache"].clone(), b["cache"].clone()
    if decode:
        out = pa.ragged_paged_attention_fused_cuda(b["q"], got_c, b["k"], b["v"], m, scale=scale,
                                                   **kw)
        ref = pa.fused_decode_attention_plain(b["q"], want_c, b["k"], b["v"], m, scale=scale, **kw)
        what = pa.fused_route(b["q"], None).name
    else:
        kv_write.write_kv_cache_cuda(got_c, b["k"], b["v"], m.slot_mapping)
        kv_write.write_kv_cache_plain(want_c, b["k"], b["v"], m.slot_mapping)
        what = "the KV write"
    if not same_bytes(torch, got_c, want_c):
        raise AssertionError(f"{what} {label}: cache not bit-exact")
    if not decode:
        out = pa.ragged_paged_attention_cuda(b["q"], got_c, m, scale=scale, **kw)
        ref = pa.ragged_paged_attention_paged_plain(b["q"], got_c, m, scale=scale, **kw)
        what = pa.ragged_route(b["q"], None).name
    err = (out[:n].float() - ref[:n].float()).abs().max().item()
    if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what} {label} disagrees: max |err| {err:.3e}")
    return err


def check_fp16_kernels(torch):
    """Every fp16 instantiation of A–H against its plain version at the
    bf16 rows' shapes, then timed: C, A (and its window, soft-cap and ALiBi
    cases) and B at the Llama-3.2-1B attention shapes (514-row mixed batch,
    64 decode rows), the merge after A's split prefill chunk at the 8B
    shapes; the INT8 and e4m3 writes, D and E (ragged and split fused) at
    the Llama-3.1-8B shapes; F, G and H at the 8B gate projection (M = 8,
    the kernels line's row, and M = 256), beside ``torch.mm`` in fp16. Each
    call's route is checked by the launch counters. Returns the kernels
    line's rows."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import cuda_lib, kv_write, quant
    from atoma_infer_tpu_torch.ops import paged_attention as pa
    from atoma_infer_tpu_torch.ops import quant_kernels as qk
    from atoma_infer_tpu_torch.ops.attention import alibi_slopes

    dev = torch.device("cuda")
    f16 = torch.float16
    tol = ATTN_TOL["float16"]
    check_fp16_occupancy(torch)
    rows = {}

    def launched(name, fn):
        before = cuda_lib.KERNELS[name].launches
        out = fn()
        if cuda_lib.KERNELS[name].launches <= before:
            raise AssertionError(f"{name} was not launched: another route ran")
        return out

    # The 1B shapes: the same batches as check_kernels' (its seed).
    rng = np.random.default_rng(0)
    mixed_specs, decode_specs = kernel_line_specs(rng)
    mixed = make_batch(rng, mixed_specs, dtype=f16, num_blocks=4096, decode_only=False,
                       device=dev)
    decode = make_batch(rng, decode_specs, dtype=f16, num_blocks=8192, decode_only=True,
                        device=dev)
    m, dm, n, scale = mixed["meta"], decode["meta"], mixed["rows"], D ** -0.5
    launched("reshape_and_cache_f16", lambda: check_same_cache_attention(
        torch, mixed, "1B mixed", tol, decode=False))
    cache = mixed["cache"]
    kv_write.write_kv_cache_cuda(cache, mixed["k"], mixed["v"], m.slot_mapping)
    valid = m.slot_mapping >= 0
    slots = m.slot_mapping[valid].long()
    fused_rows = torch.stack([mixed["k"], mixed["v"]], 2).reshape(mixed["k"].shape[0], -1)[valid]
    flat = cache.view(-1, cache.shape[-1])
    rows["reshape_and_cache_f16"] = dict(
        max_abs_err=0.0,
        ms=graph_ms(torch, lambda: kv_write.write_kv_cache_cuda(cache, mixed["k"], mixed["v"],
                                                                m.slot_mapping)),
        plain_ms=cuda_ms(lambda: kv_write.write_kv_cache_plain(cache, mixed["k"], mixed["v"],
                                                               m.slot_mapping)),
        library_ms=graph_ms(torch, lambda: flat.index_copy_(0, slots, fused_rows)),
        bytes=n * 2 * (2 * HK * D * 2) + m.slot_mapping.numel() * 4, flops=0)
    for label, kw in (("base", {}), ("sliding_window", dict(sliding_window=256)),
                      ("soft_cap", dict(soft_cap=30.0)),
                      ("alibi", dict(alibi_slopes=alibi_slopes(HQ, device=dev)))):
        out = launched("ragged_paged_attention_mma_f16", lambda: pa.ragged_paged_attention_cuda(
            mixed["q"], cache, m, scale=scale, **kw))
        ref = pa.ragged_paged_attention_paged_plain(mixed["q"], cache, m, scale=scale, **kw)
        a_err = (out[:n].float() - ref[:n].float()).abs().max().item()
        if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
            raise AssertionError(f"ragged_paged_attention_mma_f16 1B {label}: {a_err:.3e}")
        b_err = launched("fused_decode_attention_split_f16", lambda: check_same_cache_attention(
            torch, decode, f"1B decode {label}", tol, decode=True, **kw))
        log(f"float16 1B {label}: ragged_paged_attention_mma_f16 max |err| {a_err:.3e}, "
            f"fused_decode_attention_split_f16 max |err| {b_err:.3e} (cache bit-exact), tol {tol}")
        if label == "base":
            nbytes, flops = attention_work(mixed_specs, None, 2, fused=False)
            rows["ragged_paged_attention_mma_f16"] = dict(
                max_abs_err=a_err,
                ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(mixed["q"], cache, m,
                                                                  scale=scale)),
                plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                    mixed["q"], cache, m, scale=scale), iters=5, warmup=1),
                library_ms=None, bytes=nbytes, flops=flops)
            dcache = decode["cache"].clone()
            nbytes, flops = attention_work(decode_specs, None, 2, fused=True)
            rows["fused_decode_attention_split_f16"] = dict(
                max_abs_err=b_err,
                ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                    decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale)),
                plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                    decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale),
                    iters=5, warmup=1),
                library_ms=None, bytes=nbytes, flops=flops)
    del mixed, decode, cache, dcache, flat, fused_rows
    torch.cuda.empty_cache()
    combine = split_combine_row(torch, "8B fp16", hq=32, hk=8, d=128, dtype=f16)

    # The 8B shapes: the INT8 and e4m3 writes, D and E (check_kv8_kernels'
    # batches).
    rng = np.random.default_rng(1)
    mixed_specs, decode_specs = kernel_line_specs(rng)
    shape = dict(hq=32, hk=8, d=128, bs=16, dtype=f16, device=dev)
    mixed = make_batch(rng, mixed_specs, num_blocks=4096, decode_only=False, **shape)
    decode = make_batch(rng, decode_specs, num_blocks=8192, decode_only=True, **shape)
    m, dm, n, scale = mixed["meta"], decode["meta"], mixed["rows"], 128 ** -0.5
    for kv in KV8_DTYPES:
        extra = 4 if kv == "int8" else 0
        work = dict(kv_elt=1, slot_extra=extra, hq=32, hk=8, d=128)
        err, c, sc = launched(f"reshape_and_cache_{kv}_f16", lambda: launched(
            f"ragged_paged_attention_{kv}_mma_f16",
            lambda: check_kv8(torch, mixed, kv, "8B mixed fp16", tol, decode=False)))
        derr, dc, dsc = launched(f"fused_decode_attention_{kv}_split_f16", lambda: check_kv8(
            torch, decode, kv, "8B decode fp16", tol, decode=True))
        log(f"float16 8B {kv} KV: reshape_and_cache_{kv}_f16 bit-exact on {n} rows, "
            f"ragged_paged_attention_{kv}_mma_f16 max |err| {err:.3e}, "
            f"fused_decode_attention_{kv}_split_f16 max |err| {derr:.3e} (cache and scales "
            f"bit-exact), tol {tol}")

        def write(c=c, sc=sc):
            kv8_write(c, sc, mixed["k"], mixed["v"], m.slot_mapping, cuda=True)

        rows[f"reshape_and_cache_{kv}_f16"] = dict(
            max_abs_err=0.0, ms=graph_ms(torch, write),
            plain_ms=cuda_ms(lambda: kv8_write(c, sc, mixed["k"], mixed["v"], m.slot_mapping,
                                               cuda=False)),
            library_ms=None,
            bytes=n * (2 * 8 * 128 * 2 + 2 * 8 * 128 + extra) + m.slot_mapping.numel() * 4,
            flops=0)
        nbytes, flops = attention_work(mixed_specs, None, 2, fused=False, **work)
        rows[f"ragged_paged_attention_{kv}_mma_f16"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(mixed["q"], c, m, scale=scale,
                                                              kv_scales=sc)),
            plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                mixed["q"], c, m, scale=scale, kv_scales=sc), iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops)
        nbytes, flops = attention_work(decode_specs, None, 2, fused=True, **work)
        rows[f"fused_decode_attention_{kv}_split_f16"] = dict(
            max_abs_err=derr,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], dc, decode["k"], decode["v"], dm, scale=scale, kv_scales=dsc)),
            plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                decode["q"], dc, decode["k"], decode["v"], dm, scale=scale, kv_scales=dsc),
                iters=5, warmup=1),
            library_ms=None, bytes=nbytes, flops=flops)
        del c, sc, dc, dsc
    del mixed, decode
    torch.cuda.empty_cache()
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"), "float16")
    rows["paged_attention_split_combine_f16"] = combine

    # F, G and H at the 8B gate projection, fp16 activations.
    K, N, group = QMM_SHAPES[QMM_LINE_SHAPE]
    gen = torch.Generator(device=dev).manual_seed(15)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.02
    for bits in (8, 4):
        qt = quant.quantize_weight(w, bits, group)
        w_bytes = qt.qweight.numel() + qt.scales.numel() * 2
        copies = [qt] + [quant.QuantizedTensor(qt.qweight.clone(), qt.scales.clone(), bits, group)
                         for _ in range(-(-128_000_000 // w_bytes) - 1)]
        dense = [quant.dequantize_weight(c, f16) for c in copies]
        iters = max(2, 20 // len(copies))
        kinds = [(f"quantized_matmul_int{bits}_mma_f16", False)]
        if bits == 8:
            kinds.append(("quantized_matmul_w8a8_mma_f16", True))
        for M in (QMM_LINE_M, 256):
            x = torch.randn(M, K, generator=gen, device=dev).to(f16)
            xq, act = qk.quantize_activations(x)
            library_ms = graph_ms(torch, lambda x=x: [torch.mm(x, d) for d in dense],
                                  iters=iters) / len(copies)
            for name, w8a8 in kinds:
                if w8a8:
                    def run(c, xq=xq, act=act):
                        return qk.w8a8_matmul_cuda(xq, c.qweight, c.scales, act, bits=bits,
                                                   group_size=group, out_dtype=f16)

                    def plain(xq=xq, act=act):
                        return qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act, bits=bits,
                                                    group_size=group, out_dtype=f16)
                else:
                    def run(c, x=x):
                        return qk.quantized_matmul_cuda(x, c.qweight, c.scales, bits=bits,
                                                        group_size=group)

                    def plain(x=x):
                        return qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=bits,
                                                         group_size=group)
                got = launched(name, lambda: run(qt))
                if got.dtype != f16:
                    raise AssertionError(f"{name}: output {got.dtype}")
                rel, err = rel_err(got, plain())
                if not rel <= QMM_TOL["float16"]:
                    raise AssertionError(f"{name} M={M}: rel err {rel:.3e}")
                ms = graph_ms(torch, lambda: [run(c) for c in copies], iters=iters) / len(copies)
                plain_ms = graph_ms(torch, plain, iters=2)
                nbytes, flops = qmm_work(M, K, N, group, bits=bits, x_bytes=1 if w8a8 else 2,
                                         w8a8=w8a8)
                bound_ms, bound_by = bound(nbytes, flops, "int8" if w8a8 else "float16")
                log(f"{name} {bits}-bit {QMM_LINE_SHAPE} K={K} N={N} M={M}: {ms:.4f} ms (plain "
                    f"{plain_ms:.4f} ms, torch.mm fp16 {library_ms:.4f} ms), bound "
                    f"{bound_ms:.4f} ms by {bound_by}, max |err| {err:.3e} (rel {rel:.2e}, tol "
                    f"{QMM_TOL['float16']})")
                if M == QMM_LINE_M:
                    rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      library_ms=library_ms, bound_ms=bound_ms,
                                      bound_by=bound_by)
        del copies, dense
        torch.cuda.empty_cache()
    for name, r in rows.items():
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}), bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    return rows

# The attention shapes of the families whose head dims only the bf16 route
# takes, from their public config.json: (label, Hq, Hk, D, the score
# modifiers their layers pass the kernels, how the merge is timed). At
# Phi-3-mini's 32 kv heads the routes' plans never split: 8 sequence slots
# (the smallest bucket) × 32 kv heads is 256 blocks, past 80% of the 264 a
# card holds of either kernel, so its merge is timed after the fused kernel
# launched with 4 splits by a direct call, and has no launch on its path.
WIDE_HEAD_SHAPES = (
    ("Phi-3-mini", 32, 32, 96, dict(sliding_window=2047), dict(decode=True, splits=4)),
    ("Gemma-2-9B", 16, 8, 256, dict(soft_cap=50.0), {}),
    # Gemma-2-9B's widths at head dim 512 (HEAD_DIM_FAMILIES): 8 q heads
    # over 4 kv heads; its prefill chunk fills the card unsplit, so the
    # merge follows the fused kernel on 8 long decode rows, which splits.
    ("Gemma-2-9B D=512", 8, 4, 512, dict(soft_cap=50.0), dict(decode=True)),
    # Past 512, the width 512's column slices at Llama-3.1-8B's widths
    # (HEAD_DIM_FAMILIES): 4 q heads of 1,024 over one kv head (two slices),
    # and 2 of 2,048 (four; no service: its rows are logged, not in the
    # kernels line).
    ("Llama-3.1-8B D=1024", 4, 1, 1024, {}, dict(decode=True)),
    ("Llama-3.1-8B D=2048", 2, 1, 2048, {}, dict(decode=True)),
)
# The head dim past 512 whose rows the kernels line lists, their launches
# those of the services past 512 (every one in column slices).
PAST_512_LINE_DIM = 1024


def check_wide_head_kernels(torch):
    """A, B, C and the merge at the attention shapes of Phi-3-mini (D = 96,
    32 kv heads, window 2,047) and Gemma-2-9B (D = 256, 2 q heads per kv
    head, soft cap 50), bf16 over a bf16 cache, block 16 (then D, E, the
    1-byte writes and the f32 queries' kernels at the same shapes:
    :func:`wide_head_other_rows`): the write
    bit-exact on a mixed batch (3 chunks and 29 decode rows of 16-1,023
    keys: the plain version gathers every row's whole context in f32, which
    2,048 keys of 32 heads of 96 would take past 50 GB for); the ragged
    kernel on it and the fused kernel on 64 decode rows of 16-2,047 keys
    within the tolerance (caches bit-exact), each timed with CUDA events
    beside its bound and its plain version; the merge after a split prefill
    chunk (Gemma-2-9B) or after the fused kernel on 8 long decode rows
    launched with 4 splits (Phi-3-mini, whose plans never split:
    ``WIDE_HEAD_SHAPES``); at Gemma-2-9B's widths with head dim 512 (the
    ``*_w512`` kernels) the write C timed too; past 512 (Llama-3.1-8B's
    widths with heads of 1,024 and 2,048: the ``*_w512`` kernels in two and
    four column slices) A, B, D, E and the merge with bf16 queries, the
    services' route. Returns kernels-line rows keyed ``kernel@D``."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    tol = ATTN_TOL["bfloat16"]
    rows = {}
    for label, hq, hk, d, mods, merge in WIDE_HEAD_SHAPES:
        rng = np.random.default_rng(d)
        mixed_specs, decode_specs = kernel_line_specs(rng, max_keys=1024)
        shape = dict(hq=hq, hk=hk, d=d, bs=BS, dtype=torch.bfloat16, device=dev)
        mixed = make_batch(rng, mixed_specs, num_blocks=4096, decode_only=False, **shape)
        decode = make_batch(rng, decode_specs, num_blocks=8192, decode_only=True, **shape)
        m, n, scale = mixed["meta"], mixed["rows"], d ** -0.5
        window = mods.get("sliding_window")
        work = dict(hq=hq, hk=hk, d=d)

        got, want = mixed["cache"].clone(), mixed["cache"].clone()
        kv_write.write_kv_cache_cuda(got, mixed["k"], mixed["v"], m.slot_mapping)
        kv_write.write_kv_cache_plain(want, mixed["k"], mixed["v"], m.slot_mapping)
        if not torch.equal(got, want):
            raise AssertionError(f"reshape_and_cache {label} D={d} is not bit-exact")
        cache = got
        if d == W512:
            # C at the width 512, beside index_copy_ of the rows (K and V
            # side by side) into the flattened slots, both in CUDA graphs.
            row_bytes = 2 * hk * d * 2
            valid = m.slot_mapping >= 0
            slots = m.slot_mapping[valid].long()
            fused_rows = torch.stack([mixed["k"], mixed["v"]], 2).reshape(
                mixed["k"].shape[0], -1)[valid]
            flat = want.view(-1, want.shape[-1])
            rows[f"reshape_and_cache@{d}"] = r = dict(
                max_abs_err=0.0,
                ms=graph_ms(torch, lambda: kv_write.write_kv_cache_cuda(
                    cache, mixed["k"], mixed["v"], m.slot_mapping)),
                plain_ms=cuda_ms(lambda: kv_write.write_kv_cache_plain(
                    want, mixed["k"], mixed["v"], m.slot_mapping)),
                library_ms=graph_ms(torch, lambda: flat.index_copy_(0, slots, fused_rows)))
            del fused_rows, flat
            r["bound_ms"], r["bound_by"] = bound(
                2 * n * row_bytes + m.slot_mapping.numel() * 4, 0, "bfloat16")
            log(f"reshape_and_cache@{d} {label}: bit-exact on {n} rows, {r['ms']:.4f} ms in a "
                f"graph (plain {r['plain_ms']:.4f}, index_copy_ {r['library_ms']:.4f} ms), "
                f"bound {r['bound_ms']:.4f} ms")
        del want
        ragged_name = pa.ragged_route(mixed["q"], None).name
        fused_name = pa.fused_route(decode["q"], None).name

        def ragged():
            return pa.ragged_paged_attention_cuda(mixed["q"], cache, m, scale=scale, **mods)

        def ragged_plain():
            return pa.ragged_paged_attention_paged_plain(mixed["q"], cache, m, scale=scale,
                                                         **mods)

        out, ref = ragged(), ragged_plain()
        err = (out[:n].float() - ref[:n].float()).abs().max().item()
        if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
            raise AssertionError(f"ragged_paged_attention {label} D={d} disagrees: max |err| "
                                 f"{err:.3e}")
        del out, ref
        bound_ms, by = bound(*attention_work(mixed_specs, window, 2, fused=False, **work),
                             "bfloat16")
        rows[f"{ragged_name}@{d}"] = r = dict(
            max_abs_err=err, ms=cuda_ms(ragged), plain_ms=cuda_ms(ragged_plain, iters=3, warmup=1),
            library_ms=None, bound_ms=bound_ms, bound_by=by)
        log(f"{ragged_name} {label} mixed (D={d}, {mods}): {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f} ms), bound {bound_ms:.4f} ms by {by}, max |err| "
            f"{err:.3e} (tol {tol}), write bit-exact")

        dm, dn = decode["meta"], decode["rows"]
        got, want = decode["cache"].clone(), decode["cache"].clone()
        out = pa.ragged_paged_attention_fused_cuda(decode["q"], got, decode["k"], decode["v"], dm,
                                                   scale=scale, **mods)
        ref = pa.fused_decode_attention_plain(decode["q"], want, decode["k"], decode["v"], dm,
                                              scale=scale, **mods)
        err = (out[:dn].float() - ref[:dn].float()).abs().max().item()
        if not (torch.equal(got, want) and torch.allclose(
                out[:dn].float(), ref[:dn].float(), atol=tol, rtol=tol)):
            raise AssertionError(f"fused_decode_attention {label} D={d} disagrees: max |err| "
                                 f"{err:.3e}, cache bit-exact {torch.equal(got, want)}")
        del out, ref, want
        splits = pa.fused_splits_for(decode["q"], dm, hk, None)
        bound_ms, by = bound(*attention_work(decode_specs, window, 2, fused=True, **work),
                             "bfloat16")
        rows[f"{fused_name}@{d}"] = r = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], got, decode["k"], decode["v"], dm, scale=scale, **mods)),
            plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                decode["q"], got, decode["k"], decode["v"], dm, scale=scale, **mods),
                iters=3, warmup=1),
            library_ms=None, bound_ms=bound_ms, bound_by=by)
        log(f"{fused_name} {label} 64 decode rows (D={d}, {mods}, up to "
            f"{splits} splits): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms), bound "
            f"{bound_ms:.4f} ms by {by}, max |err| {err:.3e} (tol {tol}), cache bit-exact")
        del got
        rows.update(wide_head_other_rows(torch, label, mixed, decode, mixed_specs, decode_specs,
                                         mods, work))
        del mixed, decode, cache
        torch.cuda.empty_cache()
        rows[f"paged_attention_split_combine@{d}"] = split_combine_row(
            torch, label, hq=hq, hk=hk, d=d, window=window, soft_cap=mods.get("soft_cap"),
            **merge)
        torch.cuda.empty_cache()
    return rows


# The fp16 queries' wide 1-byte kernels are timed at the head dim where
# services of theirs launch them (run_fp16_services): Phi-3-mini over an
# INT8 and an e4m3 cache. (Gemma-2's activations overflow fp16; its head
# dim is checked in the fp16 variants.)
FP16_WIDE_FAMILY = "Phi-3-mini-4k-instruct"
FP16_WIDE_DIM = 96


def wide_head_other_rows(torch, label, mixed, decode, mixed_specs, decode_specs, mods, work):
    """At one wide family's shapes (``WIDE_HEAD_SHAPES``, the batches of
    :func:`check_wide_head_kernels`): D and E, ragged and fused, with bf16
    queries (the ``*_wide`` or ``*_w512`` tensor-core kernels), with fp16
    queries at ``FP16_WIDE_DIM`` and 512, and with f32 queries (the
    CUDA-core kernels), over INT8 and e4m3 caches made from the batches' bf16 ones;
    the 1-byte writes; A and B with f32 queries over an f32 cache (at the
    width 512 also with fp16 queries over an fp16 cache). Past 512 bf16
    queries only, as the services there run (``check_head_dim_variants``
    checks the other dtypes). Each
    against its plain version (writes, fused caches and INT8 scales
    bit-exact; attention within ``ATTN_TOL``), then timed with CUDA events
    (the writes in a CUDA graph) beside its bound. Returns rows keyed
    ``kernel@D``."""
    from atoma_infer_tpu_torch.ops import kv_write
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    d = mixed["q"].shape[2]
    window = mods.get("sliding_window")
    m, n, dm, dn = mixed["meta"], mixed["rows"], decode["meta"], decode["rows"]
    scale = d ** -0.5
    rows = {}

    def time_row(key, err, fn, plain, specs, elt, dtype_name, fused, **kvw):
        nbytes, flops = attention_work(specs, window, elt, fused=fused, **work, **kvw)
        bound_ms, by = bound(nbytes, flops, dtype_name)
        rows[key] = r = dict(max_abs_err=err, ms=cuda_ms(fn),
                             plain_ms=cuda_ms(plain, iters=2, warmup=1), library_ms=None,
                             bound_ms=bound_ms, bound_by=by)
        log(f"{key} {label} ({dtype_name} queries, {mods}): {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms), bound {bound_ms:.4f} ms by {by}, max |err| {err:.3e} "
            f"(tol {ATTN_TOL[dtype_name]})")

    def as_dtype(b, dtype):
        return dict(b, q=b["q"].to(dtype), k=b["k"].to(dtype), v=b["v"].to(dtype))

    queries = (("bfloat16", torch.bfloat16, 2), ("float16", torch.float16, 2),
               ("float32", torch.float32, 4))
    for kv in KV8_DTYPES:
        kvw = dict(kv_elt=1, slot_extra=4 if kv == "int8" else 0)
        kind = getattr(torch, _KINDS[kv])
        for dtype_name, dtype, elt in queries:
            if dtype_name == "float16" and d not in (FP16_WIDE_DIM, W512):
                continue
            if dtype_name != "bfloat16" and d > W512:
                continue  # past 512 only bf16 services: the grid checks the rest
            tol = ATTN_TOL[dtype_name]
            b = as_dtype(mixed, dtype)
            err, cache, scales = check_kv8(torch, b, kv, f"{label} mixed", tol, decode=False,
                                           **mods)
            if dtype_name == "bfloat16":
                row_in, row_out = 2 * work["hk"] * d * 2, 2 * work["hk"] * d + kvw["slot_extra"]
                rows[f"reshape_and_cache_{kv}@{d}"] = r = dict(
                    max_abs_err=0.0,
                    ms=graph_ms(torch, lambda: kv8_write(cache, scales, b["k"], b["v"],
                                                         m.slot_mapping, cuda=True)),
                    plain_ms=cuda_ms(lambda: kv8_write(cache, scales, b["k"], b["v"],
                                                       m.slot_mapping, cuda=False)),
                    library_ms=None)
                r["bound_ms"], r["bound_by"] = bound(
                    n * (row_in + row_out) + m.slot_mapping.numel() * 4, 0, "bfloat16")
                log(f"reshape_and_cache_{kv}@{d} {label}: bit-exact on {n} rows, {r['ms']:.4f} "
                    f"ms in a graph (plain {r['plain_ms']:.4f} ms), bound {r['bound_ms']:.4f} ms")
            time_row(f"{pa.ragged_route(b['q'], kind).name}@{d}", err,
                     lambda: pa.ragged_paged_attention_cuda(b["q"], cache, m, scale=scale,
                                                            kv_scales=scales, **mods),
                     lambda: pa.ragged_paged_attention_paged_plain(b["q"], cache, m, scale=scale,
                                                                   kv_scales=scales, **mods),
                     mixed_specs, elt, dtype_name, False, **kvw)
            del cache, scales
            bd = as_dtype(decode, dtype)
            err, dcache, dscales = check_kv8(torch, bd, kv, f"{label} decode", tol, decode=True,
                                             **mods)
            time_row(f"{pa.fused_route(bd['q'], kind).name}@{d}", err,
                     lambda: pa.ragged_paged_attention_fused_cuda(
                         bd["q"], dcache, bd["k"], bd["v"], dm, scale=scale, kv_scales=dscales,
                         **mods),
                     lambda: pa.fused_decode_attention_plain(
                         bd["q"], dcache, bd["k"], bd["v"], dm, scale=scale, kv_scales=dscales,
                         **mods),
                     decode_specs, elt, dtype_name, True, **kvw)
            del dcache, dscales, b, bd
            torch.cuda.empty_cache()
    # f32 queries over an f32 cache: A and B on the CUDA cores; at the width
    # 512 also fp16 queries over an fp16 cache (A and B's fp16 instantiations).
    same = (("float32", torch.float32, 4),) + ((("float16", torch.float16, 2),)
                                               if d == W512 else ())
    for dtype_name, dtype, elt in same if d <= W512 else ():
        tol = ATTN_TOL[dtype_name]
        b = as_dtype(mixed, dtype)
        cache = mixed["cache"].to(dtype)
        kv_write.write_kv_cache_cuda(cache, b["k"], b["v"], m.slot_mapping)
        out = pa.ragged_paged_attention_cuda(b["q"], cache, m, scale=scale, **mods)
        ref = pa.ragged_paged_attention_paged_plain(b["q"], cache, m, scale=scale, **mods)
        err = (out[:n].float() - ref[:n].float()).abs().max().item()
        if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
            raise AssertionError(f"ragged_paged_attention {label} {dtype_name} D={d} "
                                 f"disagrees: {err:.3e}")
        del out, ref
        time_row(f"{pa.ragged_route(b['q'], None).name}@{d}", err,
                 lambda: pa.ragged_paged_attention_cuda(b["q"], cache, m, scale=scale, **mods),
                 lambda: pa.ragged_paged_attention_paged_plain(b["q"], cache, m, scale=scale,
                                                               **mods),
                 mixed_specs, elt, dtype_name, False)
        del b, cache
        bd = as_dtype(decode, dtype)
        got, want = decode["cache"].to(dtype), decode["cache"].to(dtype)
        out = pa.ragged_paged_attention_fused_cuda(bd["q"], got, bd["k"], bd["v"], dm,
                                                   scale=scale, **mods)
        ref = pa.fused_decode_attention_plain(bd["q"], want, bd["k"], bd["v"], dm, scale=scale,
                                              **mods)
        err = (out[:dn].float() - ref[:dn].float()).abs().max().item()
        if not (torch.equal(got, want) and torch.allclose(out[:dn].float(), ref[:dn].float(),
                                                          atol=tol, rtol=tol)):
            raise AssertionError(f"fused_decode_attention {label} {dtype_name} D={d} "
                                 f"disagrees: {err:.3e}, cache bit-exact "
                                 f"{torch.equal(got, want)}")
        del out, ref, want
        time_row(f"{pa.fused_route(bd['q'], None).name}@{d}", err,
                 lambda: pa.ragged_paged_attention_fused_cuda(bd["q"], got, bd["k"], bd["v"],
                                                              dm, scale=scale, **mods),
                 lambda: pa.fused_decode_attention_plain(bd["q"], got, bd["k"], bd["v"], dm,
                                                         scale=scale, **mods),
                 decode_specs, elt, dtype_name, True)
        del bd, got
    torch.cuda.empty_cache()
    return rows


def check_prefill_chunk(torch):
    """A 256-query prefill chunk at positions 1,792-2,047 of a 2,048-token
    prompt at the Llama-3.1-8B attention shapes (Hq=32, Hk=8, D=128, block
    16), bf16 queries over a bf16, an INT8 and an e4m3 cache: the tensor-core
    kernel against its plain version (timed once, at bf16), then timed
    eagerly and in a CUDA graph (which also shows the launch capturable)
    beside its bound, the CUDA-core kernel by a direct launch, and flash
    SDPA over the same keys gathered contiguous and widened to bf16 — not
    the same function: no paging, and all 2,048 keys for every query
    (flash's causal mask is top-left aligned; the chunk's is bottom-right)."""
    import numpy as np
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from atoma_infer_tpu_torch.ops import paged_attention as pa
    from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view, scales_flat

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    specs = [(256, 2048)]
    shape = dict(hq=32, hk=8, d=128, bs=16, dtype=torch.bfloat16, device=dev)
    b = make_batch(rng, specs, num_blocks=256, decode_only=False, **shape)
    m, n, scale = b["meta"], b["rows"], 128 ** -0.5
    tol = ATTN_TOL["bfloat16"]
    pos = torch.arange(2048, device=dev)
    slots = m.block_tables[0, pos // 16].long() * 16 + pos % 16
    for kv in (None,) + KV8_DTYPES:
        name = "ragged_paged_attention" + (f"_{kv}" if kv else "") + "_mma"
        cache, scales = kv8_cache(torch, b["cache"], kv, 128) if kv else (b["cache"], None)
        plan = pa.rpa_plan_for(b["q"], m, 8, None if kv is None else cache.dtype)

        def run(cache=cache, scales=scales):
            return pa.ragged_paged_attention_cuda(b["q"], cache, m, scale=scale, kv_scales=scales)

        out = run()
        t0 = time.monotonic()
        ref = pa.ragged_paged_attention_paged_plain(b["q"], cache, m, scale=scale,
                                                    kv_scales=scales)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t0
        err = (out[:n].float() - ref[:n].float()).abs().max().item()
        if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
            raise AssertionError(f"{name} prefill chunk disagrees: max |err| {err:.3e}")
        ms, g_ms = cuda_ms(run), graph_ms(torch, run)
        old_ms = old_vs_new(torch, f"{name[:-4]} 8B prefill chunk", ms, lambda: cuda_core_attention(
            b["q"], cache, m, scale=scale, kv_scales=scales), ref, n)
        # Flash SDPA over the sequence's keys, gathered and widened beforehand.
        k_view, v_view = kv_cache_view(cache, 8, 128)
        k, v = k_view[slots].float(), v_view[slots].float()
        if scales is not None:
            ks, vs = scales_flat(scales)
            k, v = k * ks[slots].float()[:, None, None], v * vs[slots].float()[:, None, None]
        k, v = (t.to(torch.bfloat16).repeat_interleave(4, dim=1).transpose(0, 1)[None]
                for t in (k, v))
        qs = b["q"][:n].transpose(0, 1)[None]
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            sdpa_ms = graph_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, k, v, scale=scale))
        bound_ms, by = bound(*attention_work(
            specs, None, 2, fused=False, kv_elt=1 if kv else 2, slot_extra=4 if kv == "int8" else 0,
            hq=32, hk=8, d=128), "bfloat16")
        log(f"{name} 8B prefill chunk (256 queries at 1,792-2,047, plan {plan.warps} warps, "
            f"{plan.splits} splits): {ms:.4f} ms eager, {g_ms:.4f} ms in a CUDA graph, bound "
            f"{bound_ms:.4f} ms by {by}; CUDA-core rpa_kernel {old_ms:.4f} ms; flash SDPA on "
            f"the keys gathered contiguous {sdpa_ms:.4f} ms (not the same function: no paging, "
            f"no causal mask); max |err| {err:.3e} (tol {tol})"
            + (f"; plain version {plain_s * 1e3:.1f} ms (once)" if kv is None else ""))
        del cache, scales, ref, out, k, v
    del b
    torch.cuda.empty_cache()


# Llama-3.2-3B's attention shapes, in make_batch's names.
LLAMA_3B_HEADS = dict(hq=LLAMA_3B["num_attention_heads"], hk=LLAMA_3B["num_key_value_heads"],
                      d=LLAMA_3B["head_dim"])


def check_gqa_block_kernels(torch):
    """A, B, D and E at the Llama-3.2-3B attention shapes (3 query heads per
    kv head), bf16 queries, over a bf16, an INT8 and an e4m3 cache: the
    fused kernels on 64 decode sequences at block 16, the ragged ones on a
    mixed batch at block 16 and at block 64 (key tiles of 32 keys), each
    against its plain version (fused caches and scales bit-exact), then
    timed with CUDA events beside their bounds."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    tol, scale = ATTN_TOL["bfloat16"], 128 ** -0.5
    for bs in (16, 64):
        rng = np.random.default_rng(2)  # the same sequences at both block sizes
        mixed_specs, decode_specs = kernel_line_specs(rng)
        shape = dict(LLAMA_3B_HEADS, bs=bs, dtype=torch.bfloat16, device=dev)
        mixed = make_batch(rng, mixed_specs, num_blocks=65536 // bs, decode_only=False, **shape)
        decode = make_batch(rng, decode_specs, num_blocks=131072 // bs, decode_only=True,
                            **shape)
        m, n = mixed["meta"], mixed["rows"]
        for kv in (None,) + KV8_DTYPES:
            suffix = f"_{kv}" if kv else ""
            extra = 4 if kv == "int8" else 0
            work = dict(kv_elt=1 if kv else 2, slot_extra=extra, **LLAMA_3B_HEADS)
            if kv:
                cache, scales = kv8_cache(torch, mixed["cache"], kv, 128)
            else:
                cache, scales = mixed["cache"], None
            out = pa.ragged_paged_attention_cuda(mixed["q"], cache, m, scale=scale,
                                                 kv_scales=scales)
            ref = pa.ragged_paged_attention_paged_plain(mixed["q"], cache, m, scale=scale,
                                                        kv_scales=scales)
            err = (out[:n].float() - ref[:n].float()).abs().max().item()
            if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
                raise AssertionError(f"ragged_paged_attention{suffix} 3B bs={bs} disagrees: "
                                     f"max |err| {err:.3e}")
            ms = cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                mixed["q"], cache, m, scale=scale, kv_scales=scales))
            bound_ms, by = bound(*attention_work(mixed_specs, None, 2, fused=False, **work),
                                 "bfloat16")
            log(f"ragged_paged_attention{suffix} 3B mixed bs={bs}: {ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {by}, max |err| {err:.3e} (tol {tol})")
            if bs != 16:
                continue
            if kv:
                err, dcache, dscales = check_kv8(torch, decode, kv, "3B decode G=3", tol,
                                                 decode=True)
            else:
                dcache, dscales = decode["cache"].clone(), None
                want = decode["cache"].clone()
                out = pa.ragged_paged_attention_fused_cuda(
                    decode["q"], dcache, decode["k"], decode["v"], decode["meta"], scale=scale)
                ref = pa.fused_decode_attention_plain(
                    decode["q"], want, decode["k"], decode["v"], decode["meta"], scale=scale)
                dn = decode["rows"]
                err = (out[:dn].float() - ref[:dn].float()).abs().max().item()
                if not (torch.equal(dcache, want) and torch.allclose(
                        out[:dn].float(), ref[:dn].float(), atol=tol, rtol=tol)):
                    raise AssertionError(f"fused_decode_attention 3B G=3 disagrees: max |err| "
                                         f"{err:.3e}")
            ms = cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], dcache, decode["k"], decode["v"], decode["meta"], scale=scale,
                kv_scales=dscales))
            old_ms = cuda_ms(lambda: cuda_core_fused(decode["q"], dcache, decode["k"], decode["v"],
                                                     decode["meta"], scale=scale,
                                                     kv_scales=dscales))
            bound_ms, by = bound(*attention_work(decode_specs, None, 2, fused=True, **work),
                                 "bfloat16")
            log(f"fused_decode_attention{suffix}_split 3B decode G=3 bs={bs}: {ms:.4f} ms "
                f"(unsplit kernel by a direct launch {old_ms:.4f} ms), bound {bound_ms:.4f} ms "
                f"by {by}, max |err| {err:.3e} (tol {tol}), cache bit-exact")
        del mixed, decode, cache, scales
        torch.cuda.empty_cache()


# Groups of 9 to 16 q heads per kv head, which the fused kernels take in
# both halves of their m16 tile (one instantiation, the group at run time),
# and past 16, whose decode steps take the write and the ragged kernel (17,
# 32; and 128, the ragged kernels' limit, where the CUDA-core kernel cuts a
# token's group over 2 to 4 blocks): the variant grid's groups and head
# dims (64, 128 and 256, and Phi-3-mini's 96 for a wide dim), at blocks of
# 16.
GROUP_VARIANT_GROUPS = (9, 12, 16, 17, 32, 128)
GROUP_VARIANT_DIMS = (64, 96, 128, 256)
# The timed rows' shapes at 64 decode rows (and a mixed batch for the ragged
# kernels): Mistral-Large-Instruct-2407's attention (96 q heads over 8 kv
# heads, D = 128) over a bf16 cache, Llama-3.1-405B's per-rank shape at
# tp = 8 (16 q heads over 1 kv head of its 8) over INT8 and e4m3 caches,
# and Llama-3.1-8B's widths with its 32 q heads over one kv head (G = 32,
# whose decode rows take the write and the ragged kernel) over bf16 and
# INT8 caches. label -> (Hq, Hk, the model's Hk, caches).
GROUP_ATTENTION_SHAPES = {
    "Mistral-Large-2 G=12": (96, 8, 8, (None,)),
    "Llama-3.1-405B tp=8 G=16": (16, 1, 8, KV8_DTYPES),
    "Llama-3.1-8B MQA G=32": (32, 1, 1, (None, "int8")),
}
# The f32 queries' CUDA-core ragged kernel (rpa_kernel) timed on 64 decode
# rows at these groups (q heads over one kv head, D = 128): the f32
# test-size services' route past 16.
F32_GROUP_ROWS = (17, 32)


def check_group_variants(torch):
    """The attention instantiations at 9 to 128 q heads per kv head
    (``GROUP_VARIANT_*``) against their plain versions: bf16 and fp16
    queries (the split fused kernels, both halves of the tile, the
    tensor-core ragged ones and their merge) and f32 queries (the CUDA-core
    kernels) over a cache of the queries' dtype, an INT8 one and an e4m3
    one, at head dims 64, 96, 128 and 256, on a mixed batch (the write, then
    the ragged kernel) and a decode batch with a 1,600-key row cut into KV
    splits (the fused kernel up to 16, past it the write and the ragged
    kernel, as ``decode_route`` sends a decode step); at three shapes also
    a window, a soft cap and ALiBi. Writes, fused caches and INT8 scales
    bit-exact; each call on its route by the launch counters, the merge
    launched on the decode batches past 16."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa
    from atoma_infer_tpu_torch.ops.attention import alibi_slopes

    dev = torch.device("cuda")
    rng = np.random.default_rng(18)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float16", torch.float16),
                              ("float32", torch.float32)):
        tol = ATTN_TOL[dtype_name]
        for kv in (None,) + KV8_DTYPES:
            kind = {None: None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv]
            worst, cases, merges = 0.0, 0, 0
            fused_splits, ragged_splits = FusedSplitCount(), SplitCount()
            for d in GROUP_VARIANT_DIMS:
                for group in GROUP_VARIANT_GROUPS:
                    hq = 2 * group
                    shape = dict(hq=hq, hk=2, d=d, bs=BS, dtype=dtype, device=dev,
                                 num_blocks=variant_blocks(VARIANT_MIXED + VARIANT_DECODE, BS))
                    label = f"{dtype_name} {kv or dtype_name} cache D={d} G={group}"
                    mods = [{}]
                    if (d, group) in ((128, 12), (64, 16), (128, 32)):
                        mods += [dict(sliding_window=40), dict(soft_cap=50.0),
                                 dict(alibi_slopes=alibi_slopes(hq, device=dev))]
                    for decode, specs in ((False, VARIANT_MIXED), (True, VARIANT_DECODE)):
                        b = make_batch(rng, specs, decode_only=decode, **shape)
                        # A decode step's route: fused up to 16, else the
                        # write and the ragged kernel.
                        fused = decode and pa.decode_route(hq, 2) == "fused"
                        route = (pa.fused_route if fused else pa.ragged_route)(b["q"], kind)
                        merge = pa.combine_route(b["q"])
                        for kw in mods:
                            before, merged = route.launches, merge.launches
                            if kv:
                                err, cache, _ = check_kv8(torch, b, kv, f"{label} {kw}", tol,
                                                          decode=fused, **kw)
                            else:
                                cache = b["cache"]
                                err = check_same_cache_attention(torch, b, f"{label} {kw}", tol,
                                                                 decode=fused, **kw)
                            if route.launches != before + 1:
                                raise AssertionError(f"{label} {kw}: {route.name} not launched")
                            if decode and not fused:
                                merges += merge.launches - merged
                            worst = max(worst, err)
                        if fused:
                            fused_splits.add(dict(b, cache=cache))
                        elif decode:
                            ragged_splits.add(dict(b, cache=cache))
                    cases += 1
            log(f"group variants {dtype_name} over {kv or dtype_name} caches: {cases} shapes "
                f"(G {GROUP_VARIANT_GROUPS} × D {GROUP_VARIANT_DIMS}) × 3 kernels agree, writes "
                f"and fused caches bit-exact, max |err| {worst:.3e} (tol {tol}); decode batches "
                f"past {pa.MAX_FUSED_GROUP} on the write and {pa.ragged_route(b['q'], kind).name}"
                f", the merge launched {merges} times there")
            if dtype != torch.float32:
                fused_splits.check(f"group variants {dtype_name} over {kv or dtype_name} caches, "
                                   "split fused route")
                ragged_splits.check(f"group variants {dtype_name} over {kv or dtype_name} "
                                    f"caches, decode rows past {pa.MAX_FUSED_GROUP} on the "
                                    "ragged route")
                if not merges:
                    raise AssertionError(f"group variants {dtype_name} over {kv or dtype_name} "
                                         "caches: no merge of split decode rows past 16")


def check_group_kernels(torch):
    """The fused decode kernels and the ragged ones at the group shapes
    the services of ``run_group_services`` run (``GROUP_ATTENTION_SHAPES``),
    bf16 queries, blocks of 16: B at Mistral-Large-2's shape over a bf16
    cache, D (with ``scales_new`` of the model's 8 kv heads) and E at
    Llama-3.1-405B's per-rank shape at tp = 8, each on 64 decode rows
    against its plain version (caches and scales bit-exact); A, D and E on
    a mixed batch at the same shapes after their writes. At a shape whose
    decode steps take the ragged route (G = 32), the write and then A or D
    on the 64 decode rows instead (:func:`group_decode_ragged_rows`). Each
    timed with CUDA events beside its plain version and its bound; then the
    f32 queries' ``rpa_kernel`` at ``F32_GROUP_ROWS`` (logged). Returns the
    kernels line's rows, keyed ``kernel@group <shape>``."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    gen = torch.Generator(device=dev).manual_seed(19)
    mixed_specs, decode_specs = kernel_line_specs(rng)
    tol, scale, rows = ATTN_TOL["bfloat16"], 128 ** -0.5, {}
    for label, (hq, hk, hk_total, kvs) in GROUP_ATTENTION_SHAPES.items():
        shape = dict(hq=hq, hk=hk, d=128, bs=BS, dtype=torch.bfloat16, device=dev)
        mixed = make_batch(rng, mixed_specs, num_blocks=65536 // hk, decode_only=False, **shape)
        decode = make_batch(rng, decode_specs, num_blocks=131072 // hk, decode_only=True, **shape)
        m, n = mixed["meta"], mixed["rows"]
        dm, dn = decode["meta"], decode["rows"]
        for kv in kvs:
            kind = {None: None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[kv]
            extra = 4 if kv == "int8" else 0
            work = dict(kv_elt=1 if kv else 2, slot_extra=extra, hq=hq, hk=hk, d=128)
            if pa.decode_route(hq, hk) == "ragged":
                rows.update(group_decode_ragged_rows(torch, label, decode, decode_specs, kv,
                                                     kind, work))
                continue
            # The ragged kernel on the mixed batch, after its write.
            if kv:
                _, cache, scales = check_kv8(torch, mixed, kv, label, tol, decode=False)
            else:
                check_same_cache_attention(torch, mixed, label, tol, decode=False)
                cache, scales = mixed["cache"].clone(), None
                kv_write.write_kv_cache_plain(cache, mixed["k"], mixed["v"], m.slot_mapping)
            ragged = pa.ragged_route(mixed["q"], kind)
            out = pa.ragged_paged_attention_cuda(mixed["q"], cache, m, scale=scale,
                                                 kv_scales=scales)
            ref = pa.ragged_paged_attention_paged_plain(mixed["q"], cache, m, scale=scale,
                                                        kv_scales=scales)
            err = (out[:n].float() - ref[:n].float()).abs().max().item()
            nbytes, flops = attention_work(mixed_specs, None, 2, fused=False, **work)
            rows[f"{ragged.name}@group {label}"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                    mixed["q"], cache, m, scale=scale, kv_scales=scales)),
                plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                    mixed["q"], cache, m, scale=scale, kv_scales=scales), iters=5, warmup=1),
                library_ms=None, bytes=nbytes, flops=flops)
            # The fused kernel on 64 decode rows (INT8: the scales of the
            # model's kv heads, as a tensor-parallel rank passes them).
            sn = (rank_scales(torch, decode["k"], decode["v"], hk_total, gen)
                  if kv == "int8" else None)
            if kv:
                dcache, dscales = kv8_cache(torch, decode["cache"], kv, 128)
            else:
                dcache, dscales = decode["cache"].clone(), None
            fused = pa.fused_route(decode["q"], kind)
            got_c, got_s, want_c, want_s = (clone(dcache), clone(dscales), clone(dcache),
                                            clone(dscales))
            before = fused.launches
            out = pa.ragged_paged_attention_fused_cuda(
                decode["q"], got_c, decode["k"], decode["v"], dm, scale=scale, kv_scales=got_s,
                scales_new=sn)
            if fused.launches != before + 1:
                raise AssertionError(f"{fused.name} {label}: not the split kernel")
            ref = pa.fused_decode_attention_plain(
                decode["q"], want_c, decode["k"], decode["v"], dm, scale=scale, kv_scales=want_s,
                scales_new=sn)
            err = (out[:dn].float() - ref[:dn].float()).abs().max().item()
            if not (same_bytes(torch, got_c, want_c)
                    and (dscales is None or same_bytes(torch, got_s, want_s))
                    and torch.allclose(out[:dn].float(), ref[:dn].float(), atol=tol, rtol=tol)):
                raise AssertionError(f"{fused.name} {label}: max |err| {err:.3e}, cache or "
                                     "scales not bit-exact")
            nbytes, flops = attention_work(decode_specs, None, 2, fused=True, **work)
            rows[f"{fused.name}@group {label}"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                    decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                    kv_scales=dscales, scales_new=sn)),
                plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                    decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                    kv_scales=dscales, scales_new=sn), iters=5, warmup=1),
                library_ms=None, bytes=nbytes + (8 * dn if sn is not None else 0), flops=flops)
            log(f"{fused.name} {label} (Hq={hq}, Hk={hk}"
                + (", scales_new of 8 kv heads" if sn is not None else "")
                + f"): 64 decode rows, max |err| {err:.3e} (tol {tol}), cache"
                + (" and scales" if dscales is not None else "") + " bit-exact")
        del mixed, decode
        torch.cuda.empty_cache()
    card = card_line()
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"), "bfloat16")
        if r["library_ms"] is not None:
            library = f"index_copy_ {r['library_ms']:.4f} ms"
        elif name.startswith("reshape_and_cache"):
            library = "library none: no PyTorch call quantizes rows into the cache"
        else:
            library = "library none: no PyTorch call attends through block tables"
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, {library}), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, max |err| {r['max_abs_err']:.3e} "
            f"[{card}]")
    time_f32_group_rows(torch, rng, decode_specs)
    return rows


def group_decode_ragged_rows(torch, label, decode, specs, kv, kind, work):
    """A decode batch at a group past 16 on its route: the write (C, or
    the INT8 write) bit-exact with its plain version, then the ragged kernel
    (A or D, and its merge where the plan splits) on the written cache
    within tolerance. Both timed with CUDA events beside their plain
    versions (the write in a CUDA graph, as a step replays it). Returns
    their rows, keyed ``kernel@group <label>``."""
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    tol, scale = ATTN_TOL["bfloat16"], 128 ** -0.5
    m, n, hk = decode["meta"], decode["rows"], work["hk"]
    if kv:
        cache, scales = kv8_cache(torch, decode["cache"], kv, 128)
    else:
        cache, scales = decode["cache"].clone(), None
    got_c, got_s, want_c, want_s = clone(cache), clone(scales), clone(cache), clone(scales)
    kv8_write(got_c, got_s, decode["k"], decode["v"], m.slot_mapping, cuda=True)
    kv8_write(want_c, want_s, decode["k"], decode["v"], m.slot_mapping, cuda=False)
    if not same_bytes(torch, got_c, want_c) or (
            scales is not None and not same_bytes(torch, got_s, want_s)):
        raise AssertionError(f"the write {label} {kv or 'bf16'}: cache or scales not bit-exact")
    write = f"reshape_and_cache{'_' + kv if kv else ''}"
    ragged = pa.ragged_route(decode["q"], kind)
    merge = pa.combine_route(decode["q"])
    before = merge.launches
    out = pa.ragged_paged_attention_cuda(decode["q"], got_c, m, scale=scale, kv_scales=got_s)
    ref = pa.ragged_paged_attention_paged_plain(decode["q"], got_c, m, scale=scale,
                                                kv_scales=got_s)
    err = (out[:n].float() - ref[:n].float()).abs().max().item()
    if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"{ragged.name} {label} decode rows disagree: {err:.3e}")
    plan = pa.rpa_plan_for(decode["q"], m, hk, kind)
    elt = work["kv_elt"]
    row_bytes = 2 * hk * 128
    library_ms = None
    if not kv:
        # The library call: index_copy_ of the rows, K and V side by side,
        # into the flattened slots, in a CUDA graph (as phase 2 times C's).
        # No PyTorch call quantizes rows into an INT8 cache.
        valid = m.slot_mapping >= 0
        slots = m.slot_mapping[valid].long()
        fused_rows = torch.stack([decode["k"], decode["v"]], 2).reshape(
            decode["k"].shape[0], -1)[valid]
        flat = got_c.view(-1, got_c.shape[-1])
        library_ms = graph_ms(torch, lambda: flat.index_copy_(0, slots, fused_rows))
    rows = {
        f"{write}@group {label}": dict(
            max_abs_err=0.0,
            ms=graph_ms(torch, lambda: kv8_write(got_c, got_s, decode["k"], decode["v"],
                                                 m.slot_mapping, cuda=True)),
            plain_ms=cuda_ms(lambda: kv8_write(got_c, got_s, decode["k"], decode["v"],
                                               m.slot_mapping, cuda=False)),
            library_ms=library_ms, bytes=n * (row_bytes * 2 + row_bytes * elt + work["slot_extra"])
            + decode["q"].shape[0] * 4, flops=0),
        f"{ragged.name}@group {label}": dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                decode["q"], got_c, m, scale=scale, kv_scales=got_s)),
            plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                decode["q"], got_c, m, scale=scale, kv_scales=got_s), iters=5, warmup=1),
            library_ms=None,
            **dict(zip(("bytes", "flops"), attention_work(specs, None, 2, fused=False,
                                                          **work)))),
    }
    log(f"{label} {kv or 'bf16'} KV: 64 decode rows on the ragged route, {write} bit-exact, "
        f"{ragged.name} max |err| {err:.3e} (tol {tol}); plan {plan.warps} warps, "
        f"{plan.tokens} decode rows a {plan.warps * pa.RPA_WARP_ROWS}-row tile, {plan.splits} "
        f"splits at most, the merge launched {merge.launches - before} time(s)")
    return rows


def time_f32_group_rows(torch, rng, specs):
    """The f32 queries' CUDA-core ragged kernel (``rpa_kernel``) on 64
    decode rows at ``F32_GROUP_ROWS`` q heads over one kv head (D = 128, an
    f32 cache): the f32 route's decode steps past 16. Checked against its
    plain version and timed beside it and its bound (logged; the card's f32
    services have smaller groups, so these shapes launch it on no
    service)."""
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    tol, scale, card = ATTN_TOL["float32"], 128 ** -0.5, card_line()
    for group in F32_GROUP_ROWS:
        b = make_batch(rng, specs, num_blocks=131072, decode_only=True, hq=group, hk=1, d=128,
                       bs=BS, dtype=torch.float32, device=torch.device("cuda"))
        m, n = b["meta"], b["rows"]
        kernel = pa.ragged_route(b["q"], None)
        before = kernel.launches
        out = pa.ragged_paged_attention_cuda(b["q"], b["cache"], m, scale=scale)
        if kernel.launches != before + 1:
            raise AssertionError(f"{kernel.name} f32 G={group}: not launched")
        ref = pa.ragged_paged_attention_paged_plain(b["q"], b["cache"], m, scale=scale)
        err = (out[:n] - ref[:n]).abs().max().item()
        if not torch.allclose(out[:n], ref[:n], atol=tol, rtol=tol):
            raise AssertionError(f"{kernel.name} f32 G={group} disagrees: {err:.3e}")
        ms = cuda_ms(lambda: pa.ragged_paged_attention_cuda(b["q"], b["cache"], m, scale=scale))
        plain_ms = cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
            b["q"], b["cache"], m, scale=scale), iters=5, warmup=1)
        bound_ms, by = bound(*attention_work(specs, None, 4, fused=False, hq=group, hk=1,
                                             d=128), "float32")
        log(f"{kernel.name} (rpa_kernel, f32) G={group}, 64 decode rows, D=128: {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, library none), bound {bound_ms:.4f} ms by {by}, max "
            f"|err| {err:.3e} (tol {tol}) [{card}]")
        del b
    torch.cuda.empty_cache()


# ------------------------------- phase 2: head dims at a padded width (A–E)
# The head dims the attention kernels run at a padded width (instance_dim):
# the published ones of HEAD_DIM_SHAPES (80 at 96, 100 and 120 at 128), 112,
# 160 and 192 (at 128 and 256), and 8, 50 and 248, whose heads take the
# narrowest copies (50 over a 1-byte cache: 2-byte pieces, 4-byte in bf16;
# 8 and 248 over one: 8-byte).
HEAD_DIM_VARIANT_DIMS = (80, 100, 112, 120, 160, 192, 8, 50, 248)
# Groups there: one half of the fused kernel's tile, both halves, and past
# 16 the write and the ragged kernel (two kv heads each).
HEAD_DIM_VARIANT_GROUPS = (1, 4, 12, 20)
# Groups past 128 q heads per kv head (one kv head), which the tensor-core
# ragged kernel cuts into two slices a token, at these head dims.
LARGE_GROUPS = (144, 256)
LARGE_GROUP_DIMS = (32, 80, 128)
# Odd head dims on every width (3, 9 at 32; 63 at 64; 127 at 128; 255 at
# 256; 257 and 511 at 512) and 320, 384, 512 at the width 512, over one and
# both halves of the fused kernel's tile; past 16 q heads per kv head (the
# write and the ragged kernel; at 512 two 16-row slices a token) at three.
W512_VARIANT_DIMS = (3, 9, 63, 127, 255, 257, 320, 384, 511, 512)
W512_VARIANT_GROUPS = (4, 12)
W512_PAST_16_DIMS = (63, 320, 512)
# Past 512, the width 512's column slices (two at 513-1,024: 513 and 767
# odd, 640 a partial second slice), at one and both halves of the fused
# kernel's tile and past 16 at 1,024; then one shape each at 1,025 (three
# slices, the last one column), 2,048 (four) and 4,096 (eight).
PAST_512_DIMS = (513, 640, 767, 1024)
PAST_512_GROUPS = (4, 12)
PAST_512_SHAPES = ((1024, 20), (1025, 4), (2048, 12), (4096, 2))
# The shapes that also run with a window, a soft cap and ALiBi.
MODIFIER_SHAPES = ((80, 4), (100, 12), (120, 20), (63, 4), (512, 12), (1024, 12))
_KINDS = {None: None, "int8": "int8", "fp8": "float8_e4m3fn"}


def expected_slices(pa, d, group, warps):
    """The slices a tensor-core ragged plan cuts a token's group into: at
    the width 512 past one 16-row tile, else past the plan's warps' rows."""
    return pa.rpa_group_slices(group, 1 if pa.instance_dim(d) == pa.W512 else warps)


def check_head_dim_variants(torch):
    """A, B, D, E and the merge at head dims that run at a padded width
    (``HEAD_DIM_VARIANT_DIMS`` × ``HEAD_DIM_VARIANT_GROUPS``, two kv heads;
    the odd ones and those of the width 512, ``W512_VARIANT_DIMS`` ×
    ``W512_VARIANT_GROUPS`` and G = 20 at ``W512_PAST_16_DIMS``; past 512 in
    column slices, ``PAST_512_DIMS`` × ``PAST_512_GROUPS`` and
    ``PAST_512_SHAPES``) and at
    groups past 128 (``LARGE_GROUPS`` × ``LARGE_GROUP_DIMS``, one kv
    head) against their plain versions: bf16, fp16 and f32 queries over a
    cache of their dtype, an INT8 one and an e4m3 one, on a mixed batch (the
    write, then the ragged kernel) and a decode batch with a 1,600-key row
    (the fused kernel up to 16 q heads per kv head, past it the write and
    the ragged kernel, as ``decode_route`` sends a decode step); at three
    shapes also a window, a soft cap and ALiBi. Writes, fused caches and
    INT8 scales bit-exact, attention within ``ATTN_TOL``; each call on its
    route by the launch counters, the merge launched on split rows, and
    every tensor-core ragged call past 128 planned in two slices."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa
    from atoma_infer_tpu_torch.ops.attention import alibi_slopes

    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    shapes = [(d, g, 2) for d in HEAD_DIM_VARIANT_DIMS for g in HEAD_DIM_VARIANT_GROUPS]
    shapes += [(d, g, 2) for d in W512_VARIANT_DIMS for g in W512_VARIANT_GROUPS]
    shapes += [(d, 20, 2) for d in W512_PAST_16_DIMS]
    shapes += [(d, g, 2) for d in PAST_512_DIMS for g in PAST_512_GROUPS]
    shapes += [(d, g, 2) for d, g in PAST_512_SHAPES]
    shapes += [(d, g, 1) for d in LARGE_GROUP_DIMS for g in LARGE_GROUPS]
    # Ragged calls (a mixed and a decode batch a shape) planned in slices;
    # calls past 512 (every route, in column slices).
    want_sliced = 2 * sum(expected_slices(pa, d, g, 8) > 1 for d, g, _ in shapes)
    want_columns = sum(2 * (4 if (d, g) in MODIFIER_SHAPES else 1)
                       for d, g, _ in shapes if d > W512)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float16", torch.float16),
                              ("float32", torch.float32)):
        tol = ATTN_TOL[dtype_name]
        for kv in (None,) + KV8_DTYPES:
            kind = _KINDS[kv] and getattr(torch, _KINDS[kv])
            worst, calls, merges, sliced, columns, column_blocks = 0.0, 0, 0, 0, 0, 0
            fused_splits, ragged_splits = FusedSplitCount(), SplitCount()
            for d, group, hk in shapes:
                hq = hk * group
                shape = dict(hq=hq, hk=hk, d=d, bs=BS, dtype=dtype, device=dev,
                             num_blocks=variant_blocks(VARIANT_MIXED + VARIANT_DECODE, BS))
                label = f"{dtype_name} {kv or dtype_name} cache D={d} G={group}"
                mods = [{}]
                if (d, group) in MODIFIER_SHAPES:
                    mods += [dict(sliding_window=40), dict(soft_cap=50.0),
                             dict(alibi_slopes=alibi_slopes(hq, device=dev))]
                for decode, specs in ((False, VARIANT_MIXED), (True, VARIANT_DECODE)):
                    b = make_batch(rng, specs, decode_only=decode, **shape)
                    fused = decode and pa.decode_route(hq, hk) == "fused"
                    route = (pa.fused_route if fused else pa.ragged_route)(b["q"], kind)
                    merge = pa.combine_route(b["q"])
                    for kw in mods:
                        before, merged = route.launches, merge.launches
                        cols_before = route.columns
                        if kv:
                            err, cache, _ = check_kv8(torch, b, kv, f"{label} {kw}", tol,
                                                      decode=fused, **kw)
                        else:
                            cache = b["cache"]
                            err = check_same_cache_attention(torch, b, f"{label} {kw}", tol,
                                                             decode=fused, **kw)
                        if route.launches != before + 1:
                            raise AssertionError(f"{label} {kw}: {route.name} not launched")
                        # The column slices the launch's grid had, as its
                        # wrapper counted them.
                        cols = route.columns - cols_before
                        if cols != pa.column_slices(d):
                            raise AssertionError(f"{label} {kw}: {route.name} launched in "
                                                 f"{cols} column slices")
                        merges += merge.launches - merged
                        worst = max(worst, err)
                        calls += 1
                        columns += cols > 1
                        column_blocks += cols if cols > 1 else 0
                    if dtype == torch.float32:
                        continue
                    if fused:
                        fused_splits.add(dict(b, cache=cache))
                    else:
                        plan = pa.rpa_plan_for(b["q"], b["meta"], hk, kind)
                        if plan.slices != expected_slices(pa, d, group, plan.warps) or (
                                group > 128 and plan.slices != 2):
                            raise AssertionError(f"{label}: plan {plan} for G={group}")
                        sliced += plan.slices > 1
                        if decode:
                            ragged_splits.add(dict(b, cache=cache))
            log(f"head-dim variants {dtype_name} over {kv or dtype_name} caches: {calls} calls "
                f"(D {HEAD_DIM_VARIANT_DIMS} × G {HEAD_DIM_VARIANT_GROUPS}, D "
                f"{W512_VARIANT_DIMS} × G {W512_VARIANT_GROUPS}, G 20 at D "
                f"{W512_PAST_16_DIMS}, past 512 D {PAST_512_DIMS} × G {PAST_512_GROUPS} and "
                f"(D, G) {PAST_512_SHAPES}, and G {LARGE_GROUPS} × D {LARGE_GROUP_DIMS}) agree, "
                f"writes and fused caches bit-exact, max |err| {worst:.3e} (tol {tol}); the "
                f"merge launched {merges} times; {sliced} tensor-core ragged calls planned in 2 "
                f"slices a token; {columns} launches in column slices, {column_blocks} "
                "slices in all (2 to 8 a launch, as the wrappers counted them)")
            if dtype != torch.float32:
                fused_splits.check(f"head-dim variants {dtype_name} over {kv or dtype_name} "
                                   "caches, split fused route")
                ragged_splits.check(f"head-dim variants {dtype_name} over {kv or dtype_name} "
                                    "caches, decode rows on the ragged route")
                if not merges or sliced != want_sliced:
                    raise AssertionError(f"head-dim variants {dtype_name} over "
                                         f"{kv or dtype_name} caches: {merges} merges, "
                                         f"{sliced} sliced calls")
            if columns != want_columns:
                raise AssertionError(f"head-dim variants {dtype_name} over {kv or dtype_name} "
                                     f"caches: {columns} launches in column slices, "
                                     f"{want_columns} asked")


# The published checkpoints whose head dims run at a padded width (the
# public config.json of each Hugging Face model repository): (label, Hq, Hk,
# head dim, score modifiers, the 1-byte caches their services take).
# h2o-danube-1.8b (Mistral, window 4,096) at width 96, OpenLLaMA-3B and
# h2o-danube3-4b at 128.
HEAD_DIM_SHAPES = (
    ("h2o-danube-1.8b", 32, 8, 80, dict(sliding_window=4096), ("int8",)),
    ("OpenLLaMA-3B", 32, 32, 100, {}, ("fp8",)),
    ("h2o-danube3-4b", 32, 8, 120, {}, ()),
    # An odd head dim: Llama-3.2-1B's widths with ALiBi and heads of 63
    # (HEAD_DIM_FAMILIES); the width 512's rows are check_wide_head_kernels'.
    ("Llama-3.2-1B ALiBi D=63", 32, 8, 63, dict(alibi=True), ("int8",)),
)


def check_head_dim_kernels(torch):
    """A, B and the 1-byte caches' D or E (ragged and fused) at the attention
    shapes of ``HEAD_DIM_SHAPES``, bf16 queries, block 16: the ragged
    kernels on a mixed batch (3 chunks and 29 decode rows of 16-1,023
    keys) after their writes, the fused kernels on 64 decode rows of
    16-2,047 keys (caches and scales bit-exact), each against its plain
    version within ``ATTN_TOL`` and timed with CUDA events beside its
    bound (``attention_work`` at the head dim: the padded columns are no
    work) and its plain version; then the merge after a fused launch on 8
    long decode rows where that shape's plan splits them. Returns the
    kernels line's rows, keyed ``kernel@hd <label>``."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa
    from atoma_infer_tpu_torch.ops.attention import alibi_slopes

    dev = torch.device("cuda")
    rows, card = {}, card_line()
    for label, hq, hk, d, mods, kvs in HEAD_DIM_SHAPES:
        if mods.get("alibi"):
            mods = dict(alibi_slopes=alibi_slopes(hq, device=dev))
        rng = np.random.default_rng(d)
        mixed_specs, decode_specs = kernel_line_specs(rng, max_keys=1024)
        shape = dict(hq=hq, hk=hk, d=d, bs=BS, dtype=torch.bfloat16, device=dev)
        mixed = make_batch(rng, mixed_specs, num_blocks=4096, decode_only=False, **shape)
        decode = make_batch(rng, decode_specs, num_blocks=8192, decode_only=True, **shape)
        m, dm, scale = mixed["meta"], decode["meta"], d ** -0.5
        window = mods.get("sliding_window")
        for kv in (None,) + kvs:
            kind = _KINDS[kv] and getattr(torch, _KINDS[kv])
            tol = ATTN_TOL["bfloat16"]
            kvw = dict(kv_elt=1, slot_extra=4 if kv == "int8" else 0) if kv else {}
            if kv:
                err, cache, scales = check_kv8(torch, mixed, kv, label, tol, decode=False, **mods)
            else:
                err = check_same_cache_attention(torch, mixed, label, tol, decode=False, **mods)
                cache, scales = mixed["cache"].clone(), None
                kv8_write(cache, None, mixed["k"], mixed["v"], m.slot_mapping, cuda=False)
            ragged = pa.ragged_route(mixed["q"], kind)
            plan = pa.rpa_plan_for(mixed["q"], m, hk, kind)
            nbytes, flops = attention_work(mixed_specs, window, 2, fused=False, hq=hq, hk=hk,
                                           d=d, **kvw)
            rows[f"{ragged.name}@hd {label}"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                    mixed["q"], cache, m, scale=scale, kv_scales=scales, **mods)),
                plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
                    mixed["q"], cache, m, scale=scale, kv_scales=scales, **mods),
                    iters=2, warmup=1),
                library_ms=None, bytes=nbytes, flops=flops,
                what=f"mixed batch, plan {plan.warps} warps, {plan.splits} splits at most")
            del cache, scales
            if kv:
                err, dcache, dscales = check_kv8(torch, decode, kv, label, tol, decode=True,
                                                 **mods)
            else:
                err = check_same_cache_attention(torch, decode, label, tol, decode=True, **mods)
                dcache, dscales = decode["cache"].clone(), None
            fused = pa.fused_route(decode["q"], kind)
            splits = pa.fused_splits_for(decode["q"], dm, hk, kind)
            nbytes, flops = attention_work(decode_specs, window, 2, fused=True, hq=hq, hk=hk,
                                           d=d, **kvw)
            rows[f"{fused.name}@hd {label}"] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                    decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                    kv_scales=dscales, **mods)),
                plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                    decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale,
                    kv_scales=dscales, **mods), iters=2, warmup=1),
                library_ms=None, bytes=nbytes, flops=flops,
                what=f"64 decode rows, up to {splits} splits")
            del dcache, dscales
            torch.cuda.empty_cache()
        del mixed, decode
        torch.cuda.empty_cache()
        # The merge, where the fused plan splits the services' 8 long decode
        # rows at this shape (P = 128 pages of 16 keys).
        planned = pa.fused_split_plan(
            num_seq_slots=8, max_keys=128 * BS, num_kv_heads=hk,
            slots=pa._fused_slots(None, d, hq // hk, 0))
        if planned > 1:
            rows[f"paged_attention_split_combine@hd {label}"] = split_combine_row(
                torch, label, hq=hq, hk=hk, d=d, window=window, decode=True)
        else:
            log(f"paged_attention_split_combine {label}: the fused plan takes no split on 8 "
                "decode rows at this shape; no merge row")
    for name, r in rows.items():
        if "bytes" in r:
            r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"), "bfloat16")
            log(f"{name} ({r.pop('what')}): {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
                f"library none: no PyTorch call attends through block tables), bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']}, max |err| {r['max_abs_err']:.3e} "
                f"[{card}]")
    time_padding(torch)
    return rows


# What a padded width costs: A and B at head dims below a width beside the
# width's own head dim, at one shape each (Hq, Hk), bf16 over a bf16 cache.
PADDING_SHAPES = (((80, 96), 32, 8), ((100, 120, 128), 32, 8), ((160, 192, 256), 16, 8),
                  ((63, 64), 32, 8), ((320, 384, 511, 512), 8, 4))


def time_padding(torch):
    """A on the mixed batch and B on 64 decode rows (as
    ``check_head_dim_kernels``' batches) at each head dim of
    ``PADDING_SHAPES``, timed with CUDA events beside their bounds at the
    head dim (logged): the last head dim of each shape is the width's own,
    the others run its padded instantiation."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import paged_attention as pa

    dev, card = torch.device("cuda"), card_line()
    for dims, hq, hk in PADDING_SHAPES:
        for d in dims:
            rng = np.random.default_rng(7)
            mixed_specs, decode_specs = kernel_line_specs(rng, max_keys=1024)
            shape = dict(hq=hq, hk=hk, d=d, bs=BS, dtype=torch.bfloat16, device=dev)
            mixed = make_batch(rng, mixed_specs, num_blocks=4096, decode_only=False, **shape)
            decode = make_batch(rng, decode_specs, num_blocks=8192, decode_only=True, **shape)
            scale = d ** -0.5
            a_ms = cuda_ms(lambda: pa.ragged_paged_attention_cuda(
                mixed["q"], mixed["cache"], mixed["meta"], scale=scale))
            b_ms = cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], decode["cache"], decode["k"], decode["v"], decode["meta"],
                scale=scale))
            work = dict(hq=hq, hk=hk, d=d)
            a_bound, a_by = bound(*attention_work(mixed_specs, None, 2, fused=False, **work),
                                  "bfloat16")
            b_bound, b_by = bound(*attention_work(decode_specs, None, 2, fused=True, **work),
                                  "bfloat16")
            log(f"padding: D={d} at width {pa.instance_dim(d)} (Hq={hq}, Hk={hk}): A "
                f"{a_ms:.4f} ms (bound {a_bound:.4f} by {a_by}), B {b_ms:.4f} ms (bound "
                f"{b_bound:.4f} by {b_by}) [{card}]")
            del mixed, decode
        torch.cuda.empty_cache()


# ----------------------------------------------- phase 2: quantized matmuls
def rel_err(got, want):
    """(max |got − want| over max |want|, max |got − want|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err / max(want.abs().max().item(), 1e-30), err


def check_quant_variants(torch):
    """Kernels F, G and H against their plain versions at small sizes
    (8/4-bit weights × grouped, one group and ragged-N shapes × bf16/f32 ×
    M in 1, 8, 64, 300); H's group dots exact against an int64 product on
    the CPU (unit scales, f32 output); ``quantize_weight`` on the card
    byte-identical to the CPU."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    # (K, N, group): groups of 128, one group, ragged N (1-column path), and
    # one with enough load chains at M = 300 for the unsplit lanes.
    shapes = [(384, 256, 128), (384, 256, 384), (256, 250, 128), (512, 72, 512),
              (1024, 2048, 128)]
    worst, cases, exact = {}, 0, 0
    for bits in (8, 4):
        for K, N, group in shapes:
            qt = quant.quantize_weight(torch.randn(K, N, generator=gen, device=dev) * 0.05,
                                       bits, group)
            q_full = (quant._unpack_int4(qt.qweight, group) if bits == 4 else qt.qweight)
            q_full = q_full.cpu().long()
            for dtype_name in ("bfloat16", "float32"):
                dtype, tol = getattr(torch, dtype_name), QMM_TOL[dtype_name]
                for M in (1, 8, 64, 300):
                    label = f"{bits}-bit K={K} N={N} group={group} {dtype_name} M={M}"
                    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
                    xq, act = qk.quantize_activations(x)
                    want = qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=bits,
                                                     group_size=group)
                    pairs = {
                        "weight-only": (
                            qk.quantized_matmul_cuda(x, qt.qweight, qt.scales, bits=bits,
                                                     group_size=group), want),
                        # The CUDA-core kernel on every shape, whatever the route.
                        "weight-only CUDA cores": (
                            cuda_core_matmul(torch, x, qt.qweight, qt.scales, bits=bits,
                                             group=group), want),
                        "w8a8": (
                            qk.w8a8_matmul_cuda(xq, qt.qweight, qt.scales, act, bits=bits,
                                                group_size=group, out_dtype=dtype),
                            qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act, bits=bits,
                                                 group_size=group, out_dtype=dtype)),
                        # H on the CUDA cores on every shape, whatever the route.
                        "w8a8 CUDA cores": (
                            cuda_core_w8a8(torch, xq, qt.qweight, qt.scales, act, bits=bits,
                                           group=group, out_dtype=dtype),
                            qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act, bits=bits,
                                                 group_size=group, out_dtype=dtype)),
                    }
                    for kind, (got, want) in pairs.items():
                        if got.dtype != dtype or got.shape != (M, N):
                            raise AssertionError(f"quantized matmul {kind} {label}: "
                                                 f"{got.dtype} {tuple(got.shape)}")
                        rel, _ = rel_err(got, want)
                        key = (kind, bits, dtype_name)
                        worst[key] = max(worst.get(key, 0.0), rel)
                        if not rel <= tol:
                            raise AssertionError(
                                f"quantized matmul {kind} {label}: rel err {rel:.3e} > {tol}")
                    # H's group dots exact on both routes (the route the
                    # shape takes, and the CUDA cores by a direct launch).
                    ones = (torch.ones_like(qt.scales), torch.ones_like(act))
                    want_dots = (xq.cpu().long() @ q_full).float()
                    for route, dots in (
                            ("routed", qk.w8a8_matmul_cuda(xq, qt.qweight, *ones, bits=bits,
                                                           group_size=group,
                                                           out_dtype=torch.float32)),
                            ("CUDA cores", cuda_core_w8a8(torch, xq, qt.qweight, *ones,
                                                          bits=bits, group=group,
                                                          out_dtype=torch.float32))):
                        if not torch.equal(dots.cpu(), want_dots):
                            raise AssertionError(f"W8A8 {route} {label}: integer dots are not "
                                                 "exact")
                        exact += 1
                    cases += 1
    for (kind, bits, dtype_name), rel in sorted(worst.items()):
        log(f"quantized matmul {kind} {bits}-bit {dtype_name}: worst rel err {rel:.3e} "
            f"(tol {QMM_TOL[dtype_name]})")
    log(f"quantized matmul variants: {cases} cases × 4 kernel routes agree; W8A8 group dots "
        f"exact in {exact} calls (both routes)")
    check_mma_route(torch)

    cpu_gen = torch.Generator().manual_seed(12)
    for shape, bits, group in (((4096, 4096), 8, 128), ((4096, 4096), 4, 128),
                               ((4096, 1024), 8, 4096), ((2, 512, 384), 4, 128)):
        w = torch.randn(shape, generator=cpu_gen)
        on_cpu = quant.quantize_weight(w, bits, group)
        on_card = quant.quantize_weight(w.to(dev), bits, group)
        if not (torch.equal(on_card.qweight.cpu(), on_cpu.qweight)
                and torch.equal(on_card.scales.cpu().view(torch.int16),
                                on_cpu.scales.view(torch.int16))):
            raise AssertionError(f"quantize_weight {shape} {bits}-bit differs on the card")
    log("quantize_weight: byte-identical on the card and the CPU (4 shapes)")


def cuda_core_matmul(torch, x, qweight, scales, *, bits, group):
    """F or G on the CUDA cores (``qmm_float_kernel``) by a direct launch,
    with the geometry ``quantized_matmul_cuda`` gives that route, whatever
    route the call's shape would take there."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    M, K = x.shape
    N = qweight.shape[1]
    vec, ks, rsplit, gps, splits = qk._cuda_core_geometry(M, N, K // group, qweight)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    (qk.QMM_I8 if bits == 8 else qk.QMM_I4)(
        x.data_ptr(), qweight.data_ptr(), scales.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, M, N, K, group,
        int(x.dtype == torch.bfloat16), vec, ks, rsplit, gps,
        cuda_lib.current_stream_handle(x.device), device=x.device)
    return out


def cuda_core_w8a8(torch, xq, qweight, scales, act, *, bits, group, out_dtype):
    """H on the CUDA cores (``qmm_w8a8_kernel``) by a direct launch, with
    the geometry ``w8a8_launch`` gives that route, whatever route the
    call's shape would take there."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    M, K = xq.shape
    N = qweight.shape[1]
    vec, ks, rsplit, gps, splits = qk._cuda_core_geometry(M, N, K // group, qweight)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=xq.device)
          if splits > 1 else None)
    qk.QMM_W8A8(
        xq.data_ptr(), qweight.data_ptr(), scales.data_ptr(), act.reshape(-1).data_ptr(),
        out.data_ptr(), ws.data_ptr() if ws is not None else None, M, N, K, group, bits,
        int(out_dtype == torch.bfloat16), vec, ks, rsplit, gps,
        cuda_lib.current_stream_handle(xq.device), device=xq.device)
    return out


def routed(bits, fn, *, w8a8=False):
    """Run ``fn``; returns (its result, the one F or G kernel, or with
    ``w8a8`` the one H kernel, it launched)."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    names = ([f"quantized_matmul_int{bits}", f"quantized_matmul_int{bits}_mma"] if not w8a8
             else ["quantized_matmul_w8a8", "quantized_matmul_w8a8_mma"])
    before = {k: cuda_lib.KERNELS[k].launches for k in names}
    out = fn()
    launched = [k for k in names if cuda_lib.KERNELS[k].launches > before[k]]
    if len(launched) != 1:
        raise AssertionError(f"quantized matmul: launched {launched}")
    return out, launched[0]


# The tensor-core route's grid at small sizes: K = 512 in groups of 16, 32,
# 64, 128 and one group; M across one, two and several m16 tiles and blocks
# of 16 to 128 rows; N = 144 ends on a partial column block, 72 and 200 are
# no multiple of 16 and take the CUDA cores, as do INT4 groups of 16 (half a
# k16 step of packed rows).
MMA_GROUPS = (16, 32, 64, 128, 512)
MMA_ROWS = (1, 8, 15, 16, 17, 64, 255, 256, 300)
MMA_COLS = (72, 144, 200, 2048, 14336)


def check_mma_route(torch):
    """F, G and H's routes against their plain versions within
    ``QMM_TOL["bfloat16"]``: bf16 activations (H: quantized per token) over
    the grid above, each call shown by the launch counters to take the
    route the shape asks for; then misaligned weights, activations and
    scales (and for F and G f32 activations), each shown to take the CUDA
    cores."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    K = 512
    worst, cases = {}, 0
    for bits in (8, 4):
        w = torch.randn(K, max(MMA_COLS), generator=gen, device=dev) * 0.05
        for group in MMA_GROUPS:
            for N in MMA_COLS:
                qt = quant.quantize_weight(w[:, :N].contiguous(), bits, group)
                for M in MMA_ROWS:
                    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                    got, kernel = routed(bits, lambda: qk.quantized_matmul_cuda(
                        x, qt.qweight, qt.scales, bits=bits, group_size=group))
                    label = f"{bits}-bit group={group} N={N} M={M}"
                    takes_mma = N % 16 == 0 and group % (16 if bits == 8 else 32) == 0
                    if kernel.endswith("_mma") != takes_mma:
                        raise AssertionError(f"quantized matmul {label} took {kernel}")
                    rel, _ = rel_err(got, qk.quantized_matmul_plain(
                        x, qt.qweight, qt.scales, bits=bits, group_size=group))
                    if got.dtype != torch.bfloat16 or got.shape != (M, N) or not (
                            rel <= QMM_TOL["bfloat16"]):
                        raise AssertionError(f"{kernel} {label}: rel err {rel:.3e}")
                    worst[kernel] = max(worst.get(kernel, 0.0), rel)
                    # H on the same shape: its route takes whole k32 steps a group.
                    xq, act = qk.quantize_activations(x)
                    got, kernel = routed(bits, lambda: qk.w8a8_matmul_cuda(
                        xq, qt.qweight, qt.scales, act, bits=bits, group_size=group,
                        out_dtype=torch.bfloat16), w8a8=True)
                    takes_mma = N % 16 == 0 and group % (32 if bits == 8 else 64) == 0
                    if kernel.endswith("_mma") != takes_mma:
                        raise AssertionError(f"W8A8 {label} took {kernel}")
                    rel, _ = rel_err(got, qk.w8a8_matmul_plain(
                        xq, qt.qweight, qt.scales, act, bits=bits, group_size=group,
                        out_dtype=torch.bfloat16))
                    if got.shape != (M, N) or not rel <= QMM_TOL["bfloat16"]:
                        raise AssertionError(f"{kernel} {label}: rel err {rel:.3e}")
                    worst[kernel] = max(worst.get(kernel, 0.0), rel)
                    cases += 1
    for kernel, rel in sorted(worst.items()):
        log(f"{kernel}: worst rel err {rel:.3e} over the route grid (tol "
            f"{QMM_TOL['bfloat16']})")
    log(f"quantized matmul route grid: {cases} cases agree, each on the route its shape asks for")

    # Off 16-byte alignment (a view 8 bytes into a larger tensor) and f32
    # activations: the CUDA cores, and the same numbers.
    M, N, group = 8, 2048, 128
    w = torch.randn(K, N, generator=gen, device=dev) * 0.05
    for bits in (8, 4):
        qt = quant.quantize_weight(w, bits, group)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)

        def shifted(t):
            step = 8 // t.element_size()
            buf = torch.empty(t.numel() + step, dtype=t.dtype, device=dev)
            view = buf[step:].view(t.shape)
            view.copy_(t)
            return view

        for what, (xx, q, sc) in {
            "misaligned weight": (x, shifted(qt.qweight), qt.scales),
            "misaligned activations": (shifted(x), qt.qweight, qt.scales),
            "misaligned scales": (x, qt.qweight, shifted(qt.scales)),
            "f32 activations": (x.float(), qt.qweight, qt.scales),
        }.items():
            got, kernel = routed(bits, lambda: qk.quantized_matmul_cuda(
                xx, q, sc, bits=bits, group_size=group))
            rel, _ = rel_err(got, qk.quantized_matmul_plain(xx, q, sc, bits=bits,
                                                            group_size=group))
            tol = QMM_TOL["float32" if xx.dtype == torch.float32 else "bfloat16"]
            if kernel.endswith("_mma") or not rel <= tol:
                raise AssertionError(f"{bits}-bit {what}: {kernel}, rel err {rel:.3e}")
            log(f"{bits}-bit {what}: {kernel}, rel err {rel:.3e} (tol {tol})")
            if what == "f32 activations":
                continue  # H takes int8 activations whatever x's dtype
            # H with the same operand off alignment (int8 activations).
            xq, act = qk.quantize_activations(xx.float())
            xq = shifted(xq) if what == "misaligned activations" else xq
            got, kernel = routed(bits, lambda: qk.w8a8_matmul_cuda(
                xq, q, sc, act, bits=bits, group_size=group, out_dtype=torch.bfloat16),
                w8a8=True)
            rel, _ = rel_err(got, qk.w8a8_matmul_plain(xq, q, sc, act, bits=bits,
                                                       group_size=group,
                                                       out_dtype=torch.bfloat16))
            if kernel.endswith("_mma") or not rel <= QMM_TOL["bfloat16"]:
                raise AssertionError(f"W8A8 {bits}-bit {what}: {kernel}, rel err {rel:.3e}")
            log(f"W8A8 {bits}-bit {what}: {kernel}, rel err {rel:.3e}")


def qmm_work(M, K, N, group, *, bits, x_bytes, w8a8=False, out_bytes=2):
    """(bytes, flops) of one quantized matmul: weights, scales, activations
    (plus per-token scales for W8A8) read once, the output (bf16 unless
    said) written once; 2·M·K·N operations."""
    nbytes = K * N * bits // 8 + (K // group) * N * 2 + M * K * x_bytes + M * N * out_bytes
    if w8a8:
        nbytes += M * 4
    return nbytes, 2 * M * K * N


def check_quant_kernels(torch):
    """F, G and H at the Llama-3.1-8B shapes, bf16 activations, M = 8 and
    64 (decode) and 256 (a prefill chunk): F and G on both routes (the
    tensor cores, which these shapes take, and the CUDA cores by a direct
    launch), each against its plain version, then timed (CUDA graphs; each
    timed launch reads weights that are not in L2, as in a decode step where
    every layer's weights are new). Then the CUDA-core route on the traffic
    that reaches it (:func:`check_cuda_core_rows`). Returns the kernels
    line's rows: the tensor cores' and H's at the 8B gate projection, M = 8;
    the CUDA cores' from the f32 service's shape."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for shape, (K, N, group) in QMM_SHAPES.items():
        w = torch.randn(K, N, generator=gen, device=dev) * 0.02
        for bits in (8, 4):
            if shape == "lm_head" and bits == 4:
                continue  # the LM head is always INT8 per channel
            qt = quant.quantize_weight(w, bits, group)
            w_bytes = qt.qweight.numel() + qt.scales.numel() * 2
            # Enough copies that one pass over them does not fit in L2 (50 MB).
            copies = [qt] + [quant.QuantizedTensor(qt.qweight.clone(), qt.scales.clone(),
                                                   bits, group)
                             for _ in range(-(-128_000_000 // w_bytes) - 1)]
            dense = [quant.dequantize_weight(c, torch.bfloat16) for c in copies]
            iters = max(2, 20 // len(copies))
            # (kernel, route): the tensor cores, the CUDA cores, W8A8 (H) on
            # the int8 tensor cores and on the CUDA cores.
            kinds = [(f"quantized_matmul_int{bits}_mma", "mma"),
                     (f"quantized_matmul_int{bits}", "cuda_cores")]
            if shape != "lm_head":
                kinds += [("quantized_matmul_w8a8_mma", "w8a8"),
                          ("quantized_matmul_w8a8", "w8a8_cuda_cores")]
            for M in (8, 64, 256):
                x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
                xq, act = qk.quantize_activations(x)
                library_ms = graph_ms(torch, lambda x=x: [torch.mm(x, d) for d in dense],
                                      iters=iters) / len(copies)
                for name, route in kinds:
                    if route.startswith("w8a8"):
                        def run(c, xq=xq, act=act, direct=route == "w8a8_cuda_cores"):
                            if direct:
                                return cuda_core_w8a8(torch, xq, c.qweight, c.scales, act,
                                                      bits=bits, group=group,
                                                      out_dtype=torch.bfloat16)
                            return qk.w8a8_matmul_cuda(xq, c.qweight, c.scales, act, bits=bits,
                                                       group_size=group,
                                                       out_dtype=torch.bfloat16)

                        def plain(xq=xq, act=act):
                            return qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act,
                                                        bits=bits, group_size=group,
                                                        out_dtype=torch.bfloat16)
                    elif route == "cuda_cores":
                        def run(c, x=x):
                            return cuda_core_matmul(torch, x, c.qweight, c.scales, bits=bits,
                                                    group=group)
                    else:
                        def run(c, x=x):
                            return qk.quantized_matmul_cuda(x, c.qweight, c.scales, bits=bits,
                                                            group_size=group)

                        def plain(x=x):
                            return qk.quantized_matmul_plain(x, qt.qweight, qt.scales,
                                                             bits=bits, group_size=group)
                    got = run(qt)
                    if route in ("mma", "w8a8") and routed(bits, lambda: run(qt),
                                                          w8a8=route == "w8a8")[1] != name:
                        raise AssertionError(f"{name} {shape} M={M}: another route ran")
                    rel, err = rel_err(got, plain())
                    if not rel <= QMM_TOL["bfloat16"]:
                        raise AssertionError(f"{name} {shape} M={M}: rel err {rel:.3e}")
                    ms = graph_ms(torch, lambda: [run(c) for c in copies],
                                  iters=iters) / len(copies)
                    plain_ms = graph_ms(torch, plain, iters=2)
                    w8a8 = route.startswith("w8a8")
                    # One torch.mm on the dequantized bf16 weight computes
                    # the same product for every route, H's too (its
                    # activations quantized).
                    lib = library_ms
                    nbytes, flops = qmm_work(M, K, N, group, bits=bits,
                                             x_bytes=1 if w8a8 else 2, w8a8=w8a8)
                    bound_ms, bound_by = bound(nbytes, flops, "int8" if w8a8 else "bfloat16")
                    lib_text = f"{lib:.4f} ms" if lib is not None else "none"
                    how = {"cuda_cores": " bf16 (direct launch)",
                           "w8a8_cuda_cores": " (direct launch)"}.get(route, "")
                    log(f"{name}{how} {bits}-bit {shape} K={K} N={N} M={M}: {ms:.4f} ms (plain "
                        f"{plain_ms:.4f} ms, library {lib_text}), bound {bound_ms:.4f} ms by "
                        f"{bound_by}, max |err| {err:.3e} (rel {rel:.2e})")
                    # The line's W8A8 rows are the main path's: INT8 weights
                    # (H's CUDA cores by a direct launch beside its route).
                    # F and G's CUDA cores' rows come from the traffic they serve.
                    if (shape, M) == (QMM_LINE_SHAPE, QMM_LINE_M) and route != "cuda_cores" and \
                            not (w8a8 and bits == 4):
                        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=lib, bound_ms=bound_ms,
                                          bound_by=bound_by)
            del copies, dense
        del w
        torch.cuda.empty_cache()
    rows.update(check_cuda_core_rows(torch))
    return rows


def check_cuda_core_rows(torch):
    """F and G's CUDA-core route timed on the traffic that reaches it in
    the smoke: the f32 ``tiny_trained`` services' gate projection (hidden ×
    intermediate from the fixture's config, groups of 128) at their decode
    batch of 8 rows, f32 activations through ``quantized_matmul_cuda`` (the
    launch counters show the route), in CUDA graphs with the weight in L2
    as the whole model is there; against the plain version and ``torch.mm``
    on the dequantized f32 weight. Returns their kernels line rows."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    with open(os.path.join(REPO, "tests", "fixtures", "tiny_trained", "config.json")) as f:
        cfg = json.load(f)
    K, N, group, M = cfg["hidden_size"], cfg["intermediate_size"], quant.DEFAULT_GROUP_SIZE, 8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    w = torch.randn(K, N, generator=gen, device=dev) * 0.05
    x = torch.randn(M, K, generator=gen, device=dev)
    rows = {}
    for bits in (8, 4):
        qt = quant.quantize_weight(w, bits, group)
        dense = quant.dequantize_weight(qt, torch.float32)

        def run():
            return qk.quantized_matmul_cuda(x, qt.qweight, qt.scales, bits=bits,
                                            group_size=group)

        def plain():
            return qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=bits,
                                             group_size=group)

        got, name = routed(bits, run)
        if name != f"quantized_matmul_int{bits}":
            raise AssertionError(f"f32 tiny_trained gate_proj {bits}-bit took {name}")
        rel, err = rel_err(got, plain())
        if got.dtype != torch.float32 or not rel <= QMM_TOL["float32"]:
            raise AssertionError(f"{name} f32 tiny_trained gate_proj: rel err {rel:.3e}")
        ms, plain_ms = graph_ms(torch, run), graph_ms(torch, plain)
        library_ms = graph_ms(torch, lambda: torch.mm(x, dense))
        bound_ms, bound_by = bound(*qmm_work(M, K, N, group, bits=bits, x_bytes=4, out_bytes=4),
                                   "float32")
        log(f"{name} f32 {bits}-bit tiny_trained gate_proj K={K} N={N} M={M}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, library {library_ms:.4f} ms), bound {bound_ms:.4f} ms "
            f"by {bound_by}, max |err| {err:.3e} (rel {rel:.2e})")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
    return rows


# ------------------------------------- phase 2: the W8A8 rate probe (kernel I)
# Kernel I's mixed form against its plain version: max |err| over the
# output's largest magnitude. Every bf16 × int8 product is exact in f32 on
# both sides, and the sums differ in order; the tensor cores also align each
# k16 step's addends to the largest before adding, cutting the low bits of
# the smaller ones (up to about 2^-23 of the running sum a step, 256 steps
# at K = 4096). The int8 form is exact on both sides and must be equal.
PROBE_MIXED_TOL = 1e-4


def check_probe_kernels(torch):
    """Kernel I, both forms, against its plain version at small shapes
    (M = 1 to 400, K = 64 to 1024, N = 128 to 640) and at the probe's
    (184 × 4096 × 14336), then timed there with CUDA events per matmul over
    16 distinct weights (58.7 MB each, so none is in L2), and over one
    weight 16 times (in L2) for what the kernel takes when device memory
    is not its limit: the kernel, its
    plain version, and one PyTorch call for the same product, its weights
    converted beforehand (``torch._int_mm`` on column-major int8 weights,
    int32 out; ``torch.mm`` on bf16 weights, f32 out), itself checked
    against the plain version. Returns the kernels line's rows."""
    from atoma_infer_tpu_torch.tools import w8a8_probe as probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)

    def int8(*shape):
        return torch.randint(-127, 127, shape, generator=gen, device=dev, dtype=torch.int8)

    def check(xq, xb, w, label):
        got, want = probe.probe_matmul_cuda(xq, w), probe.probe_matmul_plain(xq, w)
        if got.dtype != torch.float32 or not torch.equal(got, want):
            raise AssertionError(f"probe_matmul_int8 {label}: not bit-exact")
        got, want = probe.probe_matmul_cuda(xb, w), probe.probe_matmul_plain(xb, w)
        rel, err = rel_err(got, want)
        if got.dtype != torch.float32 or not rel <= PROBE_MIXED_TOL:
            raise AssertionError(f"probe_matmul_mixed {label}: rel err {rel:.3e}")
        return rel, err

    # M past one block's 192 rows (193, 200, 400) takes more blocks along y;
    # K = 64 and 320 end on half an int8 tile of 128 k.
    worst, cases = 0.0, 0
    for k, n in ((64, 128), (320, 256), (256, 384), (1024, 640)):
        for m in (1, 16, 24, 37, 64, 130, 192, 193, 200, 400):
            w = int8(k, n)
            xb = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            worst = max(worst, check(int8(m, k), xb, w, f"M={m} K={k} N={n}")[0])
            cases += 1
    log(f"probe_matmul: {cases} small shapes, int8 bit-exact, mixed worst rel err "
        f"{worst:.3e} (tol {PROBE_MIXED_TOL})")

    m, k, n = probe.M, probe.K, probe.N
    ws = [int8(k, n) for _ in range(probe.R)]
    xq = int8(m, k)
    xb = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    _, err_mixed = check(xq, xb, ws[0], "probe shape")
    rows = {}
    for name, kind, x, err in (("probe_matmul_mixed", "mixed", xb, err_mixed),
                               ("probe_matmul_int8", "int8", xq, 0.0)):
        call, lib_ws = probe.library_call(kind, ws)
        rel, _ = rel_err(call(x, lib_ws[0]).float(), probe.probe_matmul_plain(x, ws[0]))
        if not rel <= PROBE_MIXED_TOL:
            raise AssertionError(f"{name}: the library call disagrees (rel err {rel:.3e})")
        us = probe.time_per_call_us(lambda w, x=x: probe.probe_matmul_cuda(x, w), ws)
        plain_us = probe.time_per_call_us(lambda w, x=x: probe.probe_matmul_plain(x, w), ws, 1)
        lib_us = probe.time_per_call_us(lambda w, x=x: call(x, w), lib_ws)
        del lib_ws
        nbytes, ops = probe.work(m, k, n, kind)
        bound_ms, bound_by = bound(nbytes, ops, "int8" if kind == "int8" else "bfloat16")
        # The same call with one weight for every launch, so that it is read
        # from L2: what the kernel takes when device memory is not its limit.
        l2_us = probe.time_per_call_us(lambda w, x=x: probe.probe_matmul_cuda(x, w), ws[:1] * 16)
        rows[name] = dict(max_abs_err=err, ms=us / 1e3, plain_ms=plain_us / 1e3,
                          library_ms=lib_us / 1e3, bound_ms=bound_ms, bound_by=bound_by)
        log(f"{name} [{m}x{k}]x[{k}x{n}]: {us:.2f} us ({ops / us * 1e-6:.1f} T/s, "
            f"{nbytes / us * 1e-6:.3f} TB/s), bound {bound_ms * 1e3:.2f} us by {bound_by}: "
            f"{bound_ms * 1e3 / us:.1%} of the bound; plain {plain_us:.2f} us, library "
            f"{lib_us:.2f} us; weight in L2 {l2_us:.2f} us; max |err| {err:.3e}")
    del ws
    torch.cuda.empty_cache()
    return rows


PROBE_PATH = ("probe_matmul_mixed", "probe_matmul_int8")


def run_probe(torch):
    """The probe's ``main()`` on the card, the path through kernel I (the
    JAX tool's inputs from ``numpy.random.default_rng(0)``, its lines
    printed): both forms must launch and the int8 one be exact. Returns the
    launch counts of this run (all set to 0 just before it)."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.tools import w8a8_probe

    for kernel in cuda_lib.KERNELS.values():
        kernel.launches = 0
    report = w8a8_probe.main([])
    launches = {name: cuda_lib.KERNELS[name].launches for name in PROBE_PATH}
    log(f"probe: launches {launches}")
    if not (report["exact"] and report["bit_exact"]):
        raise AssertionError("probe: int8 x int8 is not exact against integer math")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the probe's path")
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- the quantization gates and the ladder
def finite_report(report, label):
    """Every number in a tool's report finite, every agreement in [0, 1]."""
    def walk(obj, key=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, k)
        elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
            if obj != obj or obj in (float("inf"), float("-inf")):
                raise AssertionError(f"{label}: {key} is {obj}")
            if "agreement" in key and not 0 <= obj <= 1:
                raise AssertionError(f"{label}: {key} = {obj} lies outside [0, 1]")
    walk(report)


def run_tools(torch):
    """The W8A8 and INT8-KV gates at their card defaults (Llama-3.2-1B
    widths, 16 layers, blocks of 32, 16 sequences at 512 keys, 24 steps;
    random bf16 weights from a seeded generator) and the quality ladder on
    ``tiny_trained`` in bf16 (16 prompts of 96 corpus tokens, 32 steps).
    Each prints its JSON on a line of its own; every number must be finite,
    every agreement in [0, 1], and each tool's kernels launched in its run
    (counts set to 0 just before it)."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.tools import kv_quant_gate, quality_ladder, w8a8_gate

    def ladder():
        report = quality_ladder.ladder(device="cuda")
        log(json.dumps(report))
        return report

    # F and H for the W8A8 gate, D for the INT8-KV gate, A to H for the
    # ladder (F and G on the tensor cores: bf16 activations).
    runs = (
        ("w8a8_gate", lambda: w8a8_gate.main([]),
         ("quantized_matmul_int8_mma", "quantized_matmul_w8a8_mma")),
        ("kv_quant_gate", lambda: kv_quant_gate.main([]),
         ("fused_decode_attention_int8_split",)),
        ("quality_ladder", ladder,
         ATTENTION_PATH + kv8_path("int8") + kv8_path("fp8")
         + ("quantized_matmul_int8_mma", "quantized_matmul_int4_mma",
            "quantized_matmul_w8a8_mma")),
    )
    for name, run, path in runs:
        for kernel in cuda_lib.KERNELS.values():
            kernel.launches = 0
        t0 = time.monotonic()
        report = run()
        launches = {k: cuda_lib.KERNELS[k].launches for k in path}
        log(f"{name}: {time.monotonic() - t0:.1f} s on the card; launches {launches}")
        finite_report(report, name)
        for kernel, count in launches.items():
            if count == 0:
                raise AssertionError(f"kernel {kernel} was not launched in the {name} run")
        gc.collect()
        torch.cuda.empty_cache()


# The port's tools/real_model_check.py on the in-repo trained checkpoint,
# its new tokens a request (the root tool's default), and JAX's n-gram
# acceptance on it (BASELINE.md row 5a: the root tool with --spec, on short
# natural prompts and on repetitive ones; a TPU run, not the port's).
REAL_MODEL_DIR = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
REAL_MODEL_TOKENS = 48
JAX_SPEC_ACCEPTANCE = (0.164, 0.212)


def run_real_model_check(torch):
    """The port's ``tools/real_model_check.py`` path (``build_service``,
    ``generate``) on ``tiny_trained``: on the card in f32 (the CUDA-core
    attention kernels) token for token the same tool's tokens on the CPU
    (PERF.md §2's f32 rule); in bf16 (the tensor cores) within the near-tie
    rule of the CPU's f32 tokens (their top 2 logprobs asked); each run's
    attention on its dtype's route by the launch counters. Then ``--spec``'s
    measurement (4 n-gram drafts, both prompt sets) in f32 on the card,
    which must equal the CPU's, and in bf16, printed beside JAX's."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.tools import real_model_check as rmc

    def acceptance(dtype, device=None):
        figures = []
        for prompts in (rmc.PROMPTS, rmc.REPETITIVE_PROMPTS):
            service, _, _ = rmc.build_service(REAL_MODEL_DIR, spec_tokens=rmc.SPEC_TOKENS,
                                              dtype=dtype, device=device)
            figures.append(rmc.generate_counting_drafts(service, prompts,
                                                        REAL_MODEL_TOKENS)[1:])
            del service
            gc.collect()
            torch.cuda.empty_cache()
        return figures

    t0 = time.monotonic()
    cpu, _, _ = rmc.build_service(REAL_MODEL_DIR, dtype=torch.float32, device="cpu")
    ref = rmc.generate(cpu, rmc.PROMPTS, REAL_MODEL_TOKENS, top_n=2)
    want = [tuple(r.outputs[0].token_ids) for r in ref]
    top = [r.outputs[0].top_logprobs for r in ref]
    cpu_spec = acceptance(torch.float32, "cpu")
    del cpu
    for dtype_name, path in (("float32", ("fused_decode_attention", "ragged_paged_attention")),
                             ("bfloat16", ("fused_decode_attention_split",
                                           "ragged_paged_attention_mma"))):
        label = f"real_model_check tiny_trained {dtype_name}"
        service, _, _ = rmc.build_service(REAL_MODEL_DIR, dtype=getattr(torch, dtype_name))
        for kernel in cuda_lib.KERNELS.values():
            kernel.launches = 0
        results = rmc.generate(service, rmc.PROMPTS, REAL_MODEL_TOKENS)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in cuda_lib.KERNELS.items()}
        check_route(label, launches, bf16=dtype_name == "bfloat16")
        if not all(launches[name] for name in path):
            raise AssertionError(f"{label}: {path} not launched: "
                                 f"{ {name: launches[name] for name in path} }")
        got = [tuple(r.outputs[0].token_ids) for r in results]
        if dtype_name == "float32":
            if got != want:
                raise AssertionError(f"{label}: tokens differ from the CPU's: {got} against "
                                     f"{want}")
            log(f"{label}: {sum(map(len, got))} tokens identical to the same tool on the CPU; "
                f"first completion {results[0].outputs[0].output_text[:40]!r}")
        else:
            prefixes = near_tie_compare(label, got, want, top)
            log(f"{label}: common prefix with the CPU's f32 tokens by request {prefixes} "
                f"(of {REAL_MODEL_TOKENS}; past it a near-tie of the reference's top two)")
        log(f"{label}: launches {{{', '.join(f'{n}: {launches[n]}' for n in path)}}}")
        del service
        gc.collect()
        torch.cuda.empty_cache()
    card_spec = acceptance(torch.float32)
    if [a for a, _ in card_spec] != [a for a, _ in cpu_spec]:
        raise AssertionError(f"real_model_check --spec f32: the card's acceptance {card_spec} "
                             f"differs from the CPU's {cpu_spec}")
    bf16_spec = acceptance(torch.bfloat16)
    for (name, figures) in (("f32, card and CPU", card_spec), ("bf16, card", bf16_spec)):
        log(f"real_model_check --spec tiny_trained {name}: acceptance "
            f"{figures[0][0]} on the natural prompts ({figures[0][1]:.0f} drafts proposed), "
            f"{figures[1][0]} on the repetitive ones ({figures[1][1]:.0f}); JAX's (BASELINE.md "
            f"row 5a, a TPU run) {JAX_SPEC_ACCEPTANCE[0]} and {JAX_SPEC_ACCEPTANCE[1]}")
    log(f"real_model_check phase: {time.monotonic() - t0:.1f} s [{card_line()}]")


# The ladder in f32, card (kernels) against CPU (plain versions): the sums
# differ in the last bits, and where a KV value or a W8A8 activation lies
# that close to an int8 step or e4m3 code it lands on the neighbouring one
# (under 0.02% of INT8 KV values in the 8B model check above); on this peaked
# model that moves a chosen token's logprob by far less than 1e-3.
LADDER_CARD_TOL = 1e-3


def check_ladder_parity(torch):
    """The quality ladder on ``tiny_trained`` in f32 at reduced sizes (4
    prompts of 32 tokens, 4 steps) on the card and on the CPU: greedy
    agreements identical, peakedness and drifts within
    ``LADDER_CARD_TOL``."""
    from atoma_infer_tpu_torch.tools import quality_ladder

    sizes = dict(steps=4, seqs=4, prompt_len=32)
    card = quality_ladder.ladder(device="cuda", dtype=torch.float32, **sizes)
    cpu = quality_ladder.ladder(device="cpu", **sizes)
    pairs = [(f"peakedness {k}", card["reference_peakedness"][k], v)
             for k, v in cpu["reference_peakedness"].items()]
    for name, ref in cpu["variants"].items():
        got = card["variants"][name]
        if got["greedy_agreement"] != ref["greedy_agreement"]:
            raise AssertionError(f"ladder {name}: greedy agreement {got['greedy_agreement']} on "
                                 f"the card, {ref['greedy_agreement']} on the CPU")
        pairs += [(f"{name} {k}", got[k], ref[k]) for k in ("mean_abs_dlogprob", "max_abs_dlogprob")]
    worst = max(abs(a - b) for _, a, b in pairs)
    log(f"ladder f32 card vs CPU: greedy agreements identical, worst |diff| {worst:.2e} "
        f"(tol {LADDER_CARD_TOL}); card {json.dumps(card['variants'])}")
    for label, a, b in pairs:
        if abs(a - b) > LADDER_CARD_TOL:
            raise AssertionError(f"ladder {label}: {a} on the card, {b} on the CPU")


# --------------------------------------------------------------- phase 3
def params_to(params, device):
    """A copy of a parameter dict (one level of nesting) on ``device``;
    quantized weights move with their ``to``."""
    return {
        k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict) else v.to(device))
        for k, v in params.items()
    }


def code_steps(torch, a, b):
    """Per element, how many representable values apart two tensors of one
    dtype are: int8 steps, or e4m3/bf16 codes of the same sign (a change of
    sign counts as far apart)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.int8:
        return (a.int() - b.int()).abs()
    bits = 8 * a.element_size()
    view = torch.uint8 if bits == 8 else torch.int16
    ai, bi = (x.view(view).int() & ((1 << bits) - 1) for x in (a, b))
    sign = 1 << (bits - 1)
    return torch.where((ai & sign) == (bi & sign), (ai - bi).abs(), 1 << 30)


def two_sequence_steps():
    """A prefill of two sequences (37 and 70 tokens, on pages 0-19 of
    ``BS`` slots, interleaved), then 3 decode steps: yields (step, decode,
    the step's numpy arrays)."""
    import numpy as np

    tables = [list(range(0, 20, 2)), list(range(1, 21, 2))]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 259, size=n).tolist() for n in (37, 70)]
    for step in range(4):
        decode = step > 0
        lens = [len(p) + step for p in prompts]
        q_lens = [1, 1] if decode else lens
        T = 8 if decode else 128
        toks = np.zeros(T, np.int32)
        pos = np.zeros(T, np.int32)
        slots = np.full(T, -1, np.int32)
        qsl = np.zeros(9, np.int32)
        bt = np.zeros((8, 16), np.int32)
        sl = np.zeros(8, np.int32)
        r = 0
        for s, (kv, q) in enumerate(zip(lens, q_lens)):
            bt[s, : len(tables[s])] = tables[s]
            sl[s] = kv
            for i in range(kv - q, kv):
                toks[r] = prompts[s][i] if i < len(prompts[s]) else 3 + (i * 7) % 250
                pos[r] = i
                slots[r] = tables[s][i // BS] * BS + i % BS
                r += 1
            qsl[s + 1] = r
        qsl[3:] = r
        yield step, decode, dict(toks=toks, pos=pos, slots=slots, qsl=qsl, bt=bt, sl=sl,
                                 max_q_len=max(q_lens), sel=qsl[1:3] - 1)


def step_logits(torch, model, params, batch, caches, kv_scales=None):
    """One step of :func:`two_sequence_steps` through ``model`` on its
    device: the two sequences' last rows' logits, f32 on the CPU."""
    import numpy as np

    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata

    def ints(a, dev=model.device):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    meta = AttentionMetadata(
        slot_mapping=ints(batch["slots"]), block_tables=ints(batch["bt"]),
        seq_lens=ints(batch["sl"]), query_start_loc=ints(batch["qsl"]), num_seqs=ints([2]),
        block_size=BS, decode_only=batch["max_q_len"] == 1, max_q_len=batch["max_q_len"],
    )
    with torch.inference_mode():
        hidden = model.forward(params, ints(batch["toks"]), ints(batch["pos"]), caches, meta,
                               kv_scales=kv_scales)
        return model.compute_logits(params, hidden[ints(batch["sel"]).long()]).float().cpu()


def model_parity(torch, cfg, params_cpu, label, tol, kv_dtype=None):
    """A 2-layer ``Llama`` on the card (kernels) against the same f32
    weights on the CPU (plain versions): a prefill and 3 decode steps of two
    sequences; logits within ``tol``. KV caches in f32 within ``tol``; a
    1-byte cache (``kv_dtype`` int8 or fp8) and its scales equal except in
    at most 1% of the values, each one step or code apart: the card's and
    the CPU's f32 projections differ in the last bits, and a value within
    that of a rounding boundary lands on the neighbouring step."""
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.ops.kv_cache import alloc_kv_scales

    cpu = Llama(cfg, dtype=torch.float32, device="cpu")
    gpu = Llama(cfg, dtype=torch.float32, device="cuda")
    params_gpu = params_to(params_cpu, gpu.device)
    cache_dtype = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(kv_dtype)
    caches = {name: m.alloc_kv_cache(64, BS, dtype=cache_dtype)
              for name, m in (("cpu", cpu), ("cuda", gpu))}
    scales = {name: ([alloc_kv_scales(64, BS, m.device) for _ in range(cfg.num_layers)]
                     if kv_dtype == "int8" else None)
              for name, m in (("cpu", cpu), ("cuda", gpu))}
    worst = 0.0
    for step, decode, batch in two_sequence_steps():
        logits = {}
        for name, model, params in (("cpu", cpu, params_cpu), ("cuda", gpu, params_gpu)):
            logits[name] = step_logits(torch, model, params, batch, caches[name],
                                       kv_scales=scales[name])
        err = (logits["cpu"] - logits["cuda"]).abs().max().item()
        worst = max(worst, err)
        log(f"model {label} step {step} ({'decode' if decode else 'prefill'}): "
            f"max |logit err| {err:.3e} (tol {tol})")
        if not torch.allclose(logits["cuda"], logits["cpu"], atol=tol, rtol=tol):
            raise AssertionError(f"model {label}: logits disagree at step {step}")
    tiers = [("cache", caches)] + ([("scales", scales)] if kv_dtype == "int8" else [])
    for what, tier in tiers:
        for layer, (c, g) in enumerate(zip(tier["cpu"], tier["cuda"])):
            if kv_dtype is None:
                err = (c - g.cpu()).abs().max().item()
                if err > tol:
                    raise AssertionError(f"model {label}: layer {layer} KV cache differs by {err}")
                continue
            steps = code_steps(torch, c, g)
            moved = (steps > 0).float().mean().item()
            log(f"model {label}: layer {layer} {what}: {int((steps > 0).sum())} of "
                f"{steps.numel()} values one step apart")
            if steps.max().item() > 1 or moved > 0.01:
                raise AssertionError(f"model {label}: layer {layer} {what} differs "
                                     f"(max {steps.max().item()} steps, {moved:.2%} moved)")
    return worst


def check_model(torch):
    """2-layer full-width Llama-3.2-1B and Llama-3.2-3B (3 query heads per
    kv head), dense f32: card vs CPU."""
    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=2,
        num_attention_heads=HQ, num_key_value_heads=HK, head_dim=D,
        max_position_embeddings=4096, tie_word_embeddings=True,
    )
    params = Llama(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(1))
    model_parity(torch, cfg, params, "1B dense", MODEL_TOL)
    cfg = llama_3b_config(2)
    params = Llama(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    model_parity(torch, cfg, params, "3B dense", MODEL_TOL)



def llama_3b_config(num_layers):
    from atoma_infer_tpu_torch.models.llama import LlamaConfig
    from atoma_infer_tpu_torch.ops.rope import RopeScalingConfig

    return LlamaConfig(
        num_hidden_layers=num_layers,
        rope_scaling=RopeScalingConfig(factor=32.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                       original_max_position_embeddings=8192),
        **LLAMA_3B,
    )


def llama_8b_config(num_layers):
    from atoma_infer_tpu_torch.models.llama import LlamaConfig
    from atoma_infer_tpu_torch.ops.rope import RopeScalingConfig

    return LlamaConfig(
        num_hidden_layers=num_layers,
        rope_scaling=RopeScalingConfig(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                       original_max_position_embeddings=8192),
        **LLAMA_8B,
    )


def check_quant_model(torch):
    """2-layer full-width Llama-3.1-8B, f32 activations, weights quantized
    with the port's quantize_weight (INT8 and INT4, with the untied
    per-channel INT8 LM head): card vs CPU. W8A8 is held to its plain
    version kernel by kernel (phase 2) and not here: with these random
    weights its logits move by a tenth when one activation in a row rounds
    to the other int8 (the residual stream is small against the layers'
    outputs, so the next RMSNorm magnifies the change), and the card's and
    the CPU's f32 sums make such a rounding differ in some rows."""
    from atoma_infer_tpu_torch.models.weights import quantize_params

    cfg, dense, int8 = llama_8b_model_check_params(torch)
    model_parity(torch, cfg, int8, "8B INT8", MODEL_TOL)
    model_parity(torch, cfg, quantize_params(dense, "int4"), "8B INT4", MODEL_TOL)


@functools.lru_cache(maxsize=1)
def llama_8b_model_check_params(torch):
    """The 2-layer full-width Llama-3.1-8B of ``check_quant_model`` and
    ``check_kv8_model`` on the CPU: (config, its f32 weights from seed 2,
    those quantized to INT8), drawn and quantized once for both."""
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import quantize_params

    cfg = llama_8b_config(2)
    dense = Llama(cfg, dtype=torch.float32, device="cpu").init_params(
        torch.Generator().manual_seed(2))
    return cfg, dense, quantize_params(dense, "int8")


# Logits over a 1-byte KV cache, card against CPU: a value that lands on the
# neighbouring int8 step (1/127 of its row's absmax) or e4m3 code (up to 1/8
# of the value) moves the logits by far less than a wrong scale or row would
# (order 1).
KV8_MODEL_TOL = {"int8": 1e-2, "fp8": 5e-2}


def check_kv8_model(torch):
    """2-layer full-width Llama-3.1-8B with INT8 weights (quantized with the
    port's quantize_weight), f32 activations, over an INT8 KV cache and then
    an e4m3 one: card vs CPU."""
    cfg, _, params = llama_8b_model_check_params(torch)
    for kv in KV8_DTYPES:
        worst = model_parity(torch, cfg, params, f"8B INT8 + {kv} KV", KV8_MODEL_TOL[kv], kv)
        log(f"model 8B INT8 + {kv} KV: worst |logit err| {worst:.3e} (tol {KV8_MODEL_TOL[kv]})")
    llama_8b_model_check_params.cache_clear()  # its 6 GB of CPU weights


# The families' configurations, from their public config.json (the
# Hugging Face model repositories of the names): random bf16 weights from a
# seed at these widths. The services run each at 4 of its layers (the
# smoke's time limit, with the head dims' and groups' services beside them;
# Mixtral-8x7B's 32 take about 93 GB in bf16, past the card's 80).
FAMILIES = {
    "Mistral-7B-v0.1": (dict(
        model_type="mistral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rope_theta=10000.0, rms_norm_eps=1e-5,
        sliding_window=4096, tie_word_embeddings=False, bos_token_id=1, eos_token_id=2), 4),
    "Qwen2-7B": (dict(
        model_type="qwen2", vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=131072, rope_theta=1000000.0, rms_norm_eps=1e-6,
        sliding_window=131072, use_sliding_window=False, tie_word_embeddings=False,
        bos_token_id=151643, eos_token_id=151643), 4),
    "Phi-3-mini-4k-instruct": (dict(
        model_type="phi3", vocab_size=32064, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
        sliding_window=2047, tie_word_embeddings=False, bos_token_id=1, eos_token_id=32000), 4),
    "Gemma-2-9B": (dict(
        model_type="gemma2", vocab_size=256000, hidden_size=3584, intermediate_size=14336,
        num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8, head_dim=256,
        max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
        query_pre_attn_scalar=256, sliding_window=4096, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True, bos_token_id=2, eos_token_id=1), 4),
    "Mixtral-8x7B-v0.1": (dict(
        model_type="mixtral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rope_theta=1000000.0, rms_norm_eps=1e-5,
        sliding_window=None, num_local_experts=8, num_experts_per_tok=2,
        tie_word_embeddings=False, bos_token_id=1, eos_token_id=2), 4),
}
# The published checkpoints that need 9 to 16 q heads per kv head (the
# public config.json of each Hugging Face model repository), served at a
# cut depth with random weights from a seed: (config, layers, weight
# quantization, KV caches). Mistral-Large-Instruct-2407 at 4 of its 88
# layers in bf16 over a bf16 cache (15 GB of weights); Llama-3.1-405B at 4
# of its 126 layers with INT8 weights over an INT8 cache, then an e4m3 one
# (21 GB). All their layers would take 245 GB and 410 GB, past the card's
# 80. No published checkpoint of the registries' families has more than
# 16 q heads per kv head: the third takes Llama-3.1-8B's published widths
# and rope and lets its 32 q heads share one kv head (G = 32, as an MQA
# checkpoint of the Llama architecture would), at 4 of its 32 layers in
# bf16 over a bf16 cache and then an INT8 one; its decode steps take the
# write and the ragged kernel.
GROUP_FAMILIES = {
    "Mistral-Large-Instruct-2407": (dict(
        model_type="mistral", vocab_size=32768, hidden_size=12288, intermediate_size=28672,
        num_hidden_layers=88, num_attention_heads=96, num_key_value_heads=8, head_dim=128,
        max_position_embeddings=131072, rope_theta=1000000.0, rms_norm_eps=1e-5,
        sliding_window=None, tie_word_embeddings=False, bos_token_id=1, eos_token_id=2),
        4, None, (None,)),
    "Llama-3.1-405B": (dict(
        model_type="llama", vocab_size=128256, hidden_size=16384, intermediate_size=53248,
        num_hidden_layers=126, num_attention_heads=128, num_key_value_heads=8,
        max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0, original_max_position_embeddings=8192),
        rms_norm_eps=1e-5, tie_word_embeddings=False, bos_token_id=128000,
        eos_token_id=128001), 4, "int8", KV8_DTYPES),
    "Llama-3.1-8B MQA": (dict(
        model_type="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=1,
        max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0, original_max_position_embeddings=8192),
        rms_norm_eps=1e-5, tie_word_embeddings=False, bos_token_id=128000,
        eos_token_id=128001), 4, None, (None, "int8")),
}
# The published checkpoints whose head dims the kernels run at a padded
# width (the public config.json of each Hugging Face model repository),
# served at 4 layers with random weights from a seed over the caches listed:
# h2o-danube-1.8b (Mistral: 32 q / 8 kv heads of 80, window 4,096; at width
# 96) over a bf16 and an INT8 cache, OpenLLaMA-3B (Llama: 32 / 32 of 100; at
# 128) over a bf16 and an e4m3 one, h2o-danube3-4b (Llama: 32 / 8 of 120; at
# 128) over a bf16 one. (config, layers, KV caches.)
HEAD_DIM_FAMILIES = {
    "h2o-danube-1.8b": (dict(
        model_type="mistral", vocab_size=32000, hidden_size=2560, intermediate_size=6912,
        num_hidden_layers=24, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=16384, rope_theta=10000.0, rms_norm_eps=1e-5,
        sliding_window=4096, tie_word_embeddings=False, bos_token_id=1, eos_token_id=2),
        4, (None, "int8")),
    "OpenLLaMA-3B": (dict(
        model_type="llama", vocab_size=32000, hidden_size=3200, intermediate_size=8640,
        num_hidden_layers=26, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, bos_token_id=1, eos_token_id=2), 4, (None, "fp8")),
    "h2o-danube3-4b": (dict(
        model_type="llama", vocab_size=32000, hidden_size=3840, intermediate_size=10240,
        num_hidden_layers=24, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=8192, rope_theta=100000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, bos_token_id=1, eos_token_id=2), 4, (None,)),
    # No published checkpoint has more than 128 q heads per kv head: this
    # takes Llama-3.1-70B's published widths and rope with head dim 32, so
    # that its 8,192 hidden make 256 q heads, over one kv head (G = 256,
    # two slices a token in the tensor-core ragged kernel).
    "Llama-3.1-70B G=256": (dict(
        model_type="llama", vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_hidden_layers=80, num_attention_heads=256, num_key_value_heads=1, head_dim=32,
        max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0, original_max_position_embeddings=8192),
        rms_norm_eps=1e-5, tie_word_embeddings=False, bos_token_id=128000,
        eos_token_id=128001), 4, (None,)),
    # No published checkpoint of the registry's families has a head dim
    # past 256 or an odd one; JAX serves both (its Pallas kernel caps no
    # head dim; odd ones take its XLA path, with ALiBi, since RoPE halves
    # the head dim). These take published widths with such heads:
    # Gemma-2-9B with 8 q heads over 4 kv heads of 512 (q, k and v
    # projections of the published 4,096, 2,048 and 2,048 columns; its soft
    # caps, query_pre_attn_scalar and 4,096-key window on alternate layers)
    # over a bf16 and an INT8 cache; Llama-3.1-8B with 8 q heads over 2 kv
    # heads of 512 (4,096, 1,024 and 1,024 columns) over an e4m3 cache;
    # Llama-3.2-1B with ALiBi in place of RoPE (models/llama.py use_alibi)
    # and 32 q heads over 8 kv heads of 63 over a bf16 and an INT8 cache.
    "Gemma-2-9B D=512": (dict(
        model_type="gemma2", vocab_size=256000, hidden_size=3584, intermediate_size=14336,
        num_hidden_layers=42, num_attention_heads=8, num_key_value_heads=4, head_dim=512,
        max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
        query_pre_attn_scalar=256, sliding_window=4096, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True, bos_token_id=2, eos_token_id=1), 4, (None, "int8")),
    "Llama-3.1-8B D=512": (dict(
        model_type="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=8, num_key_value_heads=2, head_dim=512,
        max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0, original_max_position_embeddings=8192),
        rms_norm_eps=1e-5, tie_word_embeddings=False, bos_token_id=128000,
        eos_token_id=128001), 4, ("fp8",)),
    "Llama-3.2-1B ALiBi D=63": (dict(
        model_type="llama", vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8, head_dim=63,
        max_position_embeddings=131072, rope_theta=500000.0, alibi=True, rms_norm_eps=1e-5,
        tie_word_embeddings=True, bos_token_id=128000, eos_token_id=128001), 4,
        (None, "int8")),
    # Past 512 (the width 512's column slices), the same published widths
    # with wider heads: Llama-3.1-8B with 4 q heads over one kv head of 1,024
    # (4,096 and 1,024 columns) over a bf16 and an e4m3 cache; Gemma-2-9B
    # with 6 q heads over 3 kv heads of 768 (its G = 2; 4,608 and 2,304
    # columns) over an INT8 cache; Llama-3.2-1B with ALiBi and 4 q heads over
    # one kv head of 513 (2,052 and 513 columns) over a bf16 one.
    "Llama-3.1-8B D=1024": (dict(
        model_type="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=4, num_key_value_heads=1, head_dim=1024,
        max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                          high_freq_factor=4.0, original_max_position_embeddings=8192),
        rms_norm_eps=1e-5, tie_word_embeddings=False, bos_token_id=128000,
        eos_token_id=128001), 4, (None, "fp8")),
    "Gemma-2-9B D=768": (dict(
        model_type="gemma2", vocab_size=256000, hidden_size=3584, intermediate_size=14336,
        num_hidden_layers=42, num_attention_heads=6, num_key_value_heads=3, head_dim=768,
        max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
        query_pre_attn_scalar=256, sliding_window=4096, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True, bos_token_id=2, eos_token_id=1), 4, ("int8",)),
    "Llama-3.2-1B ALiBi D=513": (dict(
        model_type="llama", vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=4, num_key_value_heads=1, head_dim=513,
        max_position_embeddings=131072, rope_theta=500000.0, alibi=True, rms_norm_eps=1e-5,
        tie_word_embeddings=True, bos_token_id=128000, eos_token_id=128001), 4, (None,)),
}
# The head-dim families' weight seeds, in the order they joined: a family's
# weights stay the same when another is added.
HEAD_DIM_SEED_ORDER = ("Llama-3.1-70B G=256", "OpenLLaMA-3B", "h2o-danube-1.8b",
                       "h2o-danube3-4b", "Gemma-2-9B D=512", "Llama-3.1-8B D=512",
                       "Llama-3.2-1B ALiBi D=63", "Llama-3.1-8B D=1024", "Gemma-2-9B D=768",
                       "Llama-3.2-1B ALiBi D=513")
# The family models' logits with the attention kernels against the same
# bf16 model with the plain attention on the card: max |Δ| over the logits'
# largest magnitude. The two round each attention output to bf16 from f32
# sums taken in another order (a bf16 step, 2^-8 relative, where a sum
# straddles a rounding boundary), and 2 layers and the LM head carry that;
# a wrong scale, window, soft cap or head layout moves logits by their own
# size.
FAMILY_MODEL_TOL = 3e-2


def family_model(torch, name, num_layers, dtype=None):
    """The family's model (``FAMILIES``, ``GROUP_FAMILIES`` or
    ``HEAD_DIM_FAMILIES``) on the card
    at its published widths and ``num_layers`` layers, bf16 (or
    ``dtype``), with random weights from a seed."""
    from atoma_infer_tpu_torch.models.registry import get_model_cls
    from atoma_infer_tpu_torch.models.weights import config_from_hf_dict

    if name in FAMILIES:
        spec, seed = FAMILIES[name][0], sorted(FAMILIES).index(name)
    elif name in GROUP_FAMILIES:
        spec, seed = GROUP_FAMILIES[name][0], len(FAMILIES) + sorted(GROUP_FAMILIES).index(name)
    else:
        spec = HEAD_DIM_FAMILIES[name][0]
        seed = len(FAMILIES) + len(GROUP_FAMILIES) + HEAD_DIM_SEED_ORDER.index(name)
    cfg = config_from_hf_dict(dict(spec, num_hidden_layers=num_layers))
    model = get_model_cls(cfg.architecture)(cfg, dtype=dtype or torch.bfloat16, device="cuda")
    return model, model.init_params(torch.Generator(device=model.device).manual_seed(seed))


class plain_attention:
    """While open: the attention wrappers' CUDA entries are their plain
    versions, so a model on the card attends without the kernels (the
    reference of :func:`check_family_models`; the port itself never does)."""

    def __enter__(self):
        from atoma_infer_tpu_torch.ops import kv_write
        from atoma_infer_tpu_torch.ops import paged_attention as pa

        self.saved = (pa.ragged_paged_attention_cuda, pa.ragged_paged_attention_fused_cuda,
                      kv_write.write_kv_cache_cuda)
        pa.ragged_paged_attention_cuda = pa.ragged_paged_attention_paged_plain
        pa.ragged_paged_attention_fused_cuda = pa.fused_decode_attention_plain
        kv_write.write_kv_cache_cuda = kv_write.write_kv_cache_plain

    def __exit__(self, *exc):
        from atoma_infer_tpu_torch.ops import kv_write
        from atoma_infer_tpu_torch.ops import paged_attention as pa

        (pa.ragged_paged_attention_cuda, pa.ragged_paged_attention_fused_cuda,
         kv_write.write_kv_cache_cuda) = self.saved


def check_family_models(torch):
    """Each family (Mistral-7B, Qwen2-7B, Phi-3-mini, Gemma-2-9B,
    Mixtral-8x7B) with 2 layers at its published widths, bf16 on the card:
    a prefill and 3 decode steps of two sequences through the kernels,
    against the same model attending through the plain versions on the
    card. Logits finite, of the vocabulary's width, within
    ``FAMILY_MODEL_TOL``; the KV caches after the steps within it too."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    for name in FAMILIES:
        model, params = family_model(torch, name, 2)
        caches = {mode: model.alloc_kv_cache(64, BS) for mode in ("kernels", "plain")}
        worst = 0.0
        before = {k: v.launches for k, v in cuda_lib.KERNELS.items()}
        for step, decode, batch in two_sequence_steps():
            got = step_logits(torch, model, params, batch, caches["kernels"])
            with plain_attention():
                want = step_logits(torch, model, params, batch, caches["plain"])
            if got.shape != (2, model.config.vocab_size) or not torch.isfinite(got).all():
                raise AssertionError(f"model {name}: logits {tuple(got.shape)}, finite "
                                     f"{bool(torch.isfinite(got).all())}")
            err = (got - want).abs().max().item() / want.abs().max().item()
            worst = max(worst, err)
            if err > FAMILY_MODEL_TOL:
                raise AssertionError(f"model {name} step {step}: logits differ by {err:.3e} "
                                     f"of their largest (tol {FAMILY_MODEL_TOL})")
        for layer, (c, p) in enumerate(zip(caches["kernels"], caches["plain"])):
            err = (c.float() - p.float()).abs().max().item() / p.float().abs().max().item()
            if err > FAMILY_MODEL_TOL:
                raise AssertionError(f"model {name}: layer {layer} cache differs by {err:.3e}")
        ran = [k for k, v in cuda_lib.KERNELS.items() if v.launches > before.get(k, 0)]
        log(f"model {name} (2 layers, D={model.config.head_dim}): kernels against the plain "
            f"attention on the card, max |Δ logit| {worst:.3e} of the largest (tol "
            f"{FAMILY_MODEL_TOL}); kernels launched {ran}")
        for kernel in ATTENTION_PATH:
            if kernel not in ran:
                raise AssertionError(f"model {name}: {kernel} was not launched")
        del model, params, caches
        gc.collect()
        torch.cuda.empty_cache()


def check_service_parity(torch):
    """The service on the card (kernels, pinned host swap tier) against the
    same service on the CPU (plain versions): the tiny random Llama in f32,
    its weights drawn once on the CPU, and a pool of 12 blocks, so that
    2-sequence groups are preempted by swap. Greedy tokens must be identical
    (``top_k=1`` makes the sampled groups greedy whatever the noise), swaps
    must have happened on both, every block must come back, and the ragged
    launches must be the CUDA cores' (f32 queries). Returns A's CUDA-core
    launches from the card run (counts set to 0 just before it)."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import build_tiny_random
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    from atoma_infer_tpu_torch.ops import cuda_lib

    cpu_model, cpu_params, tokenizer = build_tiny_random("cpu")
    gpu_model = Llama(cpu_model.config, dtype=torch.float32, device="cuda")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]
    blocks = 12
    runs = {}
    for k in cuda_lib.KERNELS.values():
        k.launches = 0
    for name, model, params in (
        ("cpu", cpu_model, cpu_params),
        ("cuda", gpu_model, params_to(cpu_params, gpu_model.device)),
    ):
        config = EngineConfig(
            model=ModelConfig(model_name="tiny-random", dtype="float32"),
            cache=CacheConfig(
                block_size=16, num_device_blocks_override=blocks, num_host_blocks_override=64,
            ),
            scheduler=SchedulerConfig(
                max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
            ),
            validation=ValidationConfig(best_of=2, max_input_tokens=128, max_total_tokens=256),
        )
        service = LlmService.start(
            config, model=model, params=params, tokenizer=tokenizer, device=model.device
        )
        cache_engine = service.engine.worker.cache_engine
        swap_out = cache_engine.swap_out
        swapped = []

        def counting_swap_out(mapping, swap_out=swap_out, swapped=swapped):
            swapped.append(len(mapping))
            return swap_out(mapping)

        cache_engine.swap_out = counting_swap_out

        async def drive(service=service):
            task = asyncio.create_task(service.engine.run())
            futs = [
                await service.handle_request(GenerateRequest(
                    request_id=f"parity-{i}", inputs=prompt,
                    parameters=GenerateParameters(
                        max_new_tokens=20, best_of=2, do_sample=True, top_k=1, seed=i,
                    ),
                ))
                for i, prompt in enumerate(prompts)
            ]
            results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
            service.stop()
            task.cancel()
            return results

        results = asyncio.run(drive())
        free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
        if free != blocks:
            raise AssertionError(f"service parity ({name}): {blocks - free} blocks leaked")
        if not sum(swapped):
            raise AssertionError(f"service parity ({name}): no group was swapped out")
        runs[name] = [[tuple(o.token_ids) for o in r.outputs] for r in results]
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError("service parity: greedy tokens differ between card and CPU")
    counts = {k: c.launches for k, c in cuda_lib.KERNELS.items()}
    check_route("service parity (f32)", counts, bf16=False)
    path = ("ragged_paged_attention", "fused_decode_attention")
    if not all(counts[k] for k in path):
        raise AssertionError(f"service parity: f32 path not launched: {[counts[k] for k in path]}")
    n = sum(len(t) for r in runs["cuda"] for t in r)
    log(f"service parity: {len(prompts)} requests × 2 sequences, {n} greedy tokens "
        f"identical on the card and the CPU, with swaps on both; f32 queries: the CUDA-core "
        f"ragged kernel launched {counts['ragged_paged_attention']} times, the unsplit fused "
        f"kernel {counts['fused_decode_attention']}")
    return {k: counts[k] for k in path}


def check_quant_service_parity(torch):
    """``tiny_trained`` through ``LlmService.start`` from its directory with
    INT8 and then INT4 quantization on load, in f32, on the card (F and G on
    the CUDA cores: f32 activations) against the CPU (plain versions), with
    a pool of 5 blocks so that requests are preempted by recompute: greedy
    tokens identical, every block back in the pool. Returns the CUDA-core
    kernels' launches, each from its own card run (counts set to 0 just
    before it)."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.server import metrics
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]
    blocks = 5
    launches = {}
    for quantization in ("int8", "int4"):
        kernel = f"quantized_matmul_{quantization}"
        runs = {}
        for device in ("cpu", "cuda"):
            config = EngineConfig(
                model=ModelConfig(model_name=fixture, dtype="float32", quantization=quantization),
                cache=CacheConfig(
                    block_size=16, num_device_blocks_override=blocks, num_host_blocks_override=64,
                ),
                scheduler=SchedulerConfig(
                    max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
                ),
                validation=ValidationConfig(max_input_tokens=128, max_total_tokens=256),
            )
            service = LlmService.start(config, model_dir=fixture, device=device)
            preempt0 = metrics.PREEMPTIONS.value
            for k in cuda_lib.KERNELS.values():
                k.launches = 0

            async def drive(service=service):
                task = asyncio.create_task(service.engine.run())
                futs = [
                    await service.handle_request(GenerateRequest(
                        request_id=f"quant-parity-{i}", inputs=prompt,
                        parameters=GenerateParameters(max_new_tokens=16),
                    ))
                    for i, prompt in enumerate(prompts)
                ]
                results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
                service.stop()
                task.cancel()
                return results

            results = asyncio.run(drive())
            launched = cuda_lib.KERNELS[kernel].launches
            label = f"quantized service parity {quantization} ({device})"
            free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
            if free != blocks:
                raise AssertionError(f"{label}: {blocks - free} blocks leaked")
            if metrics.PREEMPTIONS.value == preempt0:
                raise AssertionError(f"{label}: no preemption")
            if (device == "cuda") != (launched > 0):
                raise AssertionError(f"{label}: {launched} launches of {kernel}")
            if device == "cuda":
                launches[kernel] = launched
                check_route(label, {k: c.launches for k, c in cuda_lib.KERNELS.items()},
                            bf16=False)
            runs[device] = [tuple(r.outputs[0].token_ids) for r in results]
        if runs["cuda"] != runs["cpu"]:
            raise AssertionError(f"quantized service parity {quantization}: greedy tokens "
                                 "differ between card and CPU")
        n = sum(len(t) for t in runs["cuda"])
        log(f"quantized service parity: tiny_trained {quantization.upper()} f32, {len(prompts)} "
            f"requests, {n} greedy tokens identical on the card and the CPU, with preemption "
            f"by recompute on both; {kernel} launched {launches[kernel]} times")
    return launches


def kv8_path(kv, *, mma=True):
    """The kernels of a path over a 1-byte cache: bf16 queries take the
    tensor-core ragged kernel and the split fused one, f32 queries
    (``mma=False``) the CUDA-core ragged kernel and the unsplit fused one."""
    return (f"reshape_and_cache_{kv}", f"ragged_paged_attention_{kv}{'_mma' if mma else ''}",
            f"fused_decode_attention_{kv}{'_split' if mma else ''}")


# The ragged kernels by route: bf16 queries must never launch the CUDA-core
# kernels, nor f32 queries the tensor-core ones.
# (The wide head dims' and the width 512's instantiations of each have
# names of their own.)
_KV_SUFFIXES = ("", "_int8", "_fp8")
CUDA_CORE_RAGGED = tuple(f"ragged_paged_attention{s}{w}" for s in _KV_SUFFIXES
                         for w in ("", "_wide", "_w512"))
TENSOR_CORE_RAGGED = tuple(f"ragged_paged_attention{s}_mma{w}" for s in _KV_SUFFIXES
                           for w in ("", "_wide", "_w512") if s or w != "_wide")
# Likewise the fused decode kernels: bf16 queries the split kernel, f32
# queries the unsplit one.
UNSPLIT_FUSED = tuple(f"fused_decode_attention{s}{w}" for s in _KV_SUFFIXES
                      for w in ("", "_wide", "_w512"))
SPLIT_FUSED = tuple(f"fused_decode_attention{s}_split{w}" for s in _KV_SUFFIXES
                    for w in ("", "_wide", "_w512") if s or w != "_wide")


def check_route(label, launches, *, bf16):
    """Every ragged and fused launch of a run on the route its queries'
    dtype asks for."""
    off = (CUDA_CORE_RAGGED + UNSPLIT_FUSED) if bf16 else (TENSOR_CORE_RAGGED + SPLIT_FUSED)
    wrong = {k: launches[k] for k in off if launches[k]}
    if wrong:
        raise AssertionError(f"{label}: attention launches off the {'bf16' if bf16 else 'f32'} "
                             f"route: {wrong}")


def check_kv8_service_parity(torch):
    """``tiny_trained`` from its directory with an INT8 KV cache (and INT8
    weights) and with an e4m3 one, on the card (kernels) against the CPU
    (plain versions): 2-sequence greedy groups on a pool of 12 blocks, so
    that groups are swapped to the host tier (INT8 scales with their pages)
    and back. Greedy tokens identical, swaps on both, every block back, and
    on the card every kernel of the path launched, the ragged one on the CUDA
    cores and the unsplit fused one (f32 queries). Returns D's and E's
    CUDA-core ragged and unsplit fused launches, each from its own card run
    (counts set to 0 just before it)."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(6)]
    blocks = 12
    launches = {}
    for kv, quantization in (("int8", "int8"), ("fp8", None)):
        runs = {}
        for device in ("cpu", "cuda"):
            config = EngineConfig(
                model=ModelConfig(model_name=fixture, dtype="float32",
                                  quantization=quantization, kv_cache_dtype=kv),
                cache=CacheConfig(block_size=16, num_device_blocks_override=blocks,
                                  num_host_blocks_override=64),
                scheduler=SchedulerConfig(
                    max_num_batched_tokens=256, max_num_sequences=8, max_model_len=256,
                ),
                validation=ValidationConfig(best_of=2, max_input_tokens=128,
                                            max_total_tokens=256),
            )
            service = LlmService.start(config, model_dir=fixture, device=device)
            cache_engine = service.engine.worker.cache_engine
            swapped = []
            swap_out = cache_engine.swap_out

            def counting_swap_out(mapping, swap_out=swap_out, swapped=swapped):
                swapped.append(len(mapping))
                return swap_out(mapping)

            cache_engine.swap_out = counting_swap_out
            if device == "cuda":
                for k in cuda_lib.KERNELS.values():
                    k.launches = 0
            before = {k: cuda_lib.KERNELS[k].launches for k in kv8_path(kv, mma=False)}

            async def drive(service=service):
                task = asyncio.create_task(service.engine.run())
                futs = [
                    await service.handle_request(GenerateRequest(
                        request_id=f"kv-parity-{i}", inputs=prompt,
                        parameters=GenerateParameters(
                            max_new_tokens=16, best_of=2, do_sample=True, top_k=1, seed=i,
                        ),
                    ))
                    for i, prompt in enumerate(prompts)
                ]
                results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
                service.stop()
                task.cancel()
                return results

            results = asyncio.run(drive())
            label = f"{kv} KV service parity ({device})"
            free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
            if free != blocks:
                raise AssertionError(f"{label}: {blocks - free} blocks leaked")
            if not sum(swapped):
                raise AssertionError(f"{label}: no group was swapped out")
            launched = {k: cuda_lib.KERNELS[k].launches - n for k, n in before.items()}
            if any((device == "cuda") != (n > 0) for n in launched.values()):
                raise AssertionError(f"{label}: launches {launched}")
            if device == "cuda":
                counts = {k: c.launches for k, c in cuda_lib.KERNELS.items()}
                check_route(label, counts, bf16=False)
                for k in (f"ragged_paged_attention_{kv}", f"fused_decode_attention_{kv}"):
                    launches[k] = counts[k]
            runs[device] = [[tuple(o.token_ids) for o in r.outputs] for r in results]
        if runs["cuda"] != runs["cpu"]:
            raise AssertionError(f"{kv} KV service parity: greedy tokens differ "
                                 "between card and CPU")
        n = sum(len(t) for r in runs["cuda"] for t in r)
        log(f"{kv} KV service parity: tiny_trained{' INT8' if quantization else ''}, "
            f"{len(prompts)} requests × 2 sequences, {n} greedy tokens identical on the "
            f"card and the CPU, with swaps on both; f32 queries: the CUDA-core ragged "
            f"kernel launched {launches[f'ragged_paged_attention_{kv}']} times")
    return launches


# Test-size f32 models shaped as Phi-3 (head dim 96, a window) and Gemma-2
# (head dim 256, soft caps, a local and a global layer): the CUDA-core
# kernels' traffic at the wide head dims.
WIDE_F32_MODELS = {
    96: dict(model_type="phi3", vocab_size=512, hidden_size=192, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
             max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-5,
             sliding_window=24, tie_word_embeddings=False, bos_token_id=1, eos_token_id=2),
    256: dict(model_type="gemma2", vocab_size=512, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=256,
              max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
              query_pre_attn_scalar=256, sliding_window=16, attn_logit_softcapping=50.0,
              final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
              tie_word_embeddings=True, bos_token_id=2, eos_token_id=1),
    512: dict(model_type="gemma2", vocab_size=512, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1, head_dim=512,
              max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-6,
              query_pre_attn_scalar=256, sliding_window=16, attn_logit_softcapping=50.0,
              final_logit_softcapping=30.0, hidden_activation="gelu_pytorch_tanh",
              tie_word_embeddings=True, bos_token_id=2, eos_token_id=1),
}


def check_wide_f32_service_parity(torch):
    """The f32 test-size services at head dims 96, 256 and 512
    (``WIDE_F32_MODELS``, weights drawn once on the CPU) over an f32, an
    INT8 and an e4m3 cache, on the card (the CUDA-core ragged and unsplit
    fused kernels) against the CPU (plain versions): greedy tokens
    identical, every block back, and on the card every attention launch on
    the f32 route. Returns the CUDA-core kernels' launches (their ``*_wide``
    and ``*_w512`` instantiations) keyed ``kernel@D``, each from its own
    card run (counts set to 0 just before it)."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.models.registry import get_model_cls
    from atoma_infer_tpu_torch.models.weights import config_from_hf_dict
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops import paged_attention as pa
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    prompts = [f"wide prompt {i}, " * (1 + 3 * (i % 3)) for i in range(6)]
    blocks = 64
    launches = {}
    for d, spec in WIDE_F32_MODELS.items():
        q32 = torch.empty((1, 1, d))
        cfg = config_from_hf_dict(spec)
        cls = get_model_cls(cfg.architecture)
        cpu_model = cls(cfg, dtype=torch.float32, device="cpu")
        cpu_params = cpu_model.init_params(torch.Generator().manual_seed(d))
        gpu_model = cls(cfg, dtype=torch.float32, device="cuda")
        gpu_params = params_to(cpu_params, gpu_model.device)
        for kv in (None, "int8", "fp8"):
            kind = _KINDS[kv] and getattr(torch, _KINDS[kv])
            names = (pa.ragged_route(q32, kind).name, pa.fused_route(q32, kind).name)
            runs = {}
            for device, model, params in (("cpu", cpu_model, cpu_params),
                                          ("cuda", gpu_model, gpu_params)):
                config = EngineConfig(
                    model=ModelConfig(model_name=f"tiny-{spec['model_type']}-d{d}",
                                      dtype="float32", kv_cache_dtype=kv),
                    cache=CacheConfig(block_size=BS, num_device_blocks_override=blocks,
                                      num_host_blocks_override=16),
                    scheduler=SchedulerConfig(max_num_batched_tokens=64, max_num_sequences=8,
                                              max_model_len=256, enable_chunked_prefill=True),
                    validation=ValidationConfig(max_input_tokens=128, max_total_tokens=256),
                )
                service = LlmService.start(config, model=model, params=params,
                                           tokenizer=ByteTokenizer(cfg.vocab_size),
                                           device=model.device)
                if device == "cuda":
                    for k in cuda_lib.KERNELS.values():
                        k.launches = 0

                async def drive(service=service):
                    task = asyncio.create_task(service.engine.run())
                    futs = [await service.handle_request(GenerateRequest(
                        request_id=f"wide-{i}", inputs=prompt,
                        parameters=GenerateParameters(max_new_tokens=16)))
                        for i, prompt in enumerate(prompts)]
                    results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
                    service.stop()
                    task.cancel()
                    return results

                results = asyncio.run(drive())
                label = f"f32 D={d} {kv or 'f32'} KV service parity ({device})"
                free = service.engine.scheduler.block_manager.get_num_free_device_blocks()
                if free != blocks:
                    raise AssertionError(f"{label}: {blocks - free} blocks leaked")
                runs[device] = [tuple(r.outputs[0].token_ids) for r in results]
                if device == "cuda":
                    counts = {k: c.launches for k, c in cuda_lib.KERNELS.items()}
                    check_route(label, counts, bf16=False)
                    for k in names:
                        if not counts[k]:
                            raise AssertionError(f"{label}: {k} was not launched")
                        launches[f"{k}@{d}"] = counts[k]
            if runs["cuda"] != runs["cpu"]:
                raise AssertionError(f"f32 D={d} {kv or 'f32'} KV service parity: greedy tokens "
                                     "differ between card and CPU")
            log(f"f32 D={d} ({spec['model_type']}) {kv or 'f32'} KV service parity: "
                f"{len(prompts)} requests, {sum(map(len, runs['cuda']))} greedy tokens identical "
                f"on the card and the CPU; CUDA-core ragged kernel {names[0]} launched "
                f"{launches[f'{names[0]}@{d}']} times, unsplit fused {names[1]} "
                f"{launches[f'{names[1]}@{d}']}")
        del cpu_model, cpu_params, gpu_model, gpu_params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 4
# The bf16 attention path: the ragged kernel on the tensor cores, the split
# fused decode kernel. The services' decode steps (8 sequences of up to 330
# keys) split, so their runs also launch the merge of split rows.
ATTENTION_PATH = ("reshape_and_cache", "ragged_paged_attention_mma",
                  "fused_decode_attention_split")
SERVICE_PATH = ATTENTION_PATH + ("paged_attention_split_combine",)
# The services' mixed prefill+decode step (0-based, among mixed steps) that
# runs under torch.profiler.
PROFILED_MIXED_STEP = 0
# The services' second wave of requests is admitted just before this engine
# step (1-based; the first wave, admitted together, then decodes), the same
# step in both modes, so a synchronous and an async run schedule the same
# batches.
SECOND_WAVE_STEP = 7
# The window of pure-decode steps (0-based among them, after the profiled
# single step) whose device idle share torch.profiler measures in both modes:
# async steps overlap, so one step alone cannot show it.
IDLE_WINDOW_START, IDLE_WINDOW_STEPS = 16, 8
# Tokens each of the services' 8 requests generates. The 1B bf16 and 8B
# INT8 services, whose periods come first in PERF.md: a few hundred
# steady-decode intervals a run, so that their p99 is a percentile and not
# the slowest interval. The others half as many, which keeps the smoke
# inside half its time limit on a slow host.
NEW_TOKENS, OTHER_SERVICES_TOKENS = 256, 128
# The depth of the 8B services held only eager against graphs (INT4, W8A8,
# INT8 and e4m3 KV): 4 of Llama-3.1-8B's 32 layers, as the families run at
# 4 of theirs, so that the smoke stays inside its time limit.
QUANT_HALF_LAYERS = 4
# The depth of the 8B INT8 service (async with graphs after warmup) and its
# INT8 KV spec service: a quarter of the 32 layers, for the same limit.
QUANT_MAIN_LAYERS = 8


# The bytes of the services' 8 prompts (one token a byte).
PROMPT_LENGTHS = (16, 300, 45, 120, 200, 77, 250, 33)
# The services' seeded sampled request (the fourth): its sampling options.
SEEDED_REQUEST, SEEDED_OPTIONS = 3, dict(temperature=0.8, top_p=0.9, seed=1234)


def percentile(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))]


# The 1B bf16 service's penalty request (a greedy request of the second
# wave): its options and its tokens, few enough that the service's steady
# decode, which a penalty batch runs synchronously, is measured after it.
PENALTY_REQUEST, PENALTY_TOKENS = 7, 32
PENALTY_OPTIONS = dict(repetition_penalty=1.2, frequency_penalty=0.5)


def step_kind(prefills, decodes):
    """A step's kind by its groups: prefill only, mixed or decode."""
    return "decode" if not prefills else "mixed" if decodes else "prefill"


def graph_kind(key, kind):
    """A graph run's kind: its step's (``step_kind``), verify steps apart
    (beside a prefill chunk or not), penalties marked."""
    from atoma_infer_tpu_torch.engine.cuda_graphs import StepKey, VerifyKey

    if isinstance(key, VerifyKey):
        return "verify"
    if isinstance(key, StepKey):
        if key.spec:
            kind = "verify" if kind == "decode" else "verify+prefill"
        if key.needs_penalties:
            kind = f"penalty {kind}"
    return kind


def report_graph_runs(label, run, graph_runs):
    """Print the traffic's graph runs by step kind, replays and first
    captures, and the captures and evictions inside the traffic's window;
    raise when a step ran eagerly after its key's capture."""
    eager = sorted({key for key, seen, replayed, _ in graph_runs if seen and not replayed})
    if eager:
        raise AssertionError(f"service {label}: steps ran eagerly after their key's capture: "
                             f"{eager}")
    by = {}
    for _, _, replayed, kind in graph_runs:
        by.setdefault(kind, [0, 0])[0 if replayed else 1] += 1
    captures = sum(c for _, c in by.values())
    log(f"service {label}: graph runs in the traffic by step kind (replays / first captures): "
        + ", ".join(f"{k} {r} / {c}" for k, (r, c) in sorted(by.items()))
        + f"; {captures} captures and {run['evictions']} evictions inside the traffic's window")


# The modes a service runs in: synchronous with its CUDA graphs taken away
# (the eager baseline), synchronous with them (``LlmService.start`` as a
# user gets it: each graph captured at its key's first step in traffic),
# and async scheduling (depth 2) after ``service.warmup()``.
MODES = ("eager", "graphs", "async+graphs")


def serve(torch, label, model, params, config, path, *, mode="eager",
          new_tokens=NEW_TOKENS, prompt_lengths=PROMPT_LENGTHS, prompts=None, top_n=0,
          stats=None, penalty=False):
    """Drive one service: 8 requests of ``new_tokens`` tokens (prompts of
    ``prompt_lengths`` bytes, or ``prompts``; each asking ``top_n``
    alternatives) with chunked prefill in two waves (the second admitted before engine step
    ``SECOND_WAVE_STEP``), in ``mode`` (``MODES``); eager runs profile one
    pure-decode and one mixed step. In all modes: the steady-decode period
    (wall between successive pure-decode dispatches, those that captured a
    graph and the profiled window left out), the tokens/s over the whole
    traffic window, the device idle share over a window of 8 pure-decode
    steps, and with graphs their memory. With speculative decoding, the
    drafts proposed and accepted and the verify steps: eager (a)'s step
    wall, and in (b) each verify key's first capture and replays, none
    eager after it. Every request must finish, every block return, and
    every kernel of ``path`` launch. With ``penalty``, request
    ``PENALTY_REQUEST`` asks repetition and frequency penalties
    (``PENALTY_OPTIONS``) for its ``PENALTY_TOKENS`` tokens. With graphs:
    every step whose key was captured before must replay (nothing runs
    eagerly after a capture); the replays by step kind, the captures and
    evictions inside the traffic's window, and the mixed steps' walls
    (each mixed dispatch to the next dispatch) are printed. Returns (the
    launch counts of the traffic's run, all set to 0 just before it; each
    request's tokens); fills ``stats`` with the run's figures."""
    from concurrent.futures import ThreadPoolExecutor

    from atoma_infer_tpu_torch.engine import input_prep
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.ops import cuda_lib, paged_attention
    from atoma_infer_tpu_torch.server import metrics
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest
    from atoma_infer_tpu_torch.utils import tracing
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stats = {} if stats is None else stats
    spec_k = config.scheduler.num_speculative_tokens
    async_graphs = mode == "async+graphs"
    if mode not in MODES or config.scheduler.async_scheduling != async_graphs:
        raise ValueError(f"{label}: mode {mode} with async_scheduling "
                         f"{config.scheduler.async_scheduling}")
    cfg = model.config
    input_prep.SHAPE_COUNTS.clear()
    service = LlmService.start(
        config, model=model, params=params, tokenizer=ByteTokenizer(cfg.vocab_size),
        device=model.device,
    )
    label = f"{label} [{mode}]"
    pool = config.cache.num_device_blocks
    log(f"service {label}: KV pool {pool} blocks of {config.cache.block_size} tokens")
    engine = service.engine
    worker = engine.worker
    if worker.graphs is None:
        raise AssertionError(f"service {label}: a CUDA worker without decode graphs")
    if mode == "eager":
        # The eager baseline: without its graphs the worker runs every step
        # eagerly, as it did before it had them.
        worker.graphs = None

    # Per step: (prefill groups, decode groups, wall seconds of the worker
    # call, which ends when the sampled tokens are on the host, whether it
    # ran under the profiler).
    steps = []
    # The eager run's verify steps' walls (s).
    verify_walls = []
    profiled = {}
    execute = worker.execute_model
    # Set while a step runs under a profiler (the single steps, the idle
    # window): such steps are left out of the wall-clock statistics.
    traced_now = {"single": False, "window": 0}

    def timed_execute(request):
        metas = request.sequence_groups_metadata
        prefills = sum(m.is_prompt for m in metas)
        decodes = len(metas) - prefills
        t0 = time.monotonic()
        pure_decode = [s for s in steps if s[1] and not s[0]]
        mixed_steps = [s for s in steps if s[1] and s[0]]
        kind = None
        if not prefills and len(pure_decode) == PROFILED_DECODE_STEP:
            kind = "decode"
        elif prefills and decodes and len(mixed_steps) == PROFILED_MIXED_STEP:
            kind = "mixed"
        traced = kind is not None
        window_mark = traced_now["window"]
        if traced:
            traced_now["single"] = True
            prof = profiled.setdefault(kind, {})
            # The mixed step's ragged calls are kept to be replayed after the
            # run through the CUDA-core kernel, for its device time on the
            # same inputs.
            if kind == "mixed":
                paged_attention.ragged_paged_attention_cuda = recording
            try:
                out, prof["wall_ms"], prof["busy_ms"], prof["kernels"] = \
                    profile_device(torch, lambda: execute(request))
            finally:
                paged_attention.ragged_paged_attention_cuda = ragged
                traced_now["single"] = False
            prof["seqs"] = decodes
            prof["prefills"] = prefills
        else:
            out = execute(request)
        traced = traced or window_mark != traced_now["window"] or "prof" in window
        steps.append((prefills, decodes, time.monotonic() - t0, traced))
        if not traced and not prefills and any(m.spec_token_ids for m in metas):
            verify_walls.append(steps[-1][2])
        return out

    ragged = paged_attention.ragged_paged_attention_cuda
    ragged_calls = []

    def recording(q, kv_cache, meta, **kw):
        ragged_calls.append((q, kv_cache, meta, kw))
        return ragged(q, kv_cache, meta, **kw)

    if mode == "eager":
        worker.execute_model = timed_execute

    # Every dispatch: host clock at its start, pure decode or not, its
    # sequences, whether it captured a graph, whether a profiler ran, and
    # how many steps were in flight when it started.
    dispatches = []
    window = {}
    dispatch = worker.dispatch
    current = {}  # the running dispatch's step kind, for its graph run

    def timed_dispatch(request, feed=None):
        metas = request.sequence_groups_metadata
        pure = bool(metas) and not any(m.is_prompt for m in metas)
        n_pure = sum(1 for d in dispatches if d["pure"])
        profiled_here = "prof" in window or traced_now["single"]
        if pure and n_pure == IDLE_WINDOW_START:
            # Device activity only: recording every host-side op would slow
            # the host, which is what the idle share is about.
            t = time.monotonic()
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["prof"].start()
            window["t0"] = time.monotonic()
            window["overhead_s"] = window["t0"] - t
            traced_now["window"] += 1
        elif pure and n_pure == IDLE_WINDOW_START + IDLE_WINDOW_STEPS and "prof" in window:
            torch.cuda.synchronize()
            t = time.monotonic()
            window["wall_ms"] = (t - window["t0"]) * 1e3
            window["done"] = window.pop("prof")
            window["done"].stop()  # its events are read after the traffic
            window["overhead_s"] += time.monotonic() - t
            traced_now["window"] += 1
            profiled_here = True
        graphs_before = len(worker.graphs.graphs) if worker.graphs is not None else 0
        in_flight = len(engine._async_queue)
        prompts_here = sum(m.is_prompt for m in metas)
        current["kind"] = step_kind(prompts_here, len(metas) - prompts_here)
        t = time.monotonic()
        out = dispatch(request, feed=feed)
        captured = worker.graphs is not None and len(worker.graphs.graphs) > graphs_before
        dispatches.append(dict(t=t, pure=pure, kind=current["kind"],
                               rows=sum(len(m.seq_data) for m in metas),
                               captured=captured, traced=profiled_here or "prof" in window,
                               in_flight=in_flight,
                               verify=any(m.spec_token_ids for m in metas),
                               drafted=sum(1 for m in metas if m.spec_token_ids)))
        return out

    # With graphs, every run of a key in the traffic: (key, captured
    # before, replayed, the step's kind); with drafts, each replay's device
    # time too (CUDA events around the replay alone, after its inputs'
    # copies).
    graph_runs = []
    replay_events = {}
    if mode != "eager":
        graph_run = worker.graphs.run

        def recorded_run(key, *args):
            seen, replays = key in worker.graphs.graphs, worker.graphs.replays
            out = graph_run(key, *args)
            graph_runs.append((key, seen, worker.graphs.replays > replays,
                               graph_kind(key, current["kind"])))
            if spec_k and not seen and key in worker.graphs.graphs:
                entry = worker.graphs.graphs[key]
                entry.graph = TimedReplay(torch, entry.graph,
                                          replay_events.setdefault(key, []))
            return out

    lengths = prompt_lengths
    text = "The quick brown fox jumps over the lazy dog. " * (-(-max(lengths) // 45))
    prompts = prompts or [text[:n] for n in lengths]

    def request(i):
        sampled = i == SEEDED_REQUEST
        penalized = penalty and i == PENALTY_REQUEST
        return GenerateRequest(
            request_id=f"smoke-{i}",
            inputs=prompts[i],
            parameters=GenerateParameters(
                max_new_tokens=PENALTY_TOKENS if penalized else new_tokens, do_sample=sampled,
                top_n_tokens=top_n or None, **(SEEDED_OPTIONS if sampled else {}),
                **(PENALTY_OPTIONS if penalized else {}),
            ),
        )

    run = {}  # the warmup's and the traffic's figures

    async def drive():
        loop = asyncio.get_running_loop()
        # One executor thread: the profiled window starts and stops in it.
        executor = ThreadPoolExecutor(max_workers=1)
        loop.set_default_executor(executor)
        task = asyncio.create_task(engine.run())
        if async_graphs:
            run["seconds"] = await service.warmup()
            while engine._has_unfinished():  # the warmup's last in-flight steps
                await asyncio.sleep(0.01)
            run["graphs"] = len(worker.graphs.graphs)
            run["capture_s"] = worker.graphs.capture_seconds
            run["shapes"] = len(input_prep.SHAPE_COUNTS)
        worker.dispatch = timed_dispatch
        if mode != "eager":
            worker.graphs.run = recorded_run
        # Admission held: every request is validated first, then the first
        # wave is admitted together and the second just before engine step
        # SECOND_WAVE_STEP (from the step's own thread: the loop thread is
        # parked awaiting this burst, and the burst ends after this step
        # because the queue is no longer empty).
        held = []
        engine.add_request = lambda *args: held.append(args)
        fut0, stream0 = await service.handle_request(request(0), stream=True)
        futs = [fut0] + [await service.handle_request(request(i)) for i in range(1, 8)]
        del engine.add_request
        engine_step = engine.step
        count = [0]

        def counted_step():
            count[0] += 1
            if count[0] == SECOND_WAVE_STEP:
                for args in held[4:]:
                    engine.add_request(*args)
            return engine_step()

        engine.step = counted_step
        for kernel in cuda_lib.KERNELS.values():
            kernel.launches = 0
        replays0 = worker.graphs.replays if worker.graphs is not None else 0
        keys0 = set(worker.graphs.graphs) if worker.graphs is not None else set()
        if worker.graphs is not None:
            run["evictions0"] = worker.graphs.evictions
        run["spec0"] = (metrics.SPEC_PROPOSED.value, metrics.SPEC_ACCEPTED.value)
        # The port's host spans (utils/tracing) time the engine's and the
        # worker's host work through the traffic.
        tracing.clear()
        tracing.enable()
        run["t0"] = time.monotonic()
        for args in held[:4]:
            engine.add_request(*args)
        try:
            results = await asyncio.wait_for(asyncio.gather(*futs), timeout=600)
        finally:
            tracing.disable()
        torch.cuda.synchronize()
        run["traffic_s"] = time.monotonic() - run["t0"]
        if "done" in window:
            window["events"] = window.pop("done").key_averages()
        run["replays"] = (worker.graphs.replays if worker.graphs is not None else 0) - replays0
        run["new_keys"] = sorted(set(worker.graphs.graphs) - keys0) \
            if worker.graphs is not None else []
        if worker.graphs is not None:
            run["evictions"] = worker.graphs.evictions - run["evictions0"]
        run["spec"] = (metrics.SPEC_PROPOSED.value - run["spec0"][0],
                       metrics.SPEC_ACCEPTED.value - run["spec0"][1])
        chunks = []
        while not stream0.empty():
            chunk = stream0.get_nowait()
            if chunk is not None:
                chunks.append(chunk)
        # A verify step streams its accepted tokens as one chunk: the text
        # is checked, and without drafts every token too.
        out0 = results[0].outputs[0]
        if "".join(c.text for c in chunks) != out0.output_text or (
                not spec_k and [c.token_id for c in chunks] != out0.token_ids):
            raise AssertionError(f"service {label}: the stream differs from the response")
        service.stop()
        task.cancel()
        executor.shutdown(wait=False)
        return results

    results = asyncio.run(drive())
    seconds = run["traffic_s"]
    launches = {name: k.launches for name, k in cuda_lib.KERNELS.items()}

    eos = set(cfg.eos_token_ids)
    generated = 0
    for i, r in enumerate(results):
        out = r.outputs[0]
        generated += len(out.token_ids)
        length = PENALTY_TOKENS if penalty and i == PENALTY_REQUEST else new_tokens
        at_length = len(out.token_ids) == length and out.finish_reason == "length_capped"
        at_eos = out.finish_reason == "stopped" and out.token_ids[-1] in eos
        if not (at_length or at_eos):
            raise AssertionError(
                f"{label} {r.request_id}: {len(out.token_ids)} tokens, finish {out.finish_reason}"
            )
    free = engine.scheduler.block_manager.get_num_free_device_blocks()
    if free != pool:
        raise AssertionError(f"service {label}: {pool - free} KV blocks leaked")
    mixed = sum(1 for d in dispatches if not d["pure"])
    traced_s = sum(t for _, _, t, traced in steps if traced)
    # Throughput over the whole traffic window, from the first admission to
    # the last response: every generated token, prefill steps and graph
    # captures included; then the same less what the measurement itself
    # took (the eager run's profiled single steps, the idle window's
    # profiler start and stop).
    measured_s = traced_s + window.get("overhead_s", 0.0)
    log(f"service {label}: {len(results)} requests, {generated} tokens, {len(dispatches)} "
        f"dispatches ({mixed} with prefill) in {seconds:.3f} s, {generated / seconds:.1f} "
        f"tokens/s over the whole window; less the measurement's {measured_s:.3f} s "
        f"({traced_s:.3f} s profiled single steps, {window.get('overhead_s', 0.0):.3f} s "
        f"profiler start and stop): {generated / (seconds - measured_s):.1f} tokens/s; "
        f"launches {launches}")
    if mixed == 0:
        raise AssertionError(f"service {label}: no mixed prefill+decode step ran")
    if spec_k:
        report_spec_steps(label, run, dispatches, verify_walls, graph_runs, replay_events)
    if mode != "eager":
        graphs = worker.graphs
        if async_graphs:
            log(f"service {label}: warmup {run['seconds']:.2f} s ({run['graphs']} graphs, "
                f"{run['shapes']} step shapes, capture {run['capture_s']:.2f} s)")
        log(f"service {label}: after traffic {len(graphs.graphs)} graphs, capture "
            f"{graphs.capture_seconds:.2f} s in all, {run['replays']} replays in the traffic; "
            f"graph keys {sorted(graphs.graphs)}")
        if run["replays"] == 0:
            raise AssertionError(f"service {label}: no pure-decode step replayed a graph")
        report_graph_runs(label, run, graph_runs)
        # A decode step's device time: the traffic's last graph replayed
        # alone, CUDA events around the replays. Its static inputs still
        # hold its last step (every graph shares them, and each replay's
        # inputs are copied in first), which it rewrites in place: the same
        # K/V bytes into the same slots.
        last = next(reversed(graphs.graphs))
        replay_ms = cuda_ms(graphs.graphs[last].graph.replay)
        check_widest_graph(label, worker, config, cfg)
        report_graph_memory(label, graphs, config, cfg)
    # Host spans: the median step is a pure-decode one (most steps are).
    spans = []
    for name in ("engine.step", "worker.dispatch", "worker.input_prep",
                 "worker.sampling_build", "worker.invoke", "worker.meta_transfer",
                 "worker.step_call",
                 "worker.fetch", "engine.patch_outputs", "engine.process_outputs"):
        ms = [r.duration_ms for r in tracing.recent_spans(name)]
        if ms:
            spans.append(f"{name} {percentile(ms, 0.5):.3f} ({len(ms)})")
    log(f"service {label}: host spans, p50 ms (count): {', '.join(spans)}")
    log(f"service {label}: SHAPE_COUNTS {len(input_prep.SHAPE_COUNTS)} shapes "
        f"{dict(sorted(input_prep.SHAPE_COUNTS.items()))}")
    # The steady-decode period: successive pure-decode dispatches with the
    # pipeline full. A capture or a profiler's stop synchronizes the device,
    # and a synchronous fallback empties the async queue; the next
    # async_depth dispatches then follow each other at host speed, so the
    # intervals up to async_depth dispatches after such a drain are left out.
    depth = config.scheduler.async_depth if async_graphs else 0
    drained = [d["captured"] or d["traced"] or d["in_flight"] < depth for d in dispatches]
    periods, rows = [], 0
    for i, (a, b) in enumerate(zip(dispatches, dispatches[1:])):
        if a["pure"] and b["pure"] and not any(drained[max(0, i - depth): i + 2]):
            periods.append((b["t"] - a["t"]) * 1e3)
            rows += a["rows"]
    captures = [(b["t"] - a["t"]) * 1e3
                for a, b in zip(dispatches, dispatches[1:]) if a["captured"]]
    # The mixed steps' walls: each dispatch with a prefill chunk to the
    # next dispatch (synchronous: its tokens fetched; async: the next step
    # scheduled), those under a profiler left out; with graphs, captures
    # and replays apart.
    mixed_walls = {}
    for a, b in zip(dispatches, dispatches[1:]):
        if a["kind"] != "decode" and not a["traced"]:
            mixed_walls.setdefault("capture" if a["captured"] else "run", []).append(
                (b["t"] - a["t"]) * 1e3)
    for part, ms in sorted(mixed_walls.items()):
        name = "first captures" if part == "capture" else "eager" if mode == "eager" else "replays"
        log(f"service {label}: steps with a prefill chunk ({name}), dispatch to the next "
            f"dispatch: p50 {percentile(ms, 0.5):.3f} ms, p99 {percentile(ms, 0.99):.3f} ms over "
            f"{len(ms)}")
    summary = {}
    if periods:
        summary = dict(p50=percentile(periods, 0.5), p99=percentile(periods, 0.99),
                       tok_s=rows / (sum(periods) / 1e3), n=len(periods))
        log(f"service {label}: steady-decode period p50 {summary['p50']:.3f} ms, p99 "
            f"{summary['p99']:.3f} ms over {len(periods)} intervals; steady decode "
            f"{summary['tok_s']:.1f} tokens/s ({rows} rows over those intervals); "
            f"first-use capture steps {len(captures)} "
            f"({', '.join(f'{c:.1f}' for c in captures)} ms)")
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3) for e in window.get("events", ())
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1])
    if kernels:
        # The window holds what the device ran between its first and last
        # dispatch, the tails of steps in flight at its start included.
        busy = sum(t for _, t in kernels)
        top = ", ".join(f"{name[:40]} {t / IDLE_WINDOW_STEPS:.3f}" for name, t in kernels[:5])
        log(f"service {label}: {IDLE_WINDOW_STEPS} pure-decode steps under torch.profiler "
            f"(device activity only): device busy {busy:.3f} ms of {window['wall_ms']:.2f} ms "
            f"wall, idle {1 - busy / window['wall_ms']:.1%}; top device time over the window "
            f"÷ {IDLE_WINDOW_STEPS} (ms): {top}")
    else:
        log(f"service {label}: idle share over {IDLE_WINDOW_STEPS} decode steps not measured "
            "(the profiler recorded no device events)")
    if mode != "eager":
        idle = (f", idle {1 - replay_ms / summary['p50']:.1%} of the steady-decode period p50"
                if summary else "")
        log(f"service {label}: the traffic's last graph {last} replayed alone: "
            f"{replay_ms:.3f} ms a step (CUDA events){idle}")
    if mode == "eager":
        for kind, pick in (("pure-decode", lambda p, d: d and not p),
                           ("mixed", lambda p, d: p and d)):
            ms = sorted(t * 1e3 for p, d, t, traced in steps if pick(p, d) and not traced)
            if ms:
                log(f"service {label}: {kind} worker step wall p50 {ms[len(ms) // 2]:.2f} ms, "
                    f"max {ms[-1]:.2f} ms over {len(ms)} steps")
        report_profiled_steps(torch, label, profiled, ragged, ragged_calls)
        busy = profiled.get("decode", {}).get("busy_ms")
        if busy and summary:
            log(f"service {label}: the profiled decode step's device busy {busy:.3f} ms is "
                f"{busy / summary['p50']:.1%} of the steady-decode period p50, idle "
                f"{1 - busy / summary['p50']:.1%}")
    for name in path:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    check_route(f"service {label}", launches, bf16=True)
    stats.update(
        tok_s=generated / seconds, period=summary, mixed=mixed_walls,
        warmup_s=run.get("seconds"),
        top=[r.outputs[0].top_logprobs for r in results] if top_n else None)
    return launches, [tuple(r.outputs[0].token_ids) for r in results]


class TimedReplay:
    """A captured graph whose replays record CUDA events around them, into
    ``events``: each replay's device time, read after the traffic."""

    def __init__(self, torch, graph, events):
        self.torch, self.inner, self.events = torch, graph, events

    def replay(self):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        self.inner.replay()
        end.record()
        self.events.append((start, end))


def report_spec_steps(label, run, dispatches, verify_walls, graph_runs, replay_events):
    """Print a speculative run's drafts and verify steps: proposed and
    accepted drafts and the acceptance rate; the verify steps, the
    sequences they carried and the tokens each yields (those sequences'
    tokens plus the accepted drafts); eager (a)'s verify step wall; with
    graphs, the verify keys' first captures and replays, none eager after a
    capture (else it raises), each replay's device time beside the
    pure-decode replays at the same S, and every key first captured inside
    the timed window."""
    from atoma_infer_tpu_torch.engine.cuda_graphs import DecodeKey, VerifyKey

    proposed, accepted = run["spec"]
    verify = [d for d in dispatches if d["verify"]]
    rows = sum(d["rows"] for d in verify)
    drafted = sum(d["drafted"] for d in verify)
    if not verify or not proposed:
        raise AssertionError(f"service {label}: no step carried drafts")
    log(f"service {label}: drafts proposed {proposed:.0f}, accepted {accepted:.0f} "
        f"(rate {accepted / proposed:.1%}); {len(verify)} verify steps of {len(dispatches)} "
        f"dispatches, {rows / len(verify):.2f} sequences and {drafted / len(verify):.2f} "
        f"drafted a verify step; a verify step yields {(rows + accepted) / len(verify):.2f} "
        f"tokens, a drafted sequence {1 + accepted / max(drafted, 1):.3f}")
    if verify_walls:
        walls = sorted(t * 1e3 for t in verify_walls)
        log(f"service {label}: verify step wall (eager, no prefill) p50 "
            f"{walls[len(walls) // 2]:.2f} ms, max {walls[-1]:.2f} ms over {len(walls)} steps")
    if not graph_runs:
        return
    keyed = [r for r in graph_runs if r[3] in ("verify", "verify+prefill")]
    captured = sorted({key for key, seen, _, _ in keyed if not seen})
    replays = sum(1 for _, _, replayed, _ in keyed if replayed)
    beside = sum(1 for r in keyed if r[3] == "verify+prefill")
    log(f"service {label}: verify steps with a graph key {len(keyed)} ({beside} beside a "
        f"prefill chunk): {replays} replays, {len(captured)} first captures {captured}, 0 eager "
        f"after a capture; keys first captured inside the timed window: {run['new_keys']}")
    if len(keyed) != len(verify):
        raise AssertionError(f"service {label}: {len(verify) - len(keyed)} verify steps ran "
                             "without a graph")
    # Each key's replays but its first (CUDA events; the device time of the
    # replay alone, its inputs' copies enqueued before it).
    times = {key: sorted(a.elapsed_time(b) for a, b in events[1:])
             for key, events in replay_events.items() if len(events) > 1}
    for key in sorted((k for k in times if isinstance(k, VerifyKey)), key=lambda k: -len(times[k])):
        v = times[key]
        d = sorted(t for k, ts in times.items() if isinstance(k, DecodeKey) and k.S == key.S
                   for t in ts)
        beside = (f"pure-decode replays at S = {key[1]}: p50 {d[len(d) // 2]:.3f} ms over "
                  f"{len(d)}" if d else f"no pure-decode replay at S = {key[1]}")
        log(f"service {label}: verify key {key}: replay p50 {v[len(v) // 2]:.3f} ms over "
            f"{len(v)} (CUDA events); {beside}")


def step_twice(label, worker, metas, what):
    """Step ``metas`` twice on the same inputs: the key's first step (eager,
    then captured) and a replay must give the same tokens, logprobs,
    alternatives and accepted drafts. Returns (the key, what its capture
    took of the graphs' memory)."""
    from atoma_infer_tpu_torch.sequence import ExecuteModelRequest

    graphs = worker.graphs
    before, replays = set(graphs.graphs), graphs.replays
    took = dict(graphs.captured_bytes)
    request = ExecuteModelRequest(sequence_groups_metadata=metas)
    first = worker.execute_model(request)
    second = worker.execute_model(request)
    took = {k: graphs.captured_bytes[k] - took[k] for k in took}
    new = set(graphs.graphs) - before
    if len(new) != 1 or graphs.replays != replays + 1:
        raise AssertionError(f"service {label}: the {what} key {sorted(new)} was not captured "
                             "once and replayed")

    def flat(out):
        return [(o.output_token, o.logprob, o.top_tokens, o.extra_tokens)
                for g in sorted(out) for o in out[g].outputs.values()]

    (key,) = new
    if flat(first) != flat(second):
        raise AssertionError(f"service {label}: the {what} key {key}'s replay differs from its "
                             "eager step")
    return key, took


def widest_metas(config, rows, name, *, chunk=0, penalties=False, greedy=False, pages=None):
    """``rows`` sequences named ``name`` (the worker reuses a request's
    sampling tensors while its batch holds the same requests, whose
    parameters are fixed at admission: each set of options is a request of
    its own) as the widest keys take them, over contexts as
    long as the KV pool holds for all of them (``pages`` each, at most
    ``max_model_len`` − 1 tokens): decode rows, each seeded and sampling
    with top-k, top-p and typical-p (with ``penalties`` repetition and
    frequency too) and asking the most top-n alternatives; ``greedy`` rows
    only the alternatives (which no request of the traffic asks: each key
    is new when it is stepped twice). With ``chunk``, the first row is a
    prompt's last chunk of ``chunk`` tokens instead."""
    from atoma_infer_tpu_torch.sampling_params import (
        NextTokenChooserParameters, StoppingCriteriaParameters,
    )
    from atoma_infer_tpu_torch.sequence import SequenceData, SequenceGroupMetadata

    bs = config.cache.block_size
    pages = pages or min(config.cache.num_device_blocks // rows,
                         -(-(config.scheduler.max_model_len - 1) // bs))
    context = pages * bs
    options = {} if greedy else dict(temperature=0.8, top_k=50, top_p=0.9, typical_p=0.95,
                                     do_sample=True)
    if penalties:
        options.update(PENALTY_OPTIONS)
    metas = []
    for i in range(rows):
        prompt = i == 0 and chunk
        data = SequenceData([(7 * i + j) % 1000 + 3 for j in range(context)])
        data.update_num_computed_tokens(context - (chunk if prompt else 1))
        metas.append(SequenceGroupMetadata(
            request_id=f"{name}-{i}", is_prompt=bool(prompt), seq_data={i: data},
            next_token_chooser_params=NextTokenChooserParameters(
                **options, **({} if greedy else dict(seed=11 + i))),
            block_tables={i: list(range(i * pages, (i + 1) * pages))},
            stopping_criteria=StoppingCriteriaParameters(), do_sample=True,
            token_chunk_size=chunk if prompt else 1,
            top_n_tokens=config.validation.max_top_n_tokens,
        ))
    return metas, context


def check_widest_graph(label, worker, config, model_config):
    """The widest graph keys a user can reach, which the traffic does not,
    each stepped twice on the same inputs (``step_twice``), its capture
    counted in the graphs' memory:
    - the widest pure-decode key: ``max_num_sequences`` decode rows, each
      seeded and sampling with every option (top-k, top-p, typical-p) and
      asking the most top-n alternatives;
    - the widest mixed key: a prompt chunk filling the token budget beside
      the other rows, every row with every option and penalties too; the
      pool measured after it against the pool the reserve counts;
    - a prefill step: one greedy chunk of the whole budget over the longest
      context, alone, asking the most top-n alternatives;
    - with speculative decoding, the widest verify key."""
    from atoma_infer_tpu_torch.engine.llm_service import graph_pool_bytes

    rows = config.scheduler.max_num_sequences
    budget = config.scheduler.max_num_batched_tokens
    metas, context = widest_metas(config, rows, "wide")
    key, took = step_twice(label, worker, metas, "widest")
    log(f"service {label}: widest key {key} ({rows} sampled rows of {context} tokens, top-n "
        f"{config.validation.max_top_n_tokens}): replay identical to the eager step; its "
        f"capture grew the pool by {took['pool'] / 2**20:.2f} MiB, the driver took "
        f"{took['driver'] / 2**20:.2f} MiB")
    chunk = min(budget - (rows - 1), context)
    mixed, _ = widest_metas(config, rows, "wide-mixed", chunk=chunk, penalties=True)
    key, took = step_twice(label, worker, mixed, "widest mixed")
    pool = worker.graphs.captured_bytes["pool"]
    reserve = graph_pool_bytes(model_config, config.scheduler, config.cache.block_size,
                               quantized=config.model.quantization is not None)
    log(f"service {label}: widest mixed key {key} (a {chunk}-token chunk and {rows - 1} decode "
        f"rows of {context} tokens, every row sampled with penalties, top-n "
        f"{config.validation.max_top_n_tokens}): replay identical to the eager step; its "
        f"capture grew the pool by {took['pool'] / 2**20:.2f} MiB; the pool "
        f"{pool / 2**20:.2f} MiB against the "
        f"reserve's {reserve / 2**20:.2f} MiB")
    if pool > reserve:
        raise AssertionError(f"service {label}: the graphs' pool {pool} bytes is over the "
                             f"{reserve} the reserve counts")
    pages = min(config.cache.num_device_blocks,
                -(-(config.scheduler.max_model_len - 1) // config.cache.block_size))
    prefill, long_context = widest_metas(config, 1, "wide-prefill", chunk=budget, greedy=True,
                                         pages=pages)
    key, took = step_twice(label, worker, prefill, "prefill")
    log(f"service {label}: prefill key {key} (one {budget}-token chunk ending at token "
        f"{long_context}): replay identical to the eager step; its capture grew the pool by "
        f"{took['pool'] / 2**20:.2f} MiB")
    K = config.scheduler.num_speculative_tokens
    if not K:
        return
    # The widest verify key: every row drafted K tokens (greedy, as drafted
    # sequences are), T = S·(1+K), over contexts that leave room for the
    # drafts' slots.
    from atoma_infer_tpu_torch.sampling_params import NextTokenChooserParameters
    from atoma_infer_tpu_torch.sequence import SequenceData

    for i, meta in enumerate(metas):
        data = SequenceData([(7 * i + j) % 1000 + 3 for j in range(context - K)])
        data.update_num_computed_tokens(context - K - 1)
        meta.seq_data = {i: data}
        meta.next_token_chooser_params = NextTokenChooserParameters()
        meta.top_n_tokens = 0
        meta.spec_token_ids = [(5 * i + j) % 1000 + 3 for j in range(K)]
    key, took = step_twice(label, worker, metas, "widest verify")
    log(f"service {label}: widest verify key {key} ({rows} rows of {K} drafts): replay "
        f"identical to the eager step; its capture grew the pool by "
        f"{took['pool'] / 2**20:.2f} MiB, the driver took {took['driver'] / 2**20:.2f} MiB")


def report_graph_memory(label, graphs, config, model_config):
    """Print what the service's graphs hold on the card beside the reserve
    the KV pool left them (``graph_reserve_bytes``): the static inputs, one
    set for every key; the pool's growth over all captures; what stays
    allocated in it (the graphs' outputs) and what the driver took for the
    instantiated graphs, each per graph."""
    from atoma_infer_tpu_torch.engine.cuda_graphs import MAX_GRAPHS
    from atoma_infer_tpu_torch.engine.llm_service import graph_reserve_bytes

    n = graphs.evictions + len(graphs.graphs)  # captures
    took = graphs.captured_bytes
    total = graphs.static_bytes + took["pool"] + took["held"] + took["driver"]
    reserve = graph_reserve_bytes(model_config, config.scheduler, config.cache.block_size,
                                  quantized=config.model.quantization is not None)
    log(f"service {label}: graph memory: static inputs {graphs.static_bytes / 2**20:.2f} MiB "
        f"(one set), pool growth {took['pool'] / 2**20:.2f} MiB over {n} captures, held in it "
        f"{took['held'] / 2**10:.1f} KiB ({took['held'] / max(n, 1) / 2**10:.1f} KiB a graph), "
        f"driver {took['driver'] / 2**20:.2f} MiB ({took['driver'] / max(n, 1) / 2**20:.3f} "
        f"MiB a graph, {took['driver'] / max(n, 1) / model_config.num_layers / 2**10:.1f} KiB "
        f"a graph and layer); {total / 2**20:.2f} MiB in all against a reserve of "
        f"{reserve / 2**20:.2f} MiB for {MAX_GRAPHS} graphs; {graphs.evictions} evicted")
    if total > reserve:
        raise AssertionError(f"service {label}: the graphs hold {total} bytes, more than the "
                             f"{reserve} the KV pool left them")


def report_profiled_steps(torch, label, profiled, ragged, ragged_calls):
    """Print the eager run's profiled pure-decode and mixed steps, and the
    mixed step's ragged calls replayed through both ragged kernels."""
    decode_prof = profiled.get("decode", {})
    if decode_prof.get("kernels"):
        top = ", ".join(f"{name[:48]} {t:.3f}" for name, t in decode_prof["kernels"][:6])
        # The quantized linears' share: kernels F, G, H and their K-split
        # sums; the fused decode attention's: its kernel and the merge of
        # split rows (a pure-decode step runs no ragged kernel).
        qmm = sum(t for name, t in decode_prof["kernels"]
                  if "qmm_" in name or "split_reduce" in name)
        h_ms = sum(t for name, t in decode_prof["kernels"] if "qmm_w8a8" in name)
        fused = sum(t for name, t in decode_prof["kernels"]
                    if "fused_" in name or "rpa_combine" in name)
        log(f"service {label}: profiled pure-decode step ({decode_prof['seqs']} seqs): device "
            f"busy {decode_prof['busy_ms']:.3f} ms of {decode_prof['wall_ms']:.2f} ms wall under "
            f"the profiler, quantized matmuls {qmm:.3f} ms (H {h_ms:.3f}), fused decode "
            f"attention {fused:.3f} ms; top device time (ms): {top}")
    else:
        log(f"service {label}: device time of a decode step not measured (the profiler "
            "recorded no device events)")
    mixed_prof = profiled.get("mixed", {})
    if mixed_prof.get("kernels"):
        top = ", ".join(f"{name[:48]} {t:.3f}" for name, t in mixed_prof["kernels"][:6])
        # The ragged attention's share: the tensor-core kernel and its split
        # merge; kernel H's (W8A8).
        ragged_ms = sum(t for name, t in mixed_prof["kernels"] if "rpa_" in name)
        h_ms = sum(t for name, t in mixed_prof["kernels"] if "qmm_w8a8" in name)
        log(f"service {label}: profiled mixed step ({mixed_prof['prefills']} prefill + "
            f"{mixed_prof['seqs']} decode groups): device busy {mixed_prof['busy_ms']:.3f} ms of "
            f"{mixed_prof['wall_ms']:.2f} ms wall under the profiler, ragged attention "
            f"{ragged_ms:.3f} ms ({ragged_ms / max(mixed_prof['busy_ms'], 1e-9):.1%} of busy), "
            f"H {h_ms:.3f} ms; top device time (ms): {top}")
        # The same calls again, each through the route and through the
        # CUDA-core kernel by a direct launch (device time in CUDA graphs,
        # summed), where its bf16 form has the head dim (not Phi-3's or
        # Gemma-2's) and the queries' dtype (not fp16).
        new_ms = sum(graph_ms(torch, lambda c=c: ragged(c[0], c[1], c[2], **c[3]))
                     for c in ragged_calls)
        old = "no CUDA-core kernel at this head dim"
        if all(c[0].shape[2] in CUDA_CORE_BF16_DIMS and c[0].dtype == torch.bfloat16
               for c in ragged_calls):
            old_ms = sum(graph_ms(torch, lambda c=c: cuda_core_attention(
                c[0], c[1], c[2], scale=c[3]["scale"], kv_scales=c[3].get("kv_scales")))
                for c in ragged_calls)
            old = f"CUDA-core rpa_kernel on the same inputs {old_ms:.3f} ms"
        log(f"service {label}: the profiled mixed step's {len(ragged_calls)} ragged calls "
            f"replayed in CUDA graphs: tensor cores {new_ms:.3f} ms, {old}")
    else:
        log(f"service {label}: device time of a mixed step not measured (the profiler "
            "recorded no device events)")


def serve_both(torch, label, model, params, make_config, path, mode,
               new_tokens=OTHER_SERVICES_TOKENS, **kw):
    """One service (a) synchronous and eager, then (b) in ``mode`` (graphs
    replayed, synchronous or async after warmup) on the same 8 requests:
    greedy and seeded tokens identical. ``make_config(async_scheduling)``
    makes each run's configuration. Returns (b)'s launch counts, the
    service's own path's."""
    stats_a, stats_b = {}, {}
    counts_a, tokens_a = serve(torch, label, model, params, make_config(False), path,
                               new_tokens=new_tokens, stats=stats_a, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    counts_b, tokens_b = serve(torch, label, model, params,
                               make_config(mode == "async+graphs"), path, mode=mode,
                               new_tokens=new_tokens, stats=stats_b, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(tokens_a, tokens_b)):
        if a != b:
            raise AssertionError(f"service {label}: request {i} tokens differ between the "
                                 f"eager and the {mode} runs: {a} against {b}")
    log(f"service {label}: tokens identical in the eager and {mode} runs "
        f"({len(tokens_a)} requests, request 3 seeded sampling); launches eager → {mode}: "
        + ", ".join(f"{k} {counts_a[k]} → {counts_b[k]}" for k in path))
    log(f"service {label}: eager → {mode}: " + compare_stats(stats_a, stats_b))
    return counts_b


def compare_stats(a, b):
    """One line of two runs' figures: the steps with a prefill chunk
    (dispatch to the next dispatch, p50 / p99 ms; with graphs, replays and
    first captures apart), the steady-decode period p50 / p99 ms, the
    warmup's seconds."""
    def walls(st):
        parts = []
        for part, ms in sorted(st.get("mixed", {}).items()):
            name = "first captures " if part == "capture" else ""
            parts.append(f"{name}{percentile(ms, 0.5):.3f} / {percentile(ms, 0.99):.3f} "
                         f"({len(ms)})")
        return ", ".join(parts) or "none"

    def period(st):
        p = st.get("period") or {}
        return f"{p['p50']:.3f} / {p['p99']:.3f}" if p else "not measured"

    warm = b.get("warmup_s")
    return (f"steps with a prefill chunk {walls(a)} → {walls(b)} ms; period {period(a)} → "
            f"{period(b)} ms; warmup "
            + (f"{warm:.2f} s" if warm is not None else "none (synchronous, no warmup)"))


def bf16_config(name, block_size, async_scheduling=False, max_model_len=2048,
                max_num_sequences=64, num_speculative_tokens=0, dtype="bfloat16",
                kv_cache_dtype=None):
    """A bf16 (or ``dtype``) service's configuration over a KV cache of
    ``kv_cache_dtype`` (None: the model's dtype): KV pool sized from
    ``torch.cuda.mem_get_info``, chunked prefill with a 256-token budget
    (prompts arriving while others decode share steps with them, so mixed
    prefill+decode steps run), prompts of up to ``max_model_len`` − 1,024
    tokens, n-gram drafts of up to ``num_speculative_tokens``."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )

    return EngineConfig(
        model=ModelConfig(model_name=name, dtype=dtype, kv_cache_dtype=kv_cache_dtype),
        cache=CacheConfig(block_size=block_size, hbm_memory_utilization=0.5,
                          num_host_blocks_override=64),
        scheduler=SchedulerConfig(
            max_num_batched_tokens=256, max_num_sequences=max_num_sequences,
            max_model_len=max_model_len, enable_chunked_prefill=True,
            async_scheduling=async_scheduling, num_speculative_tokens=num_speculative_tokens,
            spec_ngram_min=1,
        ),
        validation=ValidationConfig(max_input_tokens=max_model_len - 1024,
                                    max_total_tokens=max_model_len),
    )


def llama_1b_model(torch, dtype=None):
    """Llama-3.2-1B at full width, 16 layers, random bf16 (or ``dtype``)
    weights."""
    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_hidden_layers=16,
        num_attention_heads=HQ, num_key_value_heads=HK, head_dim=D,
        max_position_embeddings=4096, tie_word_embeddings=True,
    )
    model = Llama(cfg, dtype=dtype or torch.bfloat16, device="cuda")
    return model, model.init_params(torch.Generator(device=model.device).manual_seed(0))


def span_cost_us(n: int = 20000) -> float:
    """Host µs one enabled span of ``utils/tracing`` costs (the services
    record about ten a step while their traffic runs)."""
    from atoma_infer_tpu_torch.utils import tracing

    tracing.enable()
    t0 = time.monotonic()
    for _ in range(n):
        with tracing.span("cost"):
            pass
    cost = (time.monotonic() - t0) * 1e6 / n
    tracing.disable()
    tracing.clear()
    return cost


def device_guard_cost_us(torch, n: int = 20000) -> float:
    """Host µs the device part of one launch costs: ``launch_device`` over
    ten tensors (an attention launch's count) and ``call_on_device`` around
    the call (a ``CudaKernel`` launch on the current device)."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    tensors = [torch.empty(1, device="cuda") for _ in range(10)]
    t0 = time.monotonic()
    for _ in range(n):
        cuda_lib.call_on_device(cuda_lib.launch_device(*tensors), int)
    return (time.monotonic() - t0) * 1e6 / n


def run_service(torch):
    """The bf16 Llama-3.2-1B service (16 layers), blocks of 16, one of its
    requests with penalties: eager, then async with graphs (whose launches
    it returns)."""
    log(f"tracing: an enabled span costs {span_cost_us():.2f} µs on this host")
    model, params = llama_1b_model(torch)
    return serve_both(torch, "1B bf16", model, params,
                      lambda a: bf16_config("llama-3.2-1b-random", BS, async_scheduling=a),
                      SERVICE_PATH, "async+graphs", NEW_TOKENS, penalty=True)


def run_http_server(torch):
    """The port's HTTP server, as ``python -m atoma_infer_tpu_torch.server``
    runs it: ``build_app(service, warmup=True)`` over the 1B bf16 service
    with async scheduling, listening on 127.0.0.1; one ``POST
    /v1/chat/completions`` plain and one with ``stream: true`` (SSE). Both
    bodies are checked (the streamed text must be the plain one's: same
    prompt, greedy, each request alone), and each request's time to first
    token and total are printed."""
    import socket

    import aiohttp
    from aiohttp import web

    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.server import metrics
    from atoma_infer_tpu_torch.server.app import build_app

    model, params = llama_1b_model(torch)
    config = bf16_config("llama-3.2-1b-random", BS, async_scheduling=True)
    service = LlmService.start(config, model=model, params=params,
                               tokenizer=ByteTokenizer(model.config.vocab_size),
                               device=model.device)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}/v1/chat/completions"
    max_tokens = 24
    body = {
        "model": config.model.model_name,
        "messages": [
            {"role": "system", "content": "You are a helpful assistant."},
            {"role": "user", "content": "Name three colours of the rainbow."},
        ],
        "max_tokens": max_tokens,
    }

    async def go():
        runner = web.AppRunner(build_app(service, warmup=True))
        t0 = time.monotonic()
        await runner.setup()  # starts the engine and runs the warmup
        startup_s = time.monotonic() - t0
        site = web.TCPSite(runner, "127.0.0.1", port)
        await site.start()
        try:
            async with aiohttp.ClientSession() as http:
                async with http.get(f"http://127.0.0.1:{port}/healthz") as resp:
                    if resp.status != 200:
                        raise AssertionError(f"server: /healthz answered {resp.status}")
                ttft_sum = metrics.TIME_TO_FIRST_TOKEN.sum
                t = time.monotonic()
                async with http.post(url, json=body) as resp:
                    plain = (resp.status, await resp.json())
                plain_s = time.monotonic() - t
                plain_ttft = metrics.TIME_TO_FIRST_TOKEN.sum - ttft_sum
                ttft_sum = metrics.TIME_TO_FIRST_TOKEN.sum
                t = time.monotonic()
                first = None
                lines = []
                async with http.post(url, json={**body, "stream": True}) as resp:
                    sse_status, sse_type = resp.status, resp.headers.get("Content-Type", "")
                    async for line in resp.content:
                        if first is None and line.startswith(b"data: "):
                            first = time.monotonic() - t
                        lines.append(line.decode())
                sse_s = time.monotonic() - t
                sse_ttft = metrics.TIME_TO_FIRST_TOKEN.sum - ttft_sum
        finally:
            await runner.cleanup()
        return startup_s, plain, plain_s, plain_ttft, (sse_status, sse_type, lines), sse_s, \
            first, sse_ttft

    startup_s, (status, data), plain_s, plain_ttft, sse, sse_s, sse_first, sse_ttft = \
        asyncio.run(go())
    if status != 200 or data.get("object") != "chat.completion":
        raise AssertionError(f"server: plain completion {status}: {data}")
    choice = data["choices"][0]
    used = data["usage"]["completion_tokens"]
    if not 1 <= used <= max_tokens or choice["finish_reason"] not in ("length", "stop"):
        raise AssertionError(f"server: plain completion {used} tokens, {choice['finish_reason']}")
    if choice["finish_reason"] == "length" and used != max_tokens:
        raise AssertionError(f"server: capped at length after {used} of {max_tokens} tokens")
    sse_status, sse_type, lines = sse
    events = [line[len("data: "):].strip() for line in lines if line.startswith("data: ")]
    if sse_status != 200 or not sse_type.startswith("text/event-stream") or not events \
            or events[-1] != "[DONE]":
        raise AssertionError(f"server: stream {sse_status} {sse_type}, events {events[-3:]}")
    chunks = [json.loads(e) for e in events[:-1]]
    if not chunks or any(c["object"] != "chat.completion.chunk" for c in chunks):
        raise AssertionError("server: the stream carried no completion chunks")
    streamed = "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks)
    if streamed != choice["message"]["content"]:
        raise AssertionError("server: the streamed text differs from the plain completion's")
    if chunks[-1]["choices"][0]["finish_reason"] != choice["finish_reason"]:
        raise AssertionError("server: the stream's finish reason differs")
    graphs = service.engine.worker.graphs
    log(f"server: build_app(warmup=True) started in {startup_s:.2f} s ({len(graphs.graphs)} "
        f"graphs after the warmup and the two requests, {graphs.replays} replays); plain "
        f"POST {used} tokens: total {plain_s * 1e3:.1f} ms, time to first token "
        f"{plain_ttft * 1e3:.1f} ms (server); SSE POST {len(chunks)} chunks: total "
        f"{sse_s * 1e3:.1f} ms, first event {sse_first * 1e3:.1f} ms (client), time to "
        f"first token {sse_ttft * 1e3:.1f} ms (server); text identical")


def run_shape_services(torch):
    """Services at the shapes the kernels first refused: the bf16
    Llama-3.2-3B at full width (28 layers, 3 query heads per kv head,
    blocks of 16 as ``BASELINE.json`` config #2 says), whose decode steps
    must go through the fused kernel at G = 3, then the 16-layer
    Llama-3.2-1B with blocks of 64 (the ragged kernel in key tiles)."""
    from atoma_infer_tpu_torch.models.llama import Llama

    model = Llama(llama_3b_config(28), dtype=torch.bfloat16, device="cuda")
    params = model.init_params(torch.Generator(device=model.device).manual_seed(3))
    serve_both(torch, "3B bf16", model, params,
               lambda a: bf16_config("llama-3.2-3b-random", BS, async_scheduling=a),
               SERVICE_PATH, "graphs")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    model, params = llama_1b_model(torch)
    serve_both(torch, "1B bf16 block 64", model, params,
               lambda a: bf16_config("llama-3.2-1b-random", 64, async_scheduling=a),
               SERVICE_PATH, "graphs")


# Phi-3-mini's services: one prompt past its 2,047-key window, so that the
# window trims keys in prefill chunks and in decode (the model's 4,096
# positions hold it and 128 new tokens).
PHI3_PROMPT_LENGTHS = (16, 2100, 45, 120, 200, 77, 250, 33)


# The families over 1-byte KV caches (bf16 weights and queries), at the
# family service's depth, on its weights. (family, cache, layers).
WIDE_KV8_SERVICES = (
    ("Phi-3-mini-4k-instruct", "int8", 4),
    ("Gemma-2-9B", "fp8", 4),
    ("Phi-3-mini-4k-instruct", "fp8", 4),
    ("Gemma-2-9B", "int8", 4),
)
WIDE_KV8_TOKENS = 64


def wide_kv8_path(name, kv):
    """A wide family's path over a 1-byte cache: the write, the ``*_wide``
    tensor-core ragged and split fused kernels, and (not Phi-3-mini, whose
    plans never split) the merge."""
    path = (f"reshape_and_cache_{kv}", f"ragged_paged_attention_{kv}_mma_wide",
            f"fused_decode_attention_{kv}_split_wide")
    return path if name.startswith("Phi-3") else path + ("paged_attention_split_combine",)


def family_config(name, kv=None, dtype="bfloat16"):
    """A family service's configuration maker (``make_config(async)``) over
    a KV cache of ``kv``: Phi-3-mini's 4,096 positions, the others' 2,048."""
    max_len = 4096 if name.startswith("Phi-3") else 2048
    return lambda a: bf16_config(f"{name.lower()}-random", BS, async_scheduling=a,
                                 max_model_len=max_len, dtype=dtype, kv_cache_dtype=kv)


def serve_wide_kv8(torch, name, kv, model, params, layers):
    """One family over a 1-byte cache (``WIDE_KV8_SERVICES``): eager, then
    synchronous with graphs, tokens identical; every attention launch of the
    graphs' run a D or E ``*_wide`` kernel's (no CUDA-core, narrow or plain
    route). Returns its path's launches keyed ``kernel@D``."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    d = model.config.head_dim
    label = f"{name} {kv.upper()} KV ({layers} of {FAMILIES[name][0]['num_hidden_layers']} layers)"
    path = wide_kv8_path(name, kv)
    lengths = PHI3_PROMPT_LENGTHS if name.startswith("Phi-3") else PROMPT_LENGTHS
    counts = serve_both(torch, label, model, params, family_config(name, kv), path, "graphs",
                        WIDE_KV8_TOKENS, prompt_lengths=lengths)
    off = {k: n for k, n in counts.items() if n and k not in path and k in cuda_lib.KERNELS
           and k.startswith(("ragged_paged_attention", "fused_decode_attention", "reshape_and"))}
    if off:
        raise AssertionError(f"service {label}: attention launches off its D={d} path: {off}")
    return {f"{k}@{d}": counts[k] for k in path if k != "paged_attention_split_combine"}


def run_family_services(torch):
    """One service per family at its published widths (``FAMILIES``; 4
    layers each), bf16 with random
    weights from a seed: eager, then synchronous with its decode graphs,
    tokens identical, every attention kernel of the path launched, the
    graphs' memory held to the KV pool's reserve. Then Phi-3-mini and
    Gemma-2-9B over 1-byte caches (``WIDE_KV8_SERVICES``, those at the
    family service's depth on the same weights). Returns the D = 96 and 256 services' launch
    counts, keyed ``kernel@D``."""
    launches = {}
    for name, (spec, layers) in FAMILIES.items():
        model, params = family_model(torch, name, layers)
        lengths = PHI3_PROMPT_LENGTHS if name.startswith("Phi-3") else PROMPT_LENGTHS
        log(f"service {name}: {layers} of {spec['num_hidden_layers']} layers, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB of weights")
        # Phi-3-mini's 32 kv heads fill the card unsplit: no merge on its
        # path (WIDE_HEAD_SHAPES).
        path = ATTENTION_PATH if name.startswith("Phi-3") else SERVICE_PATH
        counts = serve_both(torch, name, model, params, family_config(name), path, "graphs",
                            prompt_lengths=lengths)
        d = model.config.head_dim
        if d in WIDE_HEAD_DIMS:
            launches.update({f"{k}@{d}": counts[k] for k in SERVICE_PATH})
        for kv_name, kv, kv_layers in WIDE_KV8_SERVICES:
            if kv_name == name and kv_layers == layers:
                launches.update(serve_wide_kv8(torch, name, kv, model, params, layers))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    for name, kv, layers in WIDE_KV8_SERVICES:
        if layers == FAMILIES[name][1]:
            continue
        model, params = family_model(torch, name, layers)
        launches.update(serve_wide_kv8(torch, name, kv, model, params, layers))
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


GROUP_TOKENS = 64


def group_path(kv):
    """The fused kernel, the ragged kernel and the write of a bf16 service
    over a cache of ``kv`` (None: bf16)."""
    s = f"_{kv}" if kv else ""
    return (f"fused_decode_attention{s}_split", f"ragged_paged_attention{s}_mma",
            f"reshape_and_cache{s}")


def check_step_routes(label, figures, layers, kv, route="fused", path=None):
    """The attention kernels of a ``drive`` run by step. ``route``
    "fused": every pure-decode step launched the split fused kernel once a
    layer, and only the steps with a prefill chunk launched the ragged
    kernel (once a layer): no decode step took the ragged route. "ragged"
    (past 16 q heads per kv head): every step, pure-decode ones included,
    launched the write and then the ragged kernel once a layer, and no step
    the fused kernel. ``path``: the (fused, ragged, write) kernels, by
    default :func:`group_path`'s."""
    fused, ragged, write = path or group_path(kv)
    decode = sum(1 for _, pure, rows in figures["dispatches"] if pure and rows)
    other = sum(1 for _, pure, rows in figures["dispatches"] if not pure and rows)
    got = figures["launches"]
    if route == "fused":
        ok = decode and got[fused] == decode * layers and got[ragged] == other * layers
    else:
        steps = (decode + other) * layers
        ok = decode and got[fused] == 0 and got[ragged] == steps and got[write] == steps
    if not ok:
        raise AssertionError(f"service {label}: {decode} pure-decode steps and {other} with a "
                             f"prefill chunk over {layers} layers on the {route} route, but "
                             f"{got[fused]} {fused}, {got[ragged]} {ragged} and {got[write]} "
                             f"{write} launches")
    if route == "fused":
        log(f"service {label}: {decode} pure-decode steps launched {fused} {got[fused]} times "
            f"({layers} a step), {other} steps with a prefill chunk {ragged} {got[ragged]} "
            "times: no decode step on the ragged route")
    else:
        log(f"service {label}: {decode} pure-decode steps and {other} with a prefill chunk "
            f"launched {write} {got[write]} and {ragged} {got[ragged]} times ({layers} a step "
            f"each), {fused} {got[fused]} times; the merge of split rows "
            f"{got['paged_attention_split_combine']} times")


def group_family_model(torch, name, layers, quantization):
    """The family's model (``GROUP_FAMILIES``) and its weights drawn on the
    card, each projection stack and the LM head quantized to
    ``quantization`` (or left bf16) as soon as drawn: at Llama-3.1-405B's
    widths the dense and the quantized copies of every stack do not fit on
    the card beside each other."""
    from atoma_infer_tpu_torch.models.weights import quantize_params

    model, params = family_model(torch, name, layers)
    if quantization:
        for key in [k for k in params["layers"] if k.endswith("_proj")]:
            one = {"layers": {key: params["layers"].pop(key)}}
            params["layers"][key] = quantize_params(one, quantization)["layers"][key]
            del one
            torch.cuda.empty_cache()
        if "lm_head" in params:
            one = {"layers": {}, "lm_head": params.pop("lm_head")}
            params["lm_head"] = quantize_params(one, quantization)["lm_head"]
            del one
            torch.cuda.empty_cache()
    return model, params


def run_group_services(torch):
    """Services at 9 to 16 q heads per kv head, and at 32, through
    ``LlmService.start`` (``GROUP_FAMILIES``, the 8 requests of
    ``PROMPT_LENGTHS`` at GROUP_TOKENS tokens, one seeded): each (a) eager
    with the plain attention on the card (the wrappers' CUDA entries
    swapped for their plain versions, ``plain_attention``; top 2 logprobs
    asked), (b) eager with the kernels, (c) synchronous with every step
    replaying its CUDA graph. (b) is held to (a) under the near-tie rule,
    (c) to (b) token for token; in (b) and (c) every pure-decode step
    launched the split fused kernel and no decode step the ragged one, or
    past 16 the write and the ragged kernel and never the fused one
    (``check_step_routes``); (c)'s graph memory is held to the reserve.
    Returns (c)'s launches of each service's kernels, keyed as
    ``check_group_kernels``' rows."""
    from atoma_infer_tpu_torch.ops.paged_attention import decode_route

    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer

    text = "The quick brown fox jumps over the lazy dog. " * (-(-max(PROMPT_LENGTHS) // 45))
    prompts = [text[:n] for n in PROMPT_LENGTHS]
    launches = {}
    for name, (spec, layers, quantization, kvs) in GROUP_FAMILIES.items():
        t0 = time.monotonic()
        model, params = group_family_model(torch, name, layers, quantization)
        torch.cuda.synchronize()
        cfg = model.config
        group = cfg.num_attention_heads // cfg.num_kv_heads
        route = decode_route(cfg.num_attention_heads, cfg.num_kv_heads)
        log(f"service {name}: {layers} of {spec['num_hidden_layers']} layers, "
            f"{quantization or 'bf16'} weights drawn on the card in "
            f"{time.monotonic() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
            f"allocated; {cfg.num_attention_heads} q heads over {cfg.num_kv_heads} kv heads (G="
            f"{group}), D={cfg.head_dim}")
        for kv in kvs:
            label = f"{name} {quantization or 'bf16'} + {kv or 'bf16'} KV (G={group})"
            runs = {}
            for mode in ("plain", "eager", "graphs"):
                t_run = time.monotonic()
                config = dataclass_replace(
                    bf16_config(f"{name.lower()}-random", BS, kv_cache_dtype=kv),
                    quantization=quantization)
                service = LlmService.start(config, model=model, params=params,
                                           tokenizer=ByteTokenizer(cfg.vocab_size),
                                           device=model.device)
                if mode != "graphs":
                    service.engine.worker.graphs = None
                if mode == "plain":
                    with plain_attention():
                        runs[mode] = drive(torch, f"{label} [plain attention]", service,
                                           prompts, GROUP_TOKENS, top_n=2)
                else:
                    runs[mode] = drive(torch, f"{label} [{mode}]", service, prompts,
                                       GROUP_TOKENS)
                    check_step_routes(f"{label} [{mode}]", runs[mode][2], layers, kv, route)
                    check_route(f"service {label} [{mode}]", runs[mode][2]["launches"],
                                bf16=True)
                if mode == "graphs":
                    report_graph_memory(f"{label} [graphs]", service.engine.worker.graphs,
                                        service.config, cfg)
                log(f"service {label} [{mode}]: KV pool {service.config.cache.num_device_blocks}"
                    f" blocks; {steady_decode(runs[mode][2])}; start and traffic "
                    f"{time.monotonic() - t_run:.1f} s [{card_line()}]")
                del service
                gc.collect()
                torch.cuda.empty_cache()
            want, top, _ = runs["plain"]
            compare_to_reference(
                label, runs["eager"][0], want, top,
                lambda j, a, b: seeded_score_gap(torch, model, params, prompts[SEEDED_REQUEST],
                                                 want[SEEDED_REQUEST], j, a, b, kv),
                reference="the same service with the plain attention")
            if runs["graphs"][0] != runs["eager"][0]:
                first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                         for a, b in zip(runs["graphs"][0], runs["eager"][0])]
                raise AssertionError(f"service {label}: tokens with graphs differ from eager; "
                                     f"first difference by request: {first}")
            log(f"service {label}: tokens identical eager and with graphs "
                f"({sum(len(t) for t in runs['eager'][0])} tokens, the seeded request's too)")
            shape = next(s for s in GROUP_ATTENTION_SHAPES if s.endswith(f"G={group}"))
            for kernel in group_path(kv):
                launches[f"{kernel}@group {shape}"] = runs["graphs"][2]["launches"][kernel]
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def head_dim_path(d, kv):
    """The fused kernel, the ragged kernel and the write of a bf16 service
    at head dim ``d`` over a cache of ``kv`` (None: bf16): the ``*_wide``
    instantiations where a 1-byte cache's width is 96 or 256."""
    import torch

    from atoma_infer_tpu_torch.ops import paged_attention as pa

    q = torch.empty((1, 1, d), dtype=torch.bfloat16)
    kind = _KINDS[kv] and getattr(torch, _KINDS[kv])
    return (pa.fused_route(q, kind).name, pa.ragged_route(q, kind).name,
            f"reshape_and_cache{'_' + kv if kv else ''}")


class recording_plans:
    """While open: every tensor-core ragged call's plan
    (``rpa_plan_for``), recorded in ``plans``."""

    def __enter__(self):
        from atoma_infer_tpu_torch.ops import paged_attention as pa

        self.saved, self.plans = pa.rpa_plan_for, []

        def planned(*args, **kw):
            plan = self.saved(*args, **kw)
            self.plans.append(plan)
            return plan

        pa.rpa_plan_for = planned
        return self

    def __exit__(self, *exc):
        from atoma_infer_tpu_torch.ops import paged_attention as pa

        pa.rpa_plan_for = self.saved


def run_head_dim_services(torch):
    """The services of ``HEAD_DIM_FAMILIES`` through ``LlmService.start``
    (4 layers each, bf16, the 8 requests of ``PROMPT_LENGTHS`` at
    GROUP_TOKENS tokens, one seeded), over each of their caches: (a) eager
    with the plain attention on the card (top 2 logprobs asked), (b) eager
    with the kernels, (c) synchronous with every step replaying its CUDA
    graph. (b) is held to (a) under the near-tie rule, (c) to (b) token for
    token; every pure-decode step launched the fused kernel of its head
    dim's width (or, at G = 256, the write and the ragged kernel, every
    ragged call of (b) and of (c)'s captures planned in two slices a
    token); (c)'s graph memory is held to the reserve. Returns (c)'s
    launches of each service's kernels, keyed as ``check_head_dim_kernels``'
    rows (the G = 256 service's ``kernel@G=256``)."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    text = "The quick brown fox jumps over the lazy dog. " * (-(-max(PROMPT_LENGTHS) // 45))
    prompts = [text[:n] for n in PROMPT_LENGTHS]
    launches = {}
    for name, (spec, layers, kvs) in HEAD_DIM_FAMILIES.items():
        t0 = time.monotonic()
        model, params = family_model(torch, name, layers)
        cfg = model.config
        d, group = cfg.head_dim, cfg.num_attention_heads // cfg.num_kv_heads
        route = pa.decode_route(cfg.num_attention_heads, cfg.num_kv_heads)
        log(f"service {name}: {layers} of {spec['num_hidden_layers']} layers, bf16 weights "
            f"drawn on the card in {time.monotonic() - t0:.1f} s; {cfg.num_attention_heads} q "
            f"heads over {cfg.num_kv_heads} kv heads (G={group}), D={d}")
        for kv in kvs:
            label = f"{name} bf16 + {kv or 'bf16'} KV (D={d}, G={group})"
            path = head_dim_path(d, kv)
            runs = {}
            for mode in ("plain", "eager", "graphs"):
                t_run = time.monotonic()
                max_len = min(2048, spec["max_position_embeddings"])
                service = LlmService.start(
                    bf16_config(f"{name.lower()}-random", BS, kv_cache_dtype=kv,
                                max_model_len=max_len),
                    model=model, params=params, tokenizer=ByteTokenizer(cfg.vocab_size),
                    device=model.device)
                if mode != "graphs":
                    service.engine.worker.graphs = None
                if mode == "plain":
                    with plain_attention():
                        runs[mode] = drive(torch, f"{label} [plain attention]", service,
                                           prompts, GROUP_TOKENS, top_n=2)
                else:
                    with recording_plans() as rec:
                        runs[mode] = drive(torch, f"{label} [{mode}]", service, prompts,
                                           GROUP_TOKENS)
                    check_step_routes(f"{label} [{mode}]", runs[mode][2], layers, kv, route,
                                      path=path)
                    check_route(f"service {label} [{mode}]", runs[mode][2]["launches"],
                                bf16=True)
                    if group > 128:
                        slices = sorted({p.slices for p in rec.plans})
                        if not rec.plans or slices != [2]:
                            raise AssertionError(f"service {label} [{mode}]: ragged plans' "
                                                 f"slices {slices} ({len(rec.plans)} plans)")
                        log(f"service {label} [{mode}]: {len(rec.plans)} ragged calls planned "
                            f"({'every eager step' if mode == 'eager' else 'the captures'}), "
                            f"every one in 2 slices a token; "
                            f"{runs[mode][2]['launches'][path[1]]} launches of {path[1]}")
                if mode == "graphs":
                    report_graph_memory(f"{label} [graphs]", service.engine.worker.graphs,
                                        service.config, cfg)
                log(f"service {label} [{mode}]: KV pool {service.config.cache.num_device_blocks}"
                    f" blocks; {steady_decode(runs[mode][2])}; start and traffic "
                    f"{time.monotonic() - t_run:.1f} s [{card_line()}]")
                del service
                gc.collect()
                torch.cuda.empty_cache()
            want, top, _ = runs["plain"]
            compare_to_reference(
                label, runs["eager"][0], want, top,
                lambda j, a, b: seeded_score_gap(torch, model, params, prompts[SEEDED_REQUEST],
                                                 want[SEEDED_REQUEST], j, a, b, kv),
                reference="the same service with the plain attention")
            if runs["graphs"][0] != runs["eager"][0]:
                first = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                         for a, b in zip(runs["graphs"][0], runs["eager"][0])]
                raise AssertionError(f"service {label}: tokens with graphs differ from eager; "
                                     f"first difference by request: {first}")
            log(f"service {label}: tokens identical eager and with graphs "
                f"({sum(len(t) for t in runs['eager'][0])} tokens, the seeded request's too)")
            key, got = f"hd {name}", runs["graphs"][2]["launches"]
            if d > W512:
                # Every attention launch of this service ran in column slices,
                # eager and replayed, as the wrappers counted them.
                cols = pa.column_slices(d)
                for mode in ("eager", "graphs"):
                    n, got_cols = runs[mode][2]["launches"], runs[mode][2]["columns"]
                    if cols < 2 or not all(n[k] and got_cols[k] == cols * n[k]
                                           for k in path[:2]):
                        raise AssertionError(
                            f"service {label} [{mode}]: launches {[n[k] for k in path[:2]]} "
                            f"in column slices {[got_cols[k] for k in path[:2]]}, {cols} "
                            "a launch asked")
                    log(f"service {label} [{mode}]: {n[path[0]]} launches of {path[0]} in "
                        f"{got_cols[path[0]]} column slices and {n[path[1]]} of {path[1]} in "
                        f"{got_cols[path[1]]}, {cols} a launch")
            for kernel in path + ("paged_attention_split_combine",):
                launches[f"{kernel}@{key}"] = got[kernel]
                if d > 256:  # the width 512's rows (check_wide_head_kernels)
                    wide = W512 if d <= W512 else PAST_512_LINE_DIM
                    launches[f"{kernel}@{wide}"] = launches.get(f"{kernel}@{wide}", 0) + got[
                        kernel]
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def run_quant_services(torch):
    """Llama-3.1-8B at full width and ``QUANT_MAIN_LAYERS`` of its 32
    layers with INT8 weights, then with INT8 weights over an INT8 KV cache
    and drafts; then at
    ``QUANT_HALF_LAYERS`` of its layers with INT4 weights, with INT8
    weights under W8A8, and with INT8 weights over an INT8 and an e4m3 KV
    cache: random bf16 weights from a seeded generator, quantized on the
    card with the port's quantize_weight (an untied per-channel INT8 LM
    head in all). Returns each quantized and 1-byte-KV kernel's launches
    from its own path's service, and with drafts its verify path's."""
    from atoma_infer_tpu_torch.ops import quant_kernels

    t0 = time.monotonic()
    model, params = llama_8b_layers(torch, torch.bfloat16, QUANT_MAIN_LAYERS)
    torch.cuda.synchronize()
    log(f"8B weights: drawn and quantized on the card in {time.monotonic() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    config = llama_8b_service_config
    launches = {}

    def serve_quantized(label, quantization, w8a8, kernel, *mode):
        # bf16 activations at these shapes take F and G's tensor-core
        # route. The LM head is INT8 per channel and weight-only in all.
        saved = quant_kernels._W8A8
        quant_kernels._W8A8 = w8a8
        try:
            counts = serve_both(
                torch, label, model, params[quantization],
                lambda a: config(quantization, async_scheduling=a),
                SERVICE_PATH + (kernel, "quantized_matmul_int8_mma"), *mode)
        finally:
            quant_kernels._W8A8 = saved
        launches[kernel] = counts[kernel]
        if w8a8:
            # Every H launch of the service on the int8 tensor cores: its
            # shapes all take them, so the CUDA-core H has no launch here.
            launches["quantized_matmul_w8a8"] = counts["quantized_matmul_w8a8"]
            if counts["quantized_matmul_w8a8"]:
                raise AssertionError(f"service {label}: {counts['quantized_matmul_w8a8']} H "
                                     "launches on the CUDA cores")
        gc.collect()
        torch.cuda.empty_cache()

    # Eager, then with graphs (whose launches count): async after warmup.
    serve_quantized(f"8B INT8 ({QUANT_MAIN_LAYERS} of 32 layers)", "int8", False,
                    "quantized_matmul_int8_mma", "async+graphs", NEW_TOKENS)
    launches.update(run_spec_service_8b(torch, model, params["int8"]))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # The services held only eager against graphs (synchronous), at a
    # quarter of the depth: each layer is the full one's, and the requests
    # reach the same contexts, pages and splits.
    model, params = llama_8b_layers(torch, torch.bfloat16, QUANT_HALF_LAYERS)
    depth = f"({QUANT_HALF_LAYERS} of 32 layers)"
    serve_quantized(f"8B INT4 {depth}", "int4", False, "quantized_matmul_int4_mma", "graphs")
    serve_quantized(f"8B INT8 W8A8 {depth}", "int8", True, "quantized_matmul_w8a8_mma",
                    "graphs")
    # INT8 weights over an INT8 KV cache (BASELINE config #3; the pool sized
    # from free memory, so the scales' bytes per block are exercised), then
    # over an e4m3 cache.
    for kv, cache in (("int8", dict(hbm_memory_utilization=0.5)),
                      ("fp8", dict(num_device_blocks_override=2048))):
        made = []

        def make(a, kv=kv, cache=cache):
            made.append(config("int8", kv, async_scheduling=a, **cache))
            return made[-1]

        label = f"8B INT8 + {kv.upper()} KV {depth}"
        path = kv8_path(kv) + ("quantized_matmul_int8_mma", "paged_attention_split_combine")
        counts = serve_both(torch, label, model, params["int8"], make, path, "graphs")
        cfg = made[-1]
        per_block = cfg.cache.block_bytes(
            model.config.num_layers, model.config.num_kv_heads, model.config.head_dim, 1,
            scale_pages=kv == "int8")
        log(f"service {label}: {cfg.cache.num_device_blocks} KV blocks × {per_block} bytes "
            f"= {cfg.cache.num_device_blocks * per_block / 2**30:.2f} GiB")
        launches.update({k: counts[k] for k in kv8_path(kv)})
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def llama_8b_service_config(quantization, kv_cache_dtype=None, async_scheduling=False,
                            max_seqs=64, spec=0, dtype="bfloat16", **cache):
    """A Llama-3.1-8B service's configuration: ``quantization`` on load,
    the KV cache's dtype, blocks of 16 (2,048 of them unless ``cache`` says
    otherwise), chunked prefill with a 256-token budget, ``max_seqs``
    sequences, ``spec`` drafts a sequence."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )

    cache = cache or dict(num_device_blocks_override=2048)
    return EngineConfig(
        model=ModelConfig(model_name="llama-3.1-8b-random", dtype=dtype,
                          quantization=quantization, kv_cache_dtype=kv_cache_dtype),
        cache=CacheConfig(block_size=BS, num_host_blocks_override=64, **cache),
        scheduler=SchedulerConfig(
            max_num_batched_tokens=256, max_num_sequences=max_seqs, max_model_len=2048,
            enable_chunked_prefill=True, async_scheduling=async_scheduling,
            num_speculative_tokens=spec, spec_ngram_min=1,
        ),
        validation=ValidationConfig(max_input_tokens=1024, max_total_tokens=2048),
    )


def run_spec_service_8b(torch, model, params):
    """Llama-3.1-8B with INT8 weights (``params``) over an INT8 KV cache
    (pool sized from free memory) with SPEC_K drafts, 8 sequences,
    synchronous with graphs: D and F on verify rows, against the same
    service without drafts. Returns its launches of the verify path, keyed
    ``kernel@verify``."""
    counts = serve_spec(
        torch, "8B INT8 + INT8 KV spec", model, params,
        lambda a, k: llama_8b_service_config("int8", "int8", async_scheduling=a, max_seqs=8,
                                             spec=k, hbm_memory_utilization=0.5),
        SPEC_PATH_8B, kv8_path("int8") + ("quantized_matmul_int8_mma",
                                          "paged_attention_split_combine"),
        ("graphs",), "graphs")
    return {f"{k}@verify": counts[k] for k in SPEC_PATH_8B}


# ------------------------------------------- phase 4: speculative decoding
# Drafts a drafted sequence carries (``scheduler.num_speculative_tokens``).
SPEC_K = 4
# The spec services' 8 prompts: each echoes its first half, so that the
# n-gram proposer finds drafts in it (code, then prose).
SPEC_SOURCE = ("def fib(n):\n    a, b = 0, 1\n    for _ in range(n):\n        a, b = b, a + b\n"
               "    return a\n\nThe quick brown fox jumps over the lazy dog. ")
SPEC_PROMPTS = tuple((SPEC_SOURCE * 4)[: n // 2] * 2 for n in PROMPT_LENGTHS)
# A verify step's logits against K+1 decode steps over the same tokens, bf16
# through 2 layers: max |Δ logit| over the largest logit, as
# FAMILY_MODEL_TOL (the ragged kernel and cuBLAS at S·(1+K) rows against the
# fused kernel and cuBLAS at S rows, each rounding to bf16 in its own order).
SPEC_VERIFY_TOL = 3e-2
# A bf16 spec service may give another token than the same service without
# drafts only where the latter's top two logprobs are closer than this
# (nats): there the two paths' logits, which differ by rounding, can rank
# them either way. After such a position the request is compared no further.
SPEC_TIE_TOL = 0.1
# The bf16 spec services' path: verify rows take the write and the ragged
# kernel, whose plan splits their 8 sequences' key tiles (the merge); their
# steps without drafts take the fused kernel.
SPEC_PATH = ("reshape_and_cache", "ragged_paged_attention_mma", "paged_attention_split_combine")
SPEC_PATH_8B = ("reshape_and_cache_int8", "ragged_paged_attention_int8_mma",
                "quantized_matmul_int8_mma", "paged_attention_split_combine")


def spec_step_logits(torch, model, params, caches, groups, tables, kv_scales=None):
    """One step of ``groups`` — (token ids, computed count, drafts or None,
    prefill) a sequence, on ``tables`` — through the port's input prep and
    ``model`` on the card (an INT8 cache's scales in ``kv_scales``): the
    logits [rows, V] f32 of each sequence's sampled rows (the verify rows of
    a verify step, the last row else)."""
    import numpy as np

    from atoma_infer_tpu_torch.engine.input_prep import prepare_model_input
    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata
    from atoma_infer_tpu_torch.sampling_params import (
        NextTokenChooserParameters, StoppingCriteriaParameters,
    )
    from atoma_infer_tpu_torch.sequence import SequenceData, SequenceGroupMetadata

    metas = []
    for i, (tokens, computed, drafts, prompt) in enumerate(groups):
        data = SequenceData(list(tokens))
        data.update_num_computed_tokens(computed)
        metas.append(SequenceGroupMetadata(
            request_id=f"verify-{i}", is_prompt=prompt, seq_data={i: data},
            block_tables={i: tables[i]}, next_token_chooser_params=NextTokenChooserParameters(),
            stopping_criteria=StoppingCriteriaParameters(), do_sample=True,
            token_chunk_size=len(tokens) - computed if prompt else 1, spec_token_ids=drafts))
    mi = prepare_model_input(metas, block_size=BS, max_pages_per_seq=64, num_spec_tokens=SPEC_K)

    def ints(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(model.device)

    meta = AttentionMetadata(
        slot_mapping=ints(mi.slot_mapping), block_tables=ints(mi.block_tables),
        seq_lens=ints(mi.seq_lens), query_start_loc=ints(mi.query_start_loc),
        num_seqs=ints([mi.num_seqs]), block_size=BS, decode_only=mi.decode_only,
        max_q_len=mi.max_q_len)
    n = len(groups)
    rows = mi.spec_rows[:n].ravel() if mi.spec_rows is not None else mi.selected_token_indices[:n]
    with torch.inference_mode():
        hidden = model.forward(params, ints(mi.token_ids), ints(mi.positions), caches, meta,
                               kv_scales=kv_scales)
        return model.compute_logits(params, hidden[ints(rows).long()]).float()


def check_verify_step(torch):
    """The verify step at the kernel level: the 1B model (bf16, random
    weights) at 2 layers, 8 sequences of 40-300 tokens prefilled, then one
    verify step of SPEC_K drafts a sequence (the write and the ragged kernel
    over 1+K rows each, T = S·(1+K)) against K+1 decode steps over the same
    tokens from the same cache (the fused kernel, one row each): logits at
    rows 0..K within SPEC_VERIFY_TOL of the largest. The same at the
    service's 16 layers is printed, not held to it."""
    import numpy as np

    from atoma_infer_tpu_torch.models.llama import Llama, LlamaConfig

    rng = np.random.default_rng(12)
    lengths = (40, 75, 110, 150, 190, 230, 270, 300)
    prompts = [rng.integers(3, 1000, size=n).tolist() for n in lengths]
    drafts = [rng.integers(3, 1000, size=SPEC_K).tolist() for _ in lengths]
    tables, used = [], 0
    for n in lengths:
        pages = -(-(n + 1 + SPEC_K) // BS)
        tables.append(list(range(used, used + pages)))
        used += pages
    for layers in (2, 16):
        cfg = LlamaConfig(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192,
            num_hidden_layers=layers, num_attention_heads=HQ, num_key_value_heads=HK,
            head_dim=D, max_position_embeddings=4096, tie_word_embeddings=True)
        model = Llama(cfg, dtype=torch.bfloat16, device="cuda")
        params = model.init_params(torch.Generator(device=model.device).manual_seed(0))
        caches = model.alloc_kv_cache(used, BS)
        first = spec_step_logits(torch, model, params, caches,
                                 [(p, 0, None, True) for p in prompts], tables).argmax(-1)
        seqs = [p + [int(t)] for p, t in zip(prompts, first.tolist())]
        saved = [c.clone() for c in caches]
        got = spec_step_logits(torch, model, params, caches,
                               [(s, len(s) - 1, d, False) for s, d in zip(seqs, drafts)],
                               tables).view(len(seqs), SPEC_K + 1, -1)
        for c, c0 in zip(caches, saved):
            c.copy_(c0)
        want = torch.stack([spec_step_logits(
            torch, model, params, caches,
            [(s + d[:j], len(s) - 1 + j, None, False) for s, d in zip(seqs, drafts)], tables)
            for j in range(SPEC_K + 1)], dim=1)
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"verify step ({layers} layers): logits {tuple(got.shape)}, "
                                 f"finite {bool(torch.isfinite(got).all())}")
        diff = (got - want).abs()
        err = diff.max().item() / want.abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"verify step, 1B bf16 at {layers} layers, 8 sequences × {SPEC_K} drafts: logits at "
            f"rows 0..{SPEC_K} against {SPEC_K + 1} decode steps: max |Δ logit| "
            f"{diff.max().item():.4f} ({err:.3e} of the largest; tol {SPEC_VERIFY_TOL} at 2 "
            f"layers), argmax agreement {agree:.1%}")
        if layers == 2 and err > SPEC_VERIFY_TOL:
            raise AssertionError(f"verify step: logits differ from the decode steps' by "
                                 f"{err:.3e} of their largest (tol {SPEC_VERIFY_TOL})")
        del model, params, caches, saved
        gc.collect()
        torch.cuda.empty_cache()


def check_verify_kernels(torch):
    """The kernels of a verify step on a 64-sequence verify batch (SPEC_K
    drafts each, 1+K query rows a sequence, keys 16-2,047, T = S·(1+K) =
    320), each against its plain version and timed beside its bound: the
    write C and the ragged kernel A at the 1B attention shapes (bf16 cache),
    the fused kernel B on the same sequences as one decode row each (a step
    without drafts), the INT8 write and D at the 8B shapes over an INT8
    cache, F at M = 320 (the 8B gate projection, INT8), and the merge after
    A on 8 sequences of 1,800-2,047 keys (the spec services' S). Returns
    the kernels line's verify rows, keyed ``kernel@verify``."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write
    from atoma_infer_tpu_torch.ops import paged_attention as pa
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    keys = rng.integers(16, 2048, size=64)
    specs = [(1 + SPEC_K, int(k)) for k in keys]
    T = 64 * (1 + SPEC_K)
    tol = ATTN_TOL["bfloat16"]
    rows = {}
    b = make_batch(rng, specs, dtype=torch.bfloat16, num_blocks=8192, decode_only=False,
                   device=dev, T=T)
    m, n = b["meta"], b["rows"]
    got, want = b["cache"].clone(), b["cache"].clone()
    kv_write.write_kv_cache_cuda(got, b["k"], b["v"], m.slot_mapping)
    kv_write.write_kv_cache_plain(want, b["k"], b["v"], m.slot_mapping)
    if not torch.equal(got, want):
        raise AssertionError("reshape_and_cache (verify rows) is not bit-exact")
    cache = got

    def write():
        kv_write.write_kv_cache_cuda(cache, b["k"], b["v"], m.slot_mapping)

    # The library call: index_copy_ of the rows, K and V side by side, into
    # the flattened slots (as phase 2 times C's).
    slots = m.slot_mapping.long()
    fused_rows = torch.stack([b["k"], b["v"]], 2).reshape(T, -1)
    flat = cache.view(-1, cache.shape[-1])
    rows["reshape_and_cache@verify"] = dict(
        max_abs_err=0.0, ms=graph_ms(torch, write),
        plain_ms=cuda_ms(lambda: kv_write.write_kv_cache_plain(
            cache, b["k"], b["v"], m.slot_mapping)),
        library_ms=graph_ms(torch, lambda: flat.index_copy_(0, slots, fused_rows)),
        bytes=n * 2 * (2 * HK * D * 2) + T * 4, flops=0)
    scale = D ** -0.5
    out = pa.ragged_paged_attention_cuda(b["q"], cache, m, scale=scale)
    ref = pa.ragged_paged_attention_paged_plain(b["q"], cache, m, scale=scale)
    err = (out[:n].float() - ref[:n].float()).abs().max().item()
    if not torch.allclose(out[:n].float(), ref[:n].float(), atol=tol, rtol=tol):
        raise AssertionError(f"ragged_paged_attention (verify rows) disagrees: {err:.3e}")
    plan = pa.rpa_plan_for(b["q"], m, HK, None)
    rows["ragged_paged_attention_mma@verify"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
            b["q"], cache, m, scale=scale)),
        plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
            b["q"], cache, m, scale=scale), iters=3, warmup=1),
        library_ms=None, **dict(zip(("bytes", "flops"), attention_work(specs, None, 2,
                                                                      fused=False))))
    # B on the same sequences, one decode row each (the step without drafts).
    d = make_batch(rng, [(1, int(k)) for k in keys], dtype=torch.bfloat16, num_blocks=8192,
                   decode_only=True, device=dev)
    b_ms = cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
        d["q"], d["cache"], d["k"], d["v"], d["meta"], scale=scale))
    b_bound, _ = bound(*attention_work([(1, int(k)) for k in keys], None, 2, fused=True),
                       "bfloat16")
    log(f"verify batch, 1B shapes (64 sequences × {1 + SPEC_K} rows, keys 16-2,047, plan "
        f"{plan.warps} warps, {plan.tokens} tokens a tile, {plan.splits} splits at most): "
        f"ragged (A) {rows['ragged_paged_attention_mma@verify']['ms']:.4f} ms, max |err| "
        f"{err:.3e}; the fused kernel (B) on the same sequences as decode rows {b_ms:.4f} ms "
        f"(bound {b_bound:.4f} ms), {1 + SPEC_K} such decode steps {(1 + SPEC_K) * b_ms:.4f} ms")
    del b, d, cache, got, want, out, ref
    # D: the INT8 write and the ragged kernel over an INT8 cache, 8B shapes.
    b = make_batch(rng, specs, hq=32, hk=8, d=128, bs=16, dtype=torch.bfloat16,
                   num_blocks=8192, decode_only=False, device=dev, T=T)
    m = b["meta"]
    err, cache8, scales8 = check_kv8(torch, b, "int8", "8B verify rows", tol, decode=False)

    def write8():
        kv8_write(cache8, scales8, b["k"], b["v"], m.slot_mapping, cuda=True)

    rows["reshape_and_cache_int8@verify"] = dict(
        max_abs_err=0.0, ms=graph_ms(torch, write8),
        plain_ms=cuda_ms(lambda: kv8_write(cache8, scales8, b["k"], b["v"], m.slot_mapping,
                                           cuda=False)),
        library_ms=None, bytes=n * (2 * 8 * 128 * 2 + 2 * 8 * 128 + 4) + T * 4, flops=0)
    s8 = 128 ** -0.5
    rows["ragged_paged_attention_int8_mma@verify"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(
            b["q"], cache8, m, scale=s8, kv_scales=scales8)),
        plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
            b["q"], cache8, m, scale=s8, kv_scales=scales8), iters=3, warmup=1),
        library_ms=None, **dict(zip(("bytes", "flops"), attention_work(
            specs, None, 2, fused=False, kv_elt=1, slot_extra=4, hq=32, hk=8, d=128))))
    log(f"verify batch, 8B shapes over an INT8 cache: D "
        f"{rows['ragged_paged_attention_int8_mma@verify']['ms']:.4f} ms, max |err| {err:.3e}")
    del b, cache8, scales8
    torch.cuda.empty_cache()
    # F at M = S·(1+K) rows: the 8B gate projection, INT8, groups of 128,
    # enough weight copies that one pass does not fit in L2 (as in phase 2).
    K_, N, group = QMM_SHAPES[QMM_LINE_SHAPE]
    gen = torch.Generator(device=dev).manual_seed(22)
    qt = quant.quantize_weight(torch.randn(K_, N, generator=gen, device=dev) * 0.02, 8, group)
    copies = [qt] + [quant.QuantizedTensor(qt.qweight.clone(), qt.scales.clone(), 8, group)
                     for _ in range(2)]
    dense = [quant.dequantize_weight(c, torch.bfloat16) for c in copies]
    x = torch.randn(T, K_, generator=gen, device=dev).to(torch.bfloat16)
    got, kernel = routed(8, lambda: qk.quantized_matmul_cuda(x, qt.qweight, qt.scales, bits=8,
                                                            group_size=group))
    if kernel != "quantized_matmul_int8_mma":
        raise AssertionError(f"F at M = {T}: {kernel} ran")
    rel, err = rel_err(got, qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=8,
                                                      group_size=group))
    if not rel <= QMM_TOL["bfloat16"]:
        raise AssertionError(f"quantized_matmul_int8_mma at M = {T}: rel err {rel:.3e}")
    nbytes, flops = qmm_work(T, K_, N, group, bits=8, x_bytes=2)
    rows["quantized_matmul_int8_mma@verify"] = dict(
        max_abs_err=err,
        ms=graph_ms(torch, lambda: [qk.quantized_matmul_cuda(
            x, c.qweight, c.scales, bits=8, group_size=group) for c in copies], iters=6) / 3,
        plain_ms=graph_ms(torch, lambda: qk.quantized_matmul_plain(
            x, qt.qweight, qt.scales, bits=8, group_size=group), iters=2),
        library_ms=graph_ms(torch, lambda: [torch.mm(x, w) for w in dense], iters=6) / 3,
        bytes=nbytes, flops=flops)
    del copies, dense, qt, x, got
    torch.cuda.empty_cache()
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"), "bfloat16")
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']}), bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    rows["paged_attention_split_combine@verify"] = split_combine_row(
        torch, "1B verify rows", hq=HQ, hk=HK, d=D,
        specs=[(1 + SPEC_K, int(k)) for k in rng.integers(1800, 2048, size=8)],
        T=8 * (1 + SPEC_K))
    return rows


def check_spec_service_parity(torch):
    """``tiny_trained`` (f32) from its directory with SPEC_K drafts, on the
    card (the CUDA-core kernels; decode and verify steps replaying graphs)
    against the same service without drafts on the card and with them on
    the CPU: greedy tokens identical in all three, the seeded sampled
    request identical with and without drafts on the card (the card's and
    the CPU's generators differ), drafts proposed and accepted."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.server import metrics
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    prompts = ["the cat sat on the mat. the cat sat on the mat. the", "abc abc abc abc abc",
               "one two three one two three one", "hello world. hello world. hello"]
    runs, drafts = {}, {}
    for device, k in (("cuda", SPEC_K), ("cuda", 0), ("cpu", SPEC_K)):
        config = EngineConfig(
            model=ModelConfig(model_name=fixture, dtype="float32"),
            cache=CacheConfig(block_size=16, num_device_blocks_override=64,
                              num_host_blocks_override=16),
            scheduler=SchedulerConfig(max_num_batched_tokens=256, max_num_sequences=8,
                                      max_model_len=256, num_speculative_tokens=k,
                                      spec_ngram_min=1),
            validation=ValidationConfig(max_input_tokens=128, max_total_tokens=256),
        )
        service = LlmService.start(config, model_dir=fixture, device=device)
        spec0 = (metrics.SPEC_PROPOSED.value, metrics.SPEC_ACCEPTED.value)

        async def drive(service=service):
            task = asyncio.create_task(service.engine.run())
            futs = [await service.handle_request(GenerateRequest(
                request_id=f"spec-parity-{i}", inputs=p,
                parameters=GenerateParameters(
                    max_new_tokens=48, do_sample=i == 3, temperature=0.8 if i == 3 else None,
                    seed=5 if i == 3 else None)))
                for i, p in enumerate(prompts)]
            results = await asyncio.wait_for(asyncio.gather(*futs), timeout=300)
            service.stop()
            task.cancel()
            return results

        results = asyncio.run(drive())
        runs[device, k] = [tuple(r.outputs[0].token_ids) for r in results]
        drafts[device, k] = (metrics.SPEC_PROPOSED.value - spec0[0],
                             metrics.SPEC_ACCEPTED.value - spec0[1])
        if k and not drafts[device, k][1]:
            raise AssertionError(f"spec service parity ({device}): no draft accepted")
    greedy = [0, 1, 2]
    if runs["cuda", SPEC_K] != runs["cuda", 0]:
        raise AssertionError("spec service parity: tiny_trained f32 tokens on the card differ "
                             "with and without drafts")
    if [runs["cuda", SPEC_K][i] for i in greedy] != [runs["cpu", SPEC_K][i] for i in greedy]:
        raise AssertionError("spec service parity: greedy tokens differ between card and CPU")
    proposed, accepted = drafts["cuda", SPEC_K]
    log(f"spec service parity: tiny_trained f32 with {SPEC_K} drafts, {len(prompts)} requests "
        f"({sum(len(t) for t in runs['cuda', SPEC_K])} tokens): identical on the card with and "
        f"without drafts (the seeded sampled one too), greedy identical on the CPU; drafts "
        f"proposed {proposed:.0f}, accepted {accepted:.0f} on the card (CPU "
        f"{drafts['cpu', SPEC_K][1]:.0f} of {drafts['cpu', SPEC_K][0]:.0f})")


def seeded_score_gap(torch, model, params, prompt, tokens, j, a, b, kv=None):
    """How near tokens ``a`` and ``b`` come to trading places in the seeded
    request's sampling at output position ``j``, the logits recomputed by
    one prefill of the prompt and ``tokens[:j]`` on the card, over a KV
    cache of the service's ``kv_cache_dtype`` ``kv``. Its scores
    are the logits over the temperature, top-p masked, plus the Gumbel
    noise of (seed, step j), and it takes their argmax. Two ways, on the
    one scale of logits over the temperature: the two tokens' score gap
    (infinite where top-p masks either), or either token's distance from
    the top-p cut, the shift of its own logit that would move it across
    the cut (to below the first token the cut masks, or above the last it
    keeps). Returns (the nearer, a phrase giving both)."""
    import math

    import numpy as np

    from atoma_infer_tpu_torch.engine.llm_service import _KV_DTYPES as KV_DTYPES
    from atoma_infer_tpu_torch.engine.sampler import _top_p_mask, gumbel_noise
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.ops.kv_cache import alloc_kv_scales

    V, top_p = model.config.vocab_size, SEEDED_OPTIONS["top_p"]
    ids = ByteTokenizer(V).encode(prompt).ids + list(tokens[:j])
    pages = -(-len(ids) // BS)
    caches = model.alloc_kv_cache(pages, BS, KV_DTYPES.get(kv))
    scales = ([alloc_kv_scales(pages, BS, model.device) for _ in caches] if kv == "int8"
              else None)
    logits = spec_step_logits(torch, model, params, caches, [(ids, 0, None, True)],
                              [list(range(pages))], kv_scales=scales)
    scaled = logits / SEEDED_OPTIONS["temperature"]
    scores = _top_p_mask(scaled, torch.tensor([top_p], device=logits.device))[0]
    scores = scores + gumbel_noise(np.array([SEEDED_OPTIONS["seed"]], np.uint32),
                                   np.array([j], np.int32), np.array([0]), V, logits.device)[0]
    score_gap = (scores[a] - scores[b]).abs().item()
    score_gap = score_gap if score_gap < math.inf else math.inf  # both masked: nan
    # The cut as _top_p_mask makes it: the sorted tokens whose exclusive
    # cumulative mass is under top_p are kept.
    ranked = torch.sort(scaled[0], descending=True).values
    probs = torch.softmax(ranked, dim=-1)
    kept = int(((torch.cumsum(probs, dim=-1) - probs) < top_p).sum())
    cut = math.inf
    if kept < V:
        last_kept, first_masked = ranked[kept - 1].item(), ranked[kept].item()
        for x in (a, b):
            sx = scaled[0, x].item()
            if sx != ranked[0].item():  # the argmax is always kept
                cut = min(cut, sx - first_masked if sx >= last_kept else last_kept - sx)
    return min(score_gap, cut), (
        f"sampling scores {score_gap:.4f} apart, the top-p cut {cut:.4f} from the nearer "
        f"(it keeps {kept} of {V} tokens)")


def compare_to_reference(label, got, want, top, seeded_gap, reference="the run without drafts"):
    """Hold a bf16 spec run's tokens to the same service's without drafts:
    each greedy request token for token up to its first difference, which
    must sit where the reference's top two logprobs are closer than
    SPEC_TIE_TOL (compared no further). The seeded sampled request likewise:
    identical up to a first difference where its two tokens come nearer to
    trading places (``seeded_gap(j, a, b)``: their sampling scores, or
    either's distance from the top-p cut) than SPEC_TIE_TOL over the
    temperature, twice (the recomputed logits are a third rounding path).
    Prints each request's common prefix."""
    prefixes = []
    for i, (g, w) in enumerate(zip(got, want)):
        n = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        seeded = " (seeded)" if i == SEEDED_REQUEST else ""
        if n == min(len(g), len(w)):
            prefixes.append(f"{i}: {n}{seeded} (identical)")
            continue
        if i == SEEDED_REQUEST:
            gap, what = seeded_gap(n, g[n], w[n])
            tol = 2 * SPEC_TIE_TOL / SEEDED_OPTIONS["temperature"]
        else:
            alts = top[i][n]
            gap, tol = alts[0][1] - alts[1][1], SPEC_TIE_TOL
            what = f"top two logprobs {gap:.4f} apart"
        if not gap < tol:
            raise AssertionError(
                f"service {label}: request {i}{seeded} differs from {reference} at "
                f"token {n} ({g[n]} against {w[n]}), where the reference's {what} "
                f"(near-tie tol {tol:.4f})")
        prefixes.append(f"{i}: {n}{seeded} (then a near-tie, the reference's {what})")
    log(f"service {label}: common prefix with {reference}, by request: "
        + "; ".join(prefixes))


def serve_spec(torch, label, model, params, make_config, path, ref_path, modes, reference,
               new_tokens=OTHER_SERVICES_TOKENS):
    """A bf16 service with SPEC_K drafts on SPEC_PROMPTS: first the same
    service without drafts in ``reference`` mode, its requests asking the
    top 2 logprobs; then in each of ``modes`` with drafts, held to it by
    :func:`compare_to_reference`, its period and tokens/s printed beside the
    reference's; the synchronous eager and graph modes' tokens identical.
    ``make_config(async_scheduling, k)``. Returns the launch counts of the
    last mode's run."""
    ref = {}
    kv = make_config(False, 0).model.kv_cache_dtype
    _, want = serve(torch, f"{label} without drafts", model, params,
                    make_config(reference == "async+graphs", 0), ref_path, mode=reference,
                    new_tokens=new_tokens, prompts=SPEC_PROMPTS, top_n=2, stats=ref)
    gc.collect()
    torch.cuda.empty_cache()
    tokens = {}
    for mode in modes:
        st = {}
        counts, got = serve(torch, label, model, params,
                            make_config(mode == "async+graphs", SPEC_K), path, mode=mode,
                            new_tokens=new_tokens, prompts=SPEC_PROMPTS, stats=st)
        tokens[mode] = got
        gc.collect()
        torch.cuda.empty_cache()
        if mode == "graphs" and "eager" in tokens:
            if tokens["eager"] != got:
                raise AssertionError(f"service {label}: tokens differ between the eager and the "
                                     "graphs runs")
            log(f"service {label}: tokens identical in the eager and graphs runs (synchronous, "
                f"{len(got)} requests)")
        compare_to_reference(
            f"{label} [{mode}]", got, want, ref["top"],
            lambda j, a, b: seeded_score_gap(torch, model, params,
                                             SPEC_PROMPTS[SEEDED_REQUEST], want[SEEDED_REQUEST],
                                             j, a, b, kv))
        p, rp = st["period"], ref["period"]
        period = (f"steady period p50/p99 {p['p50']:.3f}/{p['p99']:.3f} ms against "
                  f"{rp['p50']:.3f}/{rp['p99']:.3f} ms" if p and rp else "no steady period")
        log(f"service {label} [{mode}] against [{reference}] without drafts: {period}; "
            f"{st['tok_s']:.1f} against {ref['tok_s']:.1f} tokens/s over the whole window")
    return counts


def run_spec_service(torch):
    """The bf16 Llama-3.2-1B service (16 layers) with SPEC_K drafts, 8
    sequences: (a) eager and synchronous, then synchronous with graphs
    (tokens identical to (a)), (b) async with graphs after ``warmup()``,
    each against the same service without drafts (async with graphs).
    Returns (b)'s launches of the verify path, keyed ``kernel@verify``."""
    model, params = llama_1b_model(torch)
    counts = serve_spec(
        torch, "1B bf16 spec", model, params,
        lambda a, k: bf16_config("llama-3.2-1b-random", BS, async_scheduling=a,
                                 max_num_sequences=8, num_speculative_tokens=k),
        SPEC_PATH, SERVICE_PATH, ("eager", "graphs", "async+graphs"), "async+graphs")
    return {f"{k}@verify": counts[k] for k in SPEC_PATH}


# ------------------------------------------------- tensor parallelism
# Per-rank attention shapes of tensor parallelism: (q heads, kv heads) a
# rank holds, and the model's kv heads, over which an INT8 cache's scales
# are taken (scales_new). Llama-3.1-8B at tp = 2 (32 q and 8 kv heads over
# 2 ranks) and Llama-3.1-70B at tp = 8 (64 q and 8 kv heads over 8 ranks:
# one kv head and its 8 q heads a rank; meta-llama/Llama-3.1-70B
# config.json), head dim 128, blocks of 16.
TP_ATTENTION_SHAPES = {"8B tp=2": (16, 4, 8), "70B tp=8": (8, 1, 8)}
# Llama-3.1-70B's per-rank INT8 matmul shapes at tp = 8 (hidden 8192,
# intermediate 28672, 64 q heads of 128): name -> (K, N), groups of 128.
TP_QMM_SHAPES = {
    "gate_proj/up_proj": (8192, 3584),
    "down_proj": (3584, 8192),
    "o_proj": (1024, 8192),
}
# C timed where its bytes bound it: 8,192 rows at the 8B shapes (32
# prefill chunks of 256 tokens), against the services' 514-row write.
C_BOUND_ROWS = 8192
# The tensor-parallel services' ranks, all on this card.
TP_RANKS = 2
TP_LABEL = (f"{TP_RANKS} processes time-sharing one card, collectives via host memory: "
            "not a TP speed")


def rank_scales(torch, k, v, hk_total, gen):
    """The scales of a rank's new K/V ([T, hk, D] each) taken over the
    model's ``hk_total`` kv heads: the other ranks' heads drawn at twice the
    scale, so that the full-head absmax differs from the rank's own."""
    from atoma_infer_tpu_torch.ops.kv_cache import kv_quant_scales

    T, hk, d = k.shape
    others = [2 * torch.randn(T, hk_total - hk, d, generator=gen, device=k.device).to(k.dtype)
              for _ in range(2)]
    full = kv_quant_scales(torch.cat([k, others[0]], 1), torch.cat([v, others[1]], 1))
    if torch.equal(full, kv_quant_scales(k, v)):
        raise AssertionError("tp kernels: the full-head scales equal the rank's own")
    return full


def check_tp_kernels(torch):
    """Phase 2, tensor parallelism: the INT8 write and the split fused D
    with ``scales_new`` (the scales of the model's kv heads, not the
    rank's) at the per-rank shapes of TP_ATTENTION_SHAPES, against their
    plain versions with the same scales: caches and scales bit-exact, the
    attention within ATTN_TOL; F at Llama-3.1-70B's per-rank shapes at tp =
    8 (TP_QMM_SHAPES, M = 8) beside torch.mm on the dequantized weights;
    then C alone at C_BOUND_ROWS rows, timed against its bound. Returns the
    kernels line's rows, keyed ``kernel@tp <shape>``."""
    import numpy as np

    from atoma_infer_tpu_torch.ops import kv_write, paged_attention as pa, quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    gen = torch.Generator(device=dev).manual_seed(23)
    mixed_specs, decode_specs = kernel_line_specs(rng)
    tol, rows = ATTN_TOL["bfloat16"], {}
    for label, (hq, hk, hk_total) in TP_ATTENTION_SHAPES.items():
        shape = dict(hq=hq, hk=hk, d=128, bs=16, dtype=torch.bfloat16, device=dev)
        mixed = make_batch(rng, mixed_specs, num_blocks=4096, decode_only=False, **shape)
        decode = make_batch(rng, decode_specs, num_blocks=8192, decode_only=True, **shape)
        # The INT8 write with scales_new: bit-exact.
        m, n = mixed["meta"], mixed["rows"]
        sn = rank_scales(torch, mixed["k"], mixed["v"], hk_total, gen)
        cache, scales = kv8_cache(torch, mixed["cache"], "int8", 128)

        def write(c=cache, s=scales, cuda=True):
            fn = kv_write.write_kv_cache_quant_cuda if cuda else kv_write.write_kv_cache_quant_plain
            fn(c, s, mixed["k"], mixed["v"], m.slot_mapping, scales_new=sn)

        got_c, got_s, want_c, want_s = clone(cache), clone(scales), clone(cache), clone(scales)
        write(got_c, got_s)
        write(want_c, want_s, cuda=False)
        stored = got_s.view(-1, 2)[m.slot_mapping[:n].long()].float()
        if not (same_bytes(torch, got_c, want_c) and same_bytes(torch, got_s, want_s)
                and torch.equal(stored, sn[:n])):
            raise AssertionError(f"reshape_and_cache_int8 scales_new {label}: not bit-exact")
        row_in, row_out = 2 * hk * 128 * 2, 2 * hk * 128 + 4
        rows[f"reshape_and_cache_int8@tp {label}"] = dict(
            max_abs_err=0.0, ms=graph_ms(torch, write),
            plain_ms=cuda_ms(lambda: write(cuda=False)), library_ms=None,
            bytes=n * (row_in + row_out + 8) + m.slot_mapping.numel() * 4, flops=0)
        log(f"reshape_and_cache_int8 with scales_new {label} (Hk={hk} of {hk_total}): bit-exact "
            f"on {n} rows, the stored scales the model's")
        # The split fused D with scales_new.
        dm, dn = decode["meta"], decode["rows"]
        dsn = rank_scales(torch, decode["k"], decode["v"], hk_total, gen)
        dcache, dscales = kv8_cache(torch, decode["cache"], "int8", 128)
        got_c, got_s, want_c, want_s = clone(dcache), clone(dscales), clone(dcache), clone(dscales)
        split = pa.FUSED_DECODE_SPLIT[torch.int8]
        before = split.launches
        out = pa.ragged_paged_attention_fused_cuda(
            decode["q"], got_c, decode["k"], decode["v"], dm, scale=128 ** -0.5,
            kv_scales=got_s, scales_new=dsn)
        if split.launches != before + 1:
            raise AssertionError(f"fused D scales_new {label}: not the split kernel")
        ref = pa.fused_decode_attention_plain(
            decode["q"], want_c, decode["k"], decode["v"], dm, scale=128 ** -0.5,
            kv_scales=want_s, scales_new=dsn)
        err = (out[:dn].float() - ref[:dn].float()).abs().max().item()
        if not (same_bytes(torch, got_c, want_c) and same_bytes(torch, got_s, want_s)
                and torch.allclose(out[:dn].float(), ref[:dn].float(), atol=tol, rtol=tol)):
            raise AssertionError(f"fused_decode_attention_int8_split scales_new {label}: "
                                 f"max |err| {err:.3e}")
        nbytes, flops = attention_work(decode_specs, None, 2, fused=True, kv_elt=1,
                                       slot_extra=4, hq=hq, hk=hk, d=128)
        rows[f"fused_decode_attention_int8_split@tp {label}"] = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
                decode["q"], dcache, decode["k"], decode["v"], dm, scale=128 ** -0.5,
                kv_scales=dscales, scales_new=dsn)),
            plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
                decode["q"], dcache, decode["k"], decode["v"], dm, scale=128 ** -0.5,
                kv_scales=dscales, scales_new=dsn), iters=5, warmup=1),
            library_ms=None, bytes=nbytes + 8 * dn, flops=flops)
        log(f"fused_decode_attention_int8_split with scales_new {label} (Hq={hq}, Hk={hk}): "
            f"max |err| {err:.3e} (tol {tol}), cache and scales bit-exact")
        if label == "8B tp=2":
            check_f32_scales_new(torch, decode, dcache, dscales, dsn)
            rows.update(check_tp_e4m3(torch, label, mixed, decode, mixed_specs, decode_specs,
                                      hq, hk))
        del mixed, decode, cache, scales, dcache, dscales, got_c, got_s, want_c, want_s
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flops"), "bfloat16")
    # F at 70B's per-rank shapes (tp = 8), bf16 activations: the tensor cores.
    M, group = 8, 128
    for shape, (K, N) in TP_QMM_SHAPES.items():
        w = torch.randn(K, N, generator=gen, device=dev) * 0.02
        qt = quant.quantize_weight(w, 8, group)
        w_bytes = qt.qweight.numel() + qt.scales.numel() * 2
        copies = [qt] + [quant.QuantizedTensor(qt.qweight.clone(), qt.scales.clone(), 8, group)
                         for _ in range(-(-128_000_000 // w_bytes) - 1)]
        dense = [quant.dequantize_weight(c, torch.bfloat16) for c in copies]
        iters = max(2, 20 // len(copies))
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        name = "quantized_matmul_int8_mma"
        if routed(8, lambda: qk.quantized_matmul_cuda(x, qt.qweight, qt.scales, bits=8,
                                                      group_size=group))[1] != name:
            raise AssertionError(f"F 70B tp=8 {shape}: another route ran")
        rel, err = rel_err(qk.quantized_matmul_cuda(x, qt.qweight, qt.scales, bits=8,
                                                    group_size=group),
                           qk.quantized_matmul_plain(x, qt.qweight, qt.scales, bits=8,
                                                     group_size=group))
        if not rel <= QMM_TOL["bfloat16"]:
            raise AssertionError(f"F 70B tp=8 {shape}: rel err {rel:.3e}")
        ms = graph_ms(torch, lambda: [qk.quantized_matmul_cuda(x, c.qweight, c.scales, bits=8,
                                                               group_size=group)
                                      for c in copies], iters=iters) / len(copies)
        library_ms = graph_ms(torch, lambda: [torch.mm(x, d) for d in dense],
                              iters=iters) / len(copies)
        plain_ms = graph_ms(torch, lambda: qk.quantized_matmul_plain(
            x, qt.qweight, qt.scales, bits=8, group_size=group), iters=2)
        bound_ms, bound_by = bound(*qmm_work(M, K, N, group, bits=8, x_bytes=2), "bfloat16")
        rows[f"{name}@tp 70B tp=8 {shape}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        del copies, dense, w
        torch.cuda.empty_cache()
    rows.update(check_tp_w8a8(torch, gen))
    for name, r in rows.items():
        lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, library {lib}), bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, max |err| {r['max_abs_err']:.3e}")
    check_c_at_its_bound(torch, rng)
    return rows


def check_tp_e4m3(torch, label, mixed, decode, mixed_specs, decode_specs, hq, hk):
    """E at a rank's shapes (an e4m3 cache has no scales, so no
    ``scales_new``): the e4m3 write and the tensor-core ragged E on the
    mixed batch, the split fused E on the 64 decode rows, each against its
    plain version (caches bit-exact), then timed. Returns their rows (bytes
    and operations for the bound), keyed ``kernel@tp <label>``."""
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    tol, scale, rows = ATTN_TOL["bfloat16"], 128 ** -0.5, {}
    work = dict(kv_elt=1, slot_extra=0, hq=hq, hk=hk, d=128)
    err, cache, _ = check_kv8(torch, mixed, "fp8", f"{label} mixed", tol, decode=False)
    m = mixed["meta"]
    nbytes, flops = attention_work(mixed_specs, None, 2, fused=False, **work)
    rows[f"ragged_paged_attention_fp8_mma@tp {label}"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: pa.ragged_paged_attention_cuda(mixed["q"], cache, m, scale=scale)),
        plain_ms=cuda_ms(lambda: pa.ragged_paged_attention_paged_plain(
            mixed["q"], cache, m, scale=scale), iters=5, warmup=1),
        library_ms=None, bytes=nbytes, flops=flops)
    derr, dcache, _ = check_kv8(torch, decode, "fp8", f"{label} decode", tol, decode=True)
    dm = decode["meta"]
    split = pa.FUSED_DECODE_SPLIT[torch.float8_e4m3fn]
    before = split.launches
    pa.ragged_paged_attention_fused_cuda(decode["q"], dcache, decode["k"], decode["v"], dm,
                                         scale=scale)
    if split.launches != before + 1:
        raise AssertionError(f"fused E {label}: not the split kernel")
    nbytes, flops = attention_work(decode_specs, None, 2, fused=True, **work)
    rows[f"fused_decode_attention_fp8_split@tp {label}"] = dict(
        max_abs_err=derr,
        ms=cuda_ms(lambda: pa.ragged_paged_attention_fused_cuda(
            decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale)),
        plain_ms=cuda_ms(lambda: pa.fused_decode_attention_plain(
            decode["q"], dcache, decode["k"], decode["v"], dm, scale=scale), iters=5, warmup=1),
        library_ms=None, bytes=nbytes, flops=flops)
    log(f"E at {label} (Hq={hq}, Hk={hk}, e4m3): the write bit-exact, ragged max |err| "
        f"{err:.3e}, split fused max |err| {derr:.3e} (tol {tol})")
    return rows


# H at Llama-3.1-8B's per-rank row-parallel shapes at tp = 2 (K halved):
# name -> (K, N), groups of 128.
TP_W8A8_SHAPES = {"o_proj": (2048, 4096), "down_proj": (7168, 4096)}


def check_tp_w8a8(torch, gen):
    """H (W8A8, the int8 tensor cores) at TP_W8A8_SHAPES, M = 8, against
    its plain version, timed in CUDA graphs beside torch.mm on the
    dequantized weight (over enough weight copies that none sits in L2).
    Returns the rows, keyed ``quantized_matmul_w8a8_mma@tp 8B tp=2 <name>``."""
    from atoma_infer_tpu_torch.ops import quant
    from atoma_infer_tpu_torch.ops import quant_kernels as qk

    M, group, rows, name = 8, 128, {}, "quantized_matmul_w8a8_mma"
    for shape, (K, N) in TP_W8A8_SHAPES.items():
        w = torch.randn(K, N, generator=gen, device="cuda") * 0.02
        qt = quant.quantize_weight(w, 8, group)
        w_bytes = qt.qweight.numel() + qt.scales.numel() * 2
        copies = [qt] + [quant.QuantizedTensor(qt.qweight.clone(), qt.scales.clone(), 8, group)
                         for _ in range(-(-128_000_000 // w_bytes) - 1)]
        dense = [quant.dequantize_weight(c, torch.bfloat16) for c in copies]
        iters = max(2, 20 // len(copies))
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        xq, act = qk.quantize_activations(x)

        def run(c):
            return qk.w8a8_matmul_cuda(xq, c.qweight, c.scales, act, bits=8, group_size=group,
                                       out_dtype=torch.bfloat16)

        def plain():
            return qk.w8a8_matmul_plain(xq, qt.qweight, qt.scales, act, bits=8,
                                        group_size=group, out_dtype=torch.bfloat16)

        got, kernel = routed(8, lambda: run(qt), w8a8=True)
        if kernel != name:
            raise AssertionError(f"H 8B tp=2 {shape}: {kernel} ran")
        rel, err = rel_err(got, plain())
        if not rel <= QMM_TOL["bfloat16"]:
            raise AssertionError(f"H 8B tp=2 {shape}: rel err {rel:.3e}")
        bound_ms, bound_by = bound(*qmm_work(M, K, N, group, bits=8, x_bytes=1, w8a8=True),
                                   "int8")
        rows[f"{name}@tp 8B tp=2 {shape}"] = dict(
            max_abs_err=err,
            ms=graph_ms(torch, lambda: [run(c) for c in copies], iters=iters) / len(copies),
            plain_ms=graph_ms(torch, plain, iters=2),
            library_ms=graph_ms(torch, lambda: [torch.mm(x, d) for d in dense],
                                iters=iters) / len(copies),
            bound_ms=bound_ms, bound_by=bound_by)
        del copies, dense, w
        torch.cuda.empty_cache()
    return rows


def check_nccl_group(torch):
    """The NCCL route's process groups built on this card and every
    collective of a ``TpGroup`` run over them, on a group of one rank (NCCL
    refuses two ranks on one device, so the route of a card a rank cannot
    run here): each returns its input."""
    import socket

    from atoma_infer_tpu_torch.parallel.group import TpGroup

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    group = TpGroup.join(tp=1, rank=0, device=torch.device("cuda", 0), backend="nccl",
                         stage_on_host=False, init_method=f"tcp://127.0.0.1:{port}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(8, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    logits = torch.randn(8, 1024, generator=gen, device="cuda")
    ok = (torch.equal(group.all_reduce_sum(x.clone()), x)
          and torch.equal(group.all_reduce_max(logits[:, :2].contiguous()), logits[:, :2])
          and torch.equal(group.all_gather_last(logits), logits) and group.min_int(3) == 3)
    group.barrier()
    if not ok:
        raise AssertionError("NCCL one-rank group: a collective changed its input")
    log(f"NCCL one-rank group on {group.device}: the process groups built, sum, max, gather "
        f"and min run ({group.collectives} tensor collectives), inputs returned; the route of "
        "a card a rank needs 2 or more cards")


def check_f32_scales_new(torch, decode, cache, scales, scales_new):
    """f32 queries over an INT8 cache with ``scales_new``: the unsplit fused
    kernel takes its rows' own absmax, so the wrapper runs the INT8 write
    with the scales, then D's CUDA-core ragged kernel; against the plain
    fused version with the same scales (cache and scales bit-exact)."""
    from atoma_infer_tpu_torch.ops import cuda_lib, paged_attention as pa

    m, n = decode["meta"], decode["rows"]
    q32, k32, v32 = (decode[x].float() for x in ("q", "k", "v"))
    got_c, got_s, want_c, want_s = clone(cache), clone(scales), clone(cache), clone(scales)
    names = ("reshape_and_cache_int8", "ragged_paged_attention_int8", "fused_decode_attention_int8")
    before = [cuda_lib.KERNELS[k].launches for k in names]
    got = pa.ragged_paged_attention_fused_cuda(q32, got_c, k32, v32, m, scale=128 ** -0.5,
                                               kv_scales=got_s, scales_new=scales_new)
    ran = [cuda_lib.KERNELS[k].launches - b for k, b in zip(names, before)]
    want = pa.fused_decode_attention_plain(q32, want_c, k32, v32, m, scale=128 ** -0.5,
                                           kv_scales=want_s, scales_new=scales_new)
    err = (got[:n] - want[:n]).abs().max().item()
    tol = ATTN_TOL["float32"]
    if ran != [1, 1, 0] or not (same_bytes(torch, got_c, want_c) and same_bytes(
            torch, got_s, want_s) and torch.allclose(got[:n], want[:n], atol=tol, rtol=tol)):
        raise AssertionError(f"f32 fused decode with scales_new: launches {ran}, max |err| "
                             f"{err:.3e}")
    log(f"fused decode, f32 queries with scales_new (8B tp=2): the INT8 write, then the "
        f"CUDA-core ragged D; cache and scales bit-exact, max |err| {err:.3e} (tol {tol})")


def check_c_at_its_bound(torch, rng):
    """C (the bf16 write) at C_BOUND_ROWS rows of the 8B shapes, bit-exact,
    timed in a CUDA graph beside index_copy_ and its bound."""
    from atoma_infer_tpu_torch.ops import kv_write

    dev = torch.device("cuda")
    b = make_batch(rng, [(256, 256)] * (C_BOUND_ROWS // 256), num_blocks=1024,
                   decode_only=False, hq=32, hk=8, d=128, bs=16, dtype=torch.bfloat16,
                   device=dev)
    m, n = b["meta"], b["rows"]
    got, want = b["cache"].clone(), b["cache"].clone()
    kv_write.write_kv_cache_cuda(got, b["k"], b["v"], m.slot_mapping)
    kv_write.write_kv_cache_plain(want, b["k"], b["v"], m.slot_mapping)
    if not torch.equal(got, want):
        raise AssertionError(f"reshape_and_cache at {n} rows: not bit-exact")
    valid = m.slot_mapping >= 0
    slots = m.slot_mapping[valid].long()
    fused_rows = torch.stack([b["k"], b["v"]], 2).reshape(b["k"].shape[0], -1)[valid]
    flat = got.view(-1, got.shape[-1])
    ms = graph_ms(torch, lambda: kv_write.write_kv_cache_cuda(got, b["k"], b["v"],
                                                              m.slot_mapping))
    lib_ms = graph_ms(torch, lambda: flat.index_copy_(0, slots, fused_rows))
    nbytes = n * 2 * (2 * 8 * 128 * 2) + m.slot_mapping.numel() * 4
    bound_ms, bound_by = bound(nbytes, 0, "bfloat16")
    log(f"reshape_and_cache at {n} rows (8B shapes, bf16): {ms:.4f} ms in a CUDA graph "
        f"(index_copy_ {lib_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 2**20:.1f} MiB), {bound_ms / ms:.1%} of the bound")


def build_8b_int8(device, num_layers):
    """A rank's copy of the 8B INT8 weights, drawn as run_quant_services
    draws them (seed 8, quantized on the card): each rank of a
    tensor-parallel service builds the whole model, and the service cuts
    its shard. A ``ModelFactory`` build: picklable by import path."""
    import torch

    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import quantize_params

    model = Llama(llama_8b_config(num_layers), dtype=torch.bfloat16, device=device)
    dense = model.init_params(torch.Generator(device=model.device).manual_seed(8))
    params = quantize_params(dense, "int8")
    del dense
    torch.cuda.empty_cache()
    return model, params, ByteTokenizer(model.config.vocab_size)


def drive(torch, label, service, prompts, new_tokens, *, top_n=0, waves=True, warmup=False,
          on_traffic=None):
    """Serve ``prompts`` (the fourth seeded and sampled, the rest greedy,
    ``top_n`` alternatives asked) through a started service, in two waves
    as ``serve`` admits them (the second before engine step
    SECOND_WAVE_STEP) when ``waves``; after ``service.warmup()`` when
    ``warmup`` (the cohorts' rotation then starts the traffic from cohort
    0, as a service without warmup does, so that both schedule alike), and
    ``on_traffic()`` called just before the traffic. Every request must
    finish and every block return. Returns (tokens, top logprobs, figures:
    the traffic's seconds, engine steps, pure-decode dispatch times,
    generated tokens, the launches of the run, all set to 0 just before
    it, and the warmup's seconds)."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    engine, worker = service.engine, service.engine.worker
    pool = service.config.cache.num_device_blocks
    dispatches, steps = [], [0]
    dispatch, step = worker.dispatch, engine.step

    def timed_dispatch(request, feed=None):
        metas = request.sequence_groups_metadata
        dispatches.append((time.monotonic(), bool(metas) and not any(m.is_prompt for m in metas),
                           sum(len(m.seq_data) for m in metas)))
        return dispatch(request, feed=feed)

    def request(i):
        sampled = i == SEEDED_REQUEST
        return GenerateRequest(
            request_id=f"{label}-{i}", inputs=prompts[i],
            parameters=GenerateParameters(max_new_tokens=new_tokens, do_sample=sampled,
                                          top_n_tokens=top_n or None,
                                          **(SEEDED_OPTIONS if sampled else {})))

    warm = [None]

    async def run():
        task = asyncio.create_task(engine.run())
        if warmup:
            warm[0] = await service.warmup()
            while engine._has_unfinished():  # the warmup's last in-flight steps
                await asyncio.sleep(0.01)
            engine._next_cohort = 0
        held = []
        engine.add_request = lambda *args: held.append(args)
        futs = [await service.handle_request(request(i)) for i in range(len(prompts))]
        del engine.add_request
        first = held[:4] if waves else held

        def counted_step():
            steps[0] += 1
            if waves and steps[0] == SECOND_WAVE_STEP:
                for args in held[4:]:
                    engine.add_request(*args)
            return step()

        engine.step = counted_step
        worker.dispatch = timed_dispatch
        if on_traffic is not None:
            on_traffic()
        for k in cuda_lib.KERNELS.values():
            k.launches = k.columns = 0
        t0 = time.monotonic()
        for args in first:
            engine.add_request(*args)
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=600)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {name: k.launches for name, k in cuda_lib.KERNELS.items()}
        columns = {name: k.columns for name, k in cuda_lib.KERNELS.items()}
        service.stop()
        task.cancel()
        return results, seconds, launches, columns

    results, seconds, launches, columns = asyncio.run(run())
    eos = set(engine.eos_token_ids)
    for r in results:
        out = r.outputs[0]
        if not ((len(out.token_ids) == new_tokens and out.finish_reason == "length_capped")
                or (out.finish_reason == "stopped" and out.token_ids[-1] in eos)):
            raise AssertionError(f"{label} {r.request_id}: {len(out.token_ids)} tokens, "
                                 f"finish {out.finish_reason}")
    free = engine.scheduler.block_manager.get_num_free_device_blocks()
    if free != pool:
        raise AssertionError(f"service {label}: {pool - free} KV blocks leaked")
    return ([tuple(r.outputs[0].token_ids) for r in results],
            [r.outputs[0].top_logprobs for r in results] if top_n else None,
            dict(seconds=seconds, steps=steps[0], dispatches=dispatches,
                 generated=sum(len(r.outputs[0].token_ids) for r in results),
                 launches=launches, columns=columns, warmup_s=warm[0]))


def steady_decode(figures) -> str:
    """The steady-decode period (p50, p99) and tokens/s of a ``drive`` run,
    and its tokens/s over the whole window."""
    d = figures["dispatches"]
    periods = [(b[0] - a[0]) * 1e3 for a, b in zip(d, d[1:]) if a[1] and b[1]]
    rows = sum(a[2] for a, b in zip(d, d[1:]) if a[1] and b[1])
    whole = (f"{figures['generated'] / figures['seconds']:.1f} tokens/s over the whole window "
             f"({figures['generated']} tokens in {figures['seconds']:.3f} s)")
    if not periods:
        return whole
    return (f"steady-decode period p50 {percentile(periods, 0.5):.3f} ms, p99 "
            f"{percentile(periods, 0.99):.3f} ms over {len(periods)} intervals, "
            f"{rows / (sum(periods) / 1e3):.1f} tokens/s in steady decode; {whole}")


def report_tp(label, service, figures, collectives):
    """The TP run's figures: backend and devices, per-rank KV blocks,
    collectives per step, the steady-decode period and tokens/s, labelled
    TP_LABEL."""
    from atoma_infer_tpu_torch.parallel.group import local_device

    group = service.group
    devices = [str(local_device(group.device.type, r, 1)) for r in range(group.tp)]
    log(f"service {label}: backend {group.backend}, staged through host memory "
        f"{group.stage_on_host}; rank devices {devices}")
    log(f"service {label}: KV blocks on every rank {service.config.cache.num_device_blocks} "
        "(the least of the ranks' profiles, taken one after another on the shared card)")
    log(f"service {label}: {collectives} collectives over {figures['steps']} engine steps, "
        f"{collectives / max(1, figures['steps']):.1f} a step on rank 0")
    log(f"service {label} ({TP_LABEL}): {steady_decode(figures)}")


# The 8B tensor-parallel services' new tokens a request (the services'
# OTHER_SERVICES_TOKENS halved: every eager tp = 2 step waits on its
# collectives through host memory, 190–320 ms a step on an H100).
TP_TOKENS = 64
# Layers of the 8B INT8 + INT8 KV service at tp = 2, of Llama-3.1-8B's 32:
# an eighth, to keep the smoke's wall inside its limit on a slow host (each
# layer is 3 host round trips a step on one card).
TP_LAYERS = 4
# Layers of the item-14 runs (E over an e4m3 cache, H under W8A8) at tp = 2,
# of Llama-3.1-8B's 32; the widths are the model's.
TP_KERNEL_LAYERS = 4
# The kernels of the 8B INT8 + INT8 KV service at tp = 2: C's INT8 write with
# scales_new, D ragged (prefill), D split fused (decode), F.
TP_PATH = ("reshape_and_cache_int8", "ragged_paged_attention_int8_mma",
           "fused_decode_attention_int8_split", "quantized_matmul_int8_mma")
# Item 14's kernels at tp = 2: E's (e4m3 write, ragged, split fused) and H.
TP_E4M3_PATH = kv8_path("fp8")
TP_W8A8_PATH = ("quantized_matmul_w8a8_mma",)


def build_tiny_trained(device):
    """``tiny_trained`` from its directory through the port's loader (f32):
    a ``ModelFactory`` build, picklable by import path."""
    import torch

    from atoma_infer_tpu_torch.engine.llm_service import _load_tokenizer
    from atoma_infer_tpu_torch.models.registry import get_model_cls
    from atoma_infer_tpu_torch.models.weights import load_hf_config, load_llama_params

    path = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    cfg = load_hf_config(path)
    model = get_model_cls(cfg.architecture or "llama")(cfg, dtype=torch.float32, device=device)
    params = load_llama_params(path, cfg, dtype=torch.float32, device=device)
    return model, params, _load_tokenizer(path)


def watch_graphs(service):
    """Record rank 0's graph runs: (key, captured before, replayed, the
    step's kind, its kernel launches, its collectives). Returns (the runs,
    a callback marking the traffic's start: the index of its first run, the
    evictions and the collectives before it)."""
    from atoma_infer_tpu_torch.ops import cuda_lib

    worker, group = service.engine.worker, service.group
    graphs, runs, kind, mark = service.engine.worker.graphs, [], [None], {}
    run = graphs.run

    def recorded(key, *args):
        seen, replays = key in graphs.graphs, graphs.replays
        k0 = {name: k.launches for name, k in cuda_lib.KERNELS.items()}
        c0 = group.collectives
        out = run(key, *args)
        launched = {name: k.launches - k0[name] for name, k in cuda_lib.KERNELS.items()
                    if k.launches != k0[name]}
        runs.append((key, seen, graphs.replays > replays, kind[0], launched,
                     group.collectives - c0))
        return out

    graphs.run = recorded
    dispatch = worker.dispatch

    def kinded(request, feed=None):
        metas = request.sequence_groups_metadata
        prompts = sum(m.is_prompt for m in metas)
        kind[0] = step_kind(prompts, len(metas) - prompts)
        return dispatch(request, feed=feed)

    worker.dispatch = kinded

    def on_traffic():
        mark["first"] = len(runs)
        mark["evictions"] = graphs.evictions
        mark["collectives"] = group.collectives

    return runs, mark, on_traffic


def report_tp_graphs(torch, label, service, runs, mark, figures, eager_runs, stats_dir):
    """The segmented graphs of a tp run (rank 0's runs, both ranks' memory):
    replays and first captures by step kind in the traffic, captures and
    evictions inside its window (0 evictions), segments a graph, collectives
    and each kernel's launches a pure-decode step, eager and replayed (equal;
    32 split fused D), one decode key's segments replayed alone (CUDA
    events, no collective) and the idle share, capture and warmup seconds,
    and each rank's graph memory against ``graph_reserve_bytes`` (raises
    past it)."""
    from atoma_infer_tpu_torch.engine.cuda_graphs import DecodeKey
    from atoma_infer_tpu_torch.engine.llm_service import graph_reserve_bytes, graph_segments

    graphs = service.engine.worker.graphs
    traffic = runs[mark["first"]:]
    report_graph_runs(label, dict(evictions=graphs.evictions - mark["evictions"]),
                      [(key, seen, replayed, kind) for key, seen, replayed, kind, _, _ in traffic])
    if graphs.evictions != mark["evictions"]:
        raise AssertionError(f"service {label}: {graphs.evictions - mark['evictions']} "
                             "evictions inside the traffic's window")
    warm = runs[: mark["first"]]
    log(f"service {label}: warmup captured {sum(1 for r in warm if not r[1])} keys in "
        f"{figures['warmup_s']:.2f} s; the traffic's first captures (keys warmup did not "
        "reach): " + "; ".join(str(r[0]) for r in traffic if not r[1]))
    cfg, config = service.engine.worker.model.config, service.config
    segments = {len(e.segments) for e in graphs.graphs.values()}
    most = graph_segments(cfg.num_layers, service.group.tp)
    if max(segments) > most:
        raise AssertionError(f"service {label}: {max(segments)} segments a graph, past {most}")
    # Collectives and launches of pure-decode steps: eager (the eager run,
    # and each key's first step here) against replays, key by key.
    fused = "fused_decode_attention_int8_split"
    by_key = {}
    for key, seen, replayed, kind, launched, collectives in eager_runs + runs:
        if isinstance(key, DecodeKey):
            by_key.setdefault(key, {"eager": set(), "replay": set()})[
                "replay" if replayed else "eager"].add(
                    (tuple(sorted(launched.items())), collectives))
    checked = 0
    for key, seen in by_key.items():
        if len(seen["eager"]) > 1 or len(seen["replay"]) > 1 or (
                seen["eager"] and seen["replay"] and seen["eager"] != seen["replay"]):
            raise AssertionError(f"service {label}: pure-decode key {key}: eager "
                                 f"{seen['eager']} against replayed {seen['replay']}")
        for launched, collectives in seen["eager"] | seen["replay"]:
            if dict(launched).get(fused) != cfg.num_layers:
                raise AssertionError(f"service {label}: {key} launches {fused} "
                                     f"{dict(launched).get(fused)} times a step")
        checked += bool(seen["eager"] and seen["replay"])
    if not checked:
        raise AssertionError(f"service {label}: no pure-decode key both eager and replayed")
    key = next(k for k in reversed(graphs.graphs) if isinstance(k, DecodeKey))
    entry = graphs.graphs[key]
    (launched, collectives), = by_key[key]["replay"] or by_key[key]["eager"]
    log(f"service {label}: {sorted(segments)} segments a graph (at most {most}); a pure-decode "
        f"step {collectives} collectives and launches {dict(launched)}, eager and replayed alike "
        f"({checked} keys both ways)")
    replay_ms = cuda_ms(lambda: [seg.graph.replay() for seg in entry.segments])
    d = figures["dispatches"]
    periods = [(b[0] - a[0]) * 1e3 for a, b in zip(d, d[1:]) if a[1] and b[1]]
    p50 = percentile(periods, 0.5)
    log(f"service {label}: decode key {key}'s {len(entry.segments)} segments replayed alone "
        f"(no collective): {replay_ms:.3f} ms (CUDA events); idle {1 - replay_ms / p50:.1%} "
        f"of the {p50:.3f} ms period; capture {graphs.capture_seconds:.2f} s over "
        f"{graphs.evictions + len(graphs.graphs)} captures")
    reserve = graph_reserve_bytes(cfg, config.scheduler, config.cache.block_size,
                                  quantized=config.model.quantization is not None,
                                  tp=service.group.tp)
    for rank in range(service.group.tp):
        with open(os.path.join(stats_dir, f"rank{rank}.json")) as f:
            st = json.load(f)
        took = st["captured_bytes"]
        total = st["static_bytes"] + took["pool"] + took["held"] + took["driver"]
        n = st["captures"]
        log(f"service {label}: rank {rank} graph memory: static inputs "
            f"{st['static_bytes'] / 2**20:.2f} MiB, pool growth {took['pool'] / 2**20:.2f} MiB "
            f"over {n} captures, held {took['held'] / 2**10:.1f} KiB, driver "
            f"{took['driver'] / 2**20:.2f} MiB ({took['driver'] / n / 2**20:.3f} MiB a key of "
            f"up to {st['segments']} segments, {took['driver'] / n / st['segments'] / 2**10:.1f} "
            f"KiB a segment); {total / 2**20:.2f} MiB in all against a reserve of "
            f"{reserve / 2**20:.2f} MiB")
        if total > reserve:
            raise AssertionError(f"service {label}: rank {rank}'s graphs hold {total} bytes, more "
                                 f"than the {reserve} the KV pool left them")


def run_tp_services(torch):
    """Tensor parallelism through ``LlmService.start`` with
    ``tensor_parallel_size`` TP_RANKS, the ranks spawned on this card (gloo,
    collectives through pinned host memory), every rank replaying its steps
    in CUDA graph segments between the collectives: (i) ``tiny_trained``
    from its directory, f32, each rank loading its shard, with graphs:
    tokens identical to the same service at tp = 1 on the card (graphs too),
    and the greedy ones to the CPU's (the seeded request's noise comes from
    the device's generator); (ii) Llama-3.1-8B at full width, TP_LAYERS
    layers, INT8 weights over an INT8 KV cache (pool from free memory), random
    weights from a seeded generator built on every rank
    (``build_8b_int8``), the services' 8 requests at TP_TOKENS tokens:
    every rank eager (``EagerStepGraphs``), then with segmented graphs after
    ``warmup()`` (``SerialStepGraphs``: the ranks' captures one after
    another), tokens identical, and against tp = 1 with graphs under the
    near-tie rule (:func:`report_tp_graphs` for the rest); (iii) item 14 at
    TP_KERNEL_LAYERS layers with graphs: INT8 weights over an e4m3 cache
    (E's kernels) and under W8A8 (H, ``ATOMA_W8A8=1`` for the spawned
    ranks), each against tp = 1 with graphs under the near-tie rule.
    Returns (ii)'s launches (counts set to 0 just before its traffic), E's
    and H's from (iii)."""
    import tempfile

    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService, ModelFactory
    from atoma_infer_tpu_torch.ops import quant_kernels

    t_phase = time.monotonic()
    # (i) tiny_trained, f32.
    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(8)]

    def tiny(tp):
        return EngineConfig(
            model=ModelConfig(model_name=fixture, dtype="float32", tensor_parallel_size=tp),
            cache=CacheConfig(block_size=16, num_device_blocks_override=256,
                              num_host_blocks_override=64),
            scheduler=SchedulerConfig(max_num_batched_tokens=256, max_num_sequences=8,
                                      max_model_len=256),
            validation=ValidationConfig(max_input_tokens=128, max_total_tokens=256),
        )

    runs = {}
    for name, tp, device in (("cpu", 1, "cpu"), ("cuda", 1, None), ("cuda tp=2", TP_RANKS, None)):
        service = LlmService.start(tiny(tp), device=device)
        group, graphs = service.group, service.engine.worker.graphs
        if (graphs is None) != (device == "cpu") or (
                group is not None and graphs.group is not group):
            raise AssertionError(f"tiny_trained {name}: graphs {graphs}")
        c0 = group.collectives if group else 0
        runs[name], _, fig = drive(torch, f"tiny_trained {name}", service, prompts, 24,
                                   waves=False)
        if group:
            report_tp(f"tiny_trained f32 tp={tp}", service, fig, group.collectives - c0)
            log(f"tiny_trained f32 tp={tp}: rank 0 {graphs.replays} replays of "
                f"{len(graphs.graphs)} graphs, {sorted({len(e.segments) for e in graphs.graphs.values()})} "
                "segments a graph")
            if not graphs.replays:
                raise AssertionError(f"tiny_trained tp={tp}: no step replayed")
    greedy = [i for i in range(len(prompts)) if i != SEEDED_REQUEST]
    if runs["cuda tp=2"] != runs["cuda"] or any(
            runs["cuda"][i] != runs["cpu"][i] for i in greedy):
        first = {name: [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
                        for a, b in zip(runs[name], runs["cuda"])] for name in runs}
        raise AssertionError(f"tiny_trained tp=2: tokens differ from tp=1 (card or CPU); "
                             f"first difference from the card's tp=1, by request: {first}")
    log(f"tiny_trained f32 tp={TP_RANKS} with segmented graphs: "
        f"{sum(len(t) for t in runs['cpu'])} tokens identical to tp=1 with graphs on the card "
        "(the seeded request's too) and, greedy, on the CPU")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp phase {time.monotonic() - t_phase:.0f} s] (i) done")

    # (ii) Llama-3.1-8B, INT8 weights + INT8 KV, tp = 2 eager then with
    # segmented graphs, then tp = 1 with graphs.
    text = "The quick brown fox jumps over the lazy dog. " * (-(-max(PROMPT_LENGTHS) // 45))
    prompts = [text[:n] for n in PROMPT_LENGTHS]

    def config(tp, kv="int8"):
        return dataclass_replace(
            llama_8b_service_config("int8", kv, max_seqs=8, hbm_memory_utilization=0.5),
            tensor_parallel_size=tp)

    label = f"8B INT8 + INT8 KV, {TP_LAYERS} layers tp={TP_RANKS}"
    t0 = time.monotonic()
    service = LlmService.start(config(TP_RANKS), model_factory=ModelFactory(
        config=llama_8b_config(TP_LAYERS), build=build_8b_int8, args=(TP_LAYERS,),
        step_graphs=EagerStepGraphs))
    log(f"service {label} eager: started in {time.monotonic() - t0:.1f} s ({TP_RANKS} ranks, "
        "each drawing, quantizing and cutting its shard)")
    eager_runs, _, _ = watch_graphs(service)
    c0 = service.group.collectives
    eager, _, eager_fig = drive(torch, f"{label} eager", service, prompts, TP_TOKENS, top_n=2)
    report_tp(f"{label} eager", service, eager_fig, service.group.collectives - c0)
    del service
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp phase {time.monotonic() - t_phase:.0f} s] (ii) eager done")
    stats_dir = tempfile.mkdtemp(prefix="smoke-graphs-")
    os.environ["SMOKE_GRAPH_STATS"] = stats_dir  # every rank's, spawned ones too
    try:
        service = LlmService.start(config(TP_RANKS), model_factory=ModelFactory(
            config=llama_8b_config(TP_LAYERS), build=build_8b_int8, args=(TP_LAYERS,),
            step_graphs=SerialStepGraphs))
        graph_runs, mark, on_traffic = watch_graphs(service)
        got, _, fig = drive(torch, label, service, prompts, TP_TOKENS, top_n=2, warmup=True,
                            on_traffic=on_traffic)
    finally:
        del os.environ["SMOKE_GRAPH_STATS"]
    report_tp(label, service, fig, service.group.collectives - mark["collectives"])
    launches = fig["launches"]
    for name in TP_PATH:
        if not launches[name]:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    check_route(f"service {label}", launches, bf16=True)
    if got != eager:
        raise AssertionError(f"service {label}: tokens differ between the eager ranks and the "
                             "segmented graphs")
    report_tp_graphs(torch, label, service, graph_runs, mark, fig, eager_runs, stats_dir)
    shutil.rmtree(stats_dir)
    log(f"service {label}: tokens identical eager and with segmented graphs; eager "
        f"{steady_decode(eager_fig)}; with graphs {steady_decode(fig)} ({TP_LABEL})")
    del service, on_traffic
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp phase {time.monotonic() - t_phase:.0f} s] (ii) graphs done")
    model, params, tokenizer = build_8b_int8("cuda", TP_LAYERS)
    ref_service = LlmService.start(config(1), model=model, params=params, tokenizer=tokenizer)
    want, top, ref_fig = drive(torch, f"8B INT8 + INT8 KV, {TP_LAYERS} layers tp=1",
                               ref_service, prompts, TP_TOKENS, top_n=2)
    compare_to_reference(
        label, got, want, top,
        lambda j, a, b: seeded_score_gap(torch, model, params, prompts[SEEDED_REQUEST],
                                         want[SEEDED_REQUEST], j, a, b, "int8"),
        reference="the same service at tp=1 with graphs")
    log(f"service {label}: tp=1 with graphs {steady_decode(ref_fig)}")
    del ref_service, model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp phase {time.monotonic() - t_phase:.0f} s] (ii) tp=1 done")

    # (iii) Item 14: E (e4m3 cache) and H (W8A8) at a rank's shapes, with
    # segmented graphs, against tp = 1 with graphs.
    layers = TP_KERNEL_LAYERS
    for kv, w8a8, path in (("fp8", False, TP_E4M3_PATH), ("int8", True, TP_W8A8_PATH)):
        what = f"8B INT8 {'W8A8 + INT8 KV' if w8a8 else '+ e4m3 KV'}, {layers} layers"
        saved = quant_kernels._W8A8
        quant_kernels._W8A8 = w8a8
        if w8a8:
            os.environ["ATOMA_W8A8"] = "1"
        try:
            factory = ModelFactory(config=llama_8b_config(layers), build=build_8b_int8,
                                   args=(layers,))
            service = LlmService.start(config(TP_RANKS, kv=kv), model_factory=factory)
            got, _, fig = drive(torch, f"{what} tp={TP_RANKS}", service, prompts, TP_TOKENS,
                                top_n=2)
            counts = fig["launches"]
            replays = service.engine.worker.graphs.replays
            del service
            gc.collect()
            torch.cuda.empty_cache()
            model, params, tokenizer = build_8b_int8("cuda", layers)
            ref_service = LlmService.start(config(1, kv=kv), model=model, params=params,
                                           tokenizer=tokenizer)
            want, top, ref_fig = drive(torch, f"{what} tp=1", ref_service, prompts, TP_TOKENS,
                                       top_n=2)
            compare_to_reference(
                f"{what} tp={TP_RANKS}", got, want, top,
                lambda j, a, b: seeded_score_gap(torch, model, params, prompts[SEEDED_REQUEST],
                                                 want[SEEDED_REQUEST], j, a, b, kv),
                reference="the same service at tp=1 with graphs")
            del ref_service, model, params
        finally:
            quant_kernels._W8A8 = saved
            os.environ.pop("ATOMA_W8A8", None)
        for name in path:
            if not counts[name]:
                raise AssertionError(f"kernel {name} was not launched at tp={TP_RANKS} ({what})")
            launches[name] = counts[name]
        if w8a8 and counts["quantized_matmul_w8a8"]:
            raise AssertionError(f"{what}: H launched on the CUDA cores")
        check_route(f"service {what} tp={TP_RANKS}", counts, bf16=True)
        log(f"service {what} tp={TP_RANKS} with segmented graphs ({replays} replays on rank 0): "
            f"launches {({k: counts[k] for k in path})}; {steady_decode(fig)}; tp=1 with "
            f"graphs {steady_decode(ref_fig)} ({TP_LABEL})")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[tp phase {time.monotonic() - t_phase:.0f} s] (iii) done")
    return launches


PP_STAGES = 2
PP_LABEL = "two stages on one card: not a PP speed"
# Layers of the 8B INT8 + INT8 KV service at pp = 2, of Llama-3.1-8B's 32
# (2 a stage): an eighth, to keep the smoke's wall inside its limit.
PP_LAYERS = 4
# The kernels of the 8B INT8 + INT8 KV service at pp = 2: C's INT8 write,
# D ragged (prefill), D split fused (decode), the merge, F.
PP_PATH = ("reshape_and_cache_int8", "ragged_paged_attention_int8_mma",
           "fused_decode_attention_int8_split", "paged_attention_split_combine",
           "quantized_matmul_int8_mma")
# Gemma-2-9B's PP phase: 6 layers split (0, 3), (3, 6), so stage 1 starts on
# the odd (global) layer 3; one prompt past its 4,096-key local window, so
# that a stage-local window index would change the output.
PP_GEMMA_LAYERS = 6
PP_GEMMA_PROMPT = 4300
PP_GEMMA_TOKENS = 32


def report_pp(label, service, ref_blocks, figures):
    """A PP run's stages (layer bounds, devices), KV blocks against pp = 1,
    launches per kernel and decode figures, labelled PP_LABEL."""
    stages = service.engine.worker.stages
    bounds = [(s.layer_offset, s.layer_offset + s.cache_engine.num_layers) for s in stages]
    log(f"service {label}: stages' layer bounds {bounds} on {[str(s.device) for s in stages]}; "
        f"KV blocks {service.config.cache.num_device_blocks} a stage (pp=1: {ref_blocks}; "
        "the pool is sized by the layers on the most crowded card, here all of them, less "
        "the stages' graph reserve)")
    log(f"service {label}: launches {({k: n for k, n in figures['launches'].items() if n})}")
    log(f"service {label} ({PP_LABEL}): {steady_decode(figures)}")


def eager_stages(service):
    """The same PP service with every stage eager: its stages' graphs taken
    away (in a function of its own, so that no loop variable keeps a stage,
    and its KV cache, alive after the service)."""
    for stage in service.engine.worker.stages:
        stage.graphs = None


def split_pools(service):
    """Give each stage of a PP service a graph memory pool of its own (the
    default shares one a device)."""
    for stage in service.engine.worker.stages:
        stage.graphs._pools = {}


def watch_stage_graphs(service):
    """Record every stage's graph runs: (stage, key, captured before,
    replayed, the step's kind). Returns (the runs, a callback marking the
    traffic's start: the index of its first run and each stage's evictions
    before it)."""
    worker = service.engine.worker
    runs, kind, mark = [], [None], {}
    for s, stage in enumerate(worker.stages):
        graphs = stage.graphs
        if graphs is None:
            raise AssertionError(f"stage {s} of a pp service at tp 1 on the card has no graphs")
        run = graphs.run

        def recorded(key, *args, s=s, graphs=graphs, run=run):
            seen, replays = key in graphs.graphs, graphs.replays
            out = run(key, *args)
            runs.append((s, key, seen, graphs.replays > replays, kind[0]))
            return out

        graphs.run = recorded
    dispatch = worker.dispatch

    def kinded(request, feed=None):
        metas = request.sequence_groups_metadata
        prompts = sum(m.is_prompt for m in metas)
        kind[0] = step_kind(prompts, len(metas) - prompts)
        return dispatch(request, feed=feed)

    worker.dispatch = kinded

    def on_traffic():
        mark["first"] = len(runs)
        mark["evictions"] = [st.graphs.evictions for st in worker.stages]

    return runs, mark, on_traffic


def report_stage_graphs(torch, label, service, runs, mark, figures, layers):
    """The stage graphs of a pp run: replays and first captures by stage
    and step kind in the traffic, captures and evictions inside its window,
    each stage's last graph replayed alone (CUDA events), and the graphs'
    memory on each device against the KV pool's reserve for them
    (``stage_graph_reserve_bytes``), which it must not pass. Every
    pure-decode step must run the split fused D once a layer: in a stage
    graph (its capture's launches) or in the eager step before a key's
    capture. Returns each device's pool growth."""
    from atoma_infer_tpu_torch.engine.cuda_graphs import DecodeKey, StageKey, StepKey

    worker = service.engine.worker
    stages = worker.stages
    traffic = runs[mark["first"]:]
    eager = sorted({(s, key) for s, key, seen, replayed, _ in traffic if seen and not replayed})
    if eager:
        raise AssertionError(f"service {label}: stage steps ran eagerly after their key's "
                             f"capture: {eager}")
    by = {}
    for s, key, _, replayed, kind in traffic:
        by.setdefault((s, kind), [0, 0])[0 if replayed else 1] += 1
    evictions = [st.graphs.evictions - e for st, e in zip(stages, mark["evictions"])]
    log(f"service {label}: stage graph runs in the traffic by stage and step kind (replays / "
        "first captures): " + ", ".join(f"stage {s} {k} {r} / {c}"
                                        for (s, k), (r, c) in sorted(by.items()))
        + f"; {sum(c for _, c in by.values())} captures and {sum(evictions)} evictions "
        f"inside the traffic's window; warmup {figures['warmup_s']:.2f} s")
    warm = runs[: mark["first"]]
    log(f"service {label}: warmup captured {sum(1 for _, _, seen, _, _ in warm if not seen)} "
        f"stage graphs ({[len(st.graphs.graphs) for st in stages]} a stage after the traffic); "
        "the traffic's first captures, keys warmup did not reach: "
        + "; ".join(f"stage {s} {key}" for s, key, seen, _, _ in traffic if not seen))
    # Every pure-decode step: the split fused D once a layer of each stage.
    fused = "fused_decode_attention_int8_split"
    decodes = sum(1 for _, pure, _ in figures["dispatches"] if pure)
    if figures["launches"][fused] != sum(layers) * decodes:
        raise AssertionError(f"service {label}: {figures['launches'][fused]} launches of {fused} "
                             f"over {decodes} pure-decode steps of {sum(layers)} layers")
    for s, (st, n) in enumerate(zip(stages, layers)):
        for key, entry in st.graphs.graphs.items():
            decode = (isinstance(key, DecodeKey) or isinstance(key, (StageKey, StepKey))
                      and key.decode_only)
            if decode and entry.launches.get(fused) != n:
                raise AssertionError(f"service {label}: stage {s}'s graph {key} launches {fused} "
                                     f"{entry.launches.get(fused)} times, not once a layer ({n})")
    log(f"service {label}: {decodes} pure-decode steps, each {sum(layers)} launches of {fused} "
        f"(one a layer: {layers} by stage), in stage graphs but each key's first step")
    for s, st in enumerate(stages):
        key = next(reversed(st.graphs.graphs))
        log(f"service {label}: stage {s}'s last graph {key} replayed alone: "
            f"{cuda_ms(st.graphs.graphs[key].graph.replay):.3f} ms (CUDA events)")
    return report_stage_graph_memory(label, service)


def report_stage_graph_memory(label, service):
    """Print the stage graphs' memory on each device — static inputs, the
    pool's growth (by stage), what stays allocated in it and the CUDA driver's —
    against the KV pool's reserve for them (``stage_graph_reserve_bytes``),
    which it must not pass. Returns each device's pool growth."""
    from atoma_infer_tpu_torch.engine.llm_service import stage_graph_reserve_bytes

    worker = service.engine.worker
    stages = worker.stages
    cfg, config = worker.model.config, service.config
    bounds = [(st.layer_offset, st.layer_offset + st.cache_engine.num_layers) for st in stages]
    reserve = stage_graph_reserve_bytes(
        cfg, config.scheduler, config.cache.block_size, bounds, [st.device for st in stages],
        hidden_bytes=worker.model.dtype.itemsize, quantized=config.model.quantization is not None)
    pools = {}
    for device, limit in reserve.items():
        held = [st.graphs for st in stages if st.device == device]
        parts = {name: sum(g.captured_bytes[name] for g in held)
                 for name in ("pool", "held", "driver")}
        static = sum(g.static_bytes for g in held)
        total = static + sum(parts.values())
        shared = len({id(g._pools) for g in held}) == 1
        log(f"service {label}: graph memory on {device} ({len(held)} stages, "
            f"{'one pool' if shared else 'a pool a stage'}): static inputs "
            f"{static / 2**20:.2f} MiB, pool growth {parts['pool'] / 2**20:.2f} MiB (by stage "
            f"{[round(g.captured_bytes['pool'] / 2**20, 2) for g in held]} MiB), held "
            f"{parts['held'] / 2**20:.2f} MiB, driver {parts['driver'] / 2**20:.2f} MiB; "
            f"{total / 2**20:.2f} MiB in all against a reserve of {limit / 2**20:.2f} MiB")
        if total > limit:
            raise AssertionError(f"service {label}: the stage graphs hold {total} bytes on "
                                 f"{device}, more than the {limit} the KV pool left them")
        pools[device] = parts["pool"]
    return pools


def run_pp_services(torch):
    """Pipeline parallelism through ``LlmService.start`` with
    ``pipeline_parallel_size`` PP_STAGES, both stages on this card: (i)
    Llama-3.1-8B at full width, PP_LAYERS layers, INT8 weights over an INT8
    KV cache, the services' 8 requests at OTHER_SERVICES_TOKENS (one seeded):
    pp = 1 with graphs, the reference; pp = 2 eager; pp = 2 replaying one
    graph set a stage after ``warmup()``, its tokens identical to the eager
    run's and, under the near-tie rule, pp = 1's; (ii) Gemma-2-9B at
    PP_GEMMA_LAYERS layers, bf16 over bf16 KV, one prompt of
    PP_GEMMA_PROMPT tokens, pp = 2 with stage graphs identical to pp = 1
    with graphs; (iii) ``tiny_trained`` f32 at pp = 2 × tp = TP_RANKS, the
    ranks spawned on this card (gloo), every stage replaying graphs in
    segments between its stage group's collectives, identical to every
    stage eager (``EagerStepGraphs`` on every rank), to pp = 1, tp = 1 on
    the card and, greedy, to the CPU. Returns (i)'s launches with stage
    graphs (counts set to 0 just before its traffic)."""
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )
    from atoma_infer_tpu_torch.engine.llm_service import LlmService, ModelFactory
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer
    from atoma_infer_tpu_torch.models.weights import load_hf_config

    # (i) Llama-3.1-8B, INT8 weights + INT8 KV: pp = 1, then pp = 2 eager
    # and with stage graphs.
    model, params, tokenizer = build_8b_int8("cuda", PP_LAYERS)
    text = "The quick brown fox jumps over the lazy dog. " * (-(-max(PROMPT_LENGTHS) // 45))
    prompts = [text[:n] for n in PROMPT_LENGTHS]

    def config(pp):
        return dataclass_replace(
            llama_8b_service_config("int8", "int8", max_seqs=8, hbm_memory_utilization=0.5),
            pipeline_parallel_size=pp)

    ref = LlmService.start(config(1), model=model, params=params, tokenizer=tokenizer)
    ref_blocks = ref.config.cache.num_device_blocks
    want, top, ref_fig = drive(torch, f"8B INT8 + INT8 KV, {PP_LAYERS} layers pp=1", ref,
                               prompts, OTHER_SERVICES_TOKENS, top_n=2)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    label = f"8B INT8 + INT8 KV, {PP_LAYERS} layers pp={PP_STAGES}"
    service = LlmService.start(config(PP_STAGES), model=model, params=params,
                               tokenizer=tokenizer)
    eager_blocks = service.config.cache.num_device_blocks
    eager_stages(service)
    eager, _, eager_fig = drive(torch, f"{label} eager", service, prompts,
                                OTHER_SERVICES_TOKENS, top_n=2)
    del service
    gc.collect()
    torch.cuda.empty_cache()
    service = LlmService.start(config(PP_STAGES), model=model, params=params,
                               tokenizer=tokenizer)
    runs, mark, on_traffic = watch_stage_graphs(service)
    got, _, fig = drive(torch, label, service, prompts, OTHER_SERVICES_TOKENS, top_n=2,
                        warmup=True, on_traffic=on_traffic)
    report_pp(label, service, ref_blocks, fig)
    launches = fig["launches"]
    for name in PP_PATH:
        if not launches[name]:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    check_route(f"service {label}", launches, bf16=True)
    if got != eager:
        raise AssertionError(f"service {label}: tokens differ between the eager stages and the "
                             "stage graphs")
    compare_to_reference(
        label, got, want, top,
        lambda j, a, b: seeded_score_gap(torch, model, params, prompts[SEEDED_REQUEST],
                                         want[SEEDED_REQUEST], j, a, b, "int8"),
        reference="the same service at pp=1 with graphs")
    layers = [st.cache_engine.num_layers for st in service.engine.worker.stages]
    shared = report_stage_graphs(torch, label, service, runs, mark, fig, layers)
    log(f"service {label}: tokens identical eager and with stage graphs; KV blocks "
        f"{service.config.cache.num_device_blocks} with the stages' graph reserve, "
        f"{eager_blocks} in the eager run's start (the same reserve), {ref_blocks} at pp=1")
    del service, on_traffic  # on_traffic holds the worker
    gc.collect()
    torch.cuda.empty_cache()
    # One pool a device against a pool a stage: the same run with each
    # stage capturing into a pool of its own.
    service = LlmService.start(config(PP_STAGES), model=model, params=params,
                               tokenizer=tokenizer)
    split_pools(service)
    apart, _, _ = drive(torch, f"{label}, a pool a stage", service, prompts,
                        OTHER_SERVICES_TOKENS, top_n=2, warmup=True)
    if apart != got:
        raise AssertionError(f"service {label}: tokens differ with a graph pool a stage")
    own = report_stage_graph_memory(f"{label}, a pool a stage", service)
    log(f"service {label}: pool growth on the card with one pool for both stages "
        f"{sum(shared.values()) / 2**20:.2f} MiB, with a pool a stage "
        f"{sum(own.values()) / 2**20:.2f} MiB (the same traffic after warmup, tokens identical)")
    log(f"service {label}: eager {steady_decode(eager_fig)}")
    per_step = sum(eager_fig["launches"].values()) / max(1, eager_fig["steps"])
    guard = device_guard_cost_us(torch)
    log(f"a launch's device check and guard: {guard:.2f} µs on this host; the pp={PP_STAGES} "
        f"eager run launched {per_step:.0f} kernels an engine step, "
        f"{guard * per_step / 1e3:.3f} ms a step")
    log(f"service {label}: pp=1 with graphs {steady_decode(ref_fig)}; launches "
        f"{({k: ref_fig['launches'][k] for k in PP_PATH})} over {ref_fig['steps']} engine "
        f"steps (pp={PP_STAGES}: {fig['steps']})")
    del service, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # (ii) Gemma-2-9B, 6 layers, bf16: stage 1 starts on layer 3.
    name = "Gemma-2-9B"
    model, params = family_model(torch, name, PP_GEMMA_LAYERS)
    prompt = [(text * (-(-PP_GEMMA_PROMPT // len(text))))[:PP_GEMMA_PROMPT]]
    runs = {}
    for pp in (1, PP_STAGES):
        cfg = dataclass_replace(bf16_config(f"{name.lower()}-random", BS, max_model_len=6144),
                                pipeline_parallel_size=pp)
        service = LlmService.start(cfg, model=model, params=params,
                                   tokenizer=ByteTokenizer(model.config.vocab_size))
        worker = service.engine.worker
        graphs = [st.graphs for st in worker.stages] if pp > 1 else [worker.graphs]
        if any(g is None for g in graphs):
            raise AssertionError(f"{name} pp={pp}: a stage without graphs")
        blocks = service.config.cache.num_device_blocks
        runs[pp], _, fig = drive(torch, f"{name} pp={pp}", service, prompt, PP_GEMMA_TOKENS,
                                 waves=False)
        if pp > 1:
            report_pp(f"{name}, {PP_GEMMA_LAYERS} layers, pp={pp}", service, ref_blocks, fig)
            for kernel in ("ragged_paged_attention_mma", "fused_decode_attention_split"):
                if not fig["launches"][kernel]:
                    raise AssertionError(f"kernel {kernel} (D=256) was not launched at pp={pp}")
            log(f"{name} pp={pp}: {[g.replays for g in graphs]} replays by stage, "
                f"{[len(g.graphs) for g in graphs]} graphs")
        ref_blocks = blocks
        del service, worker, graphs
        gc.collect()
    if runs[PP_STAGES] != runs[1]:
        raise AssertionError(f"{name} pp={PP_STAGES}: tokens differ from pp=1 "
                             f"({runs[PP_STAGES]} against {runs[1]})")
    log(f"{name} pp={PP_STAGES} with stage graphs (layers 0-2 and 3-5, a {PP_GEMMA_PROMPT}-token "
        f"prompt past the 4,096-key window): {len(runs[1][0])} tokens identical to pp=1 with "
        "graphs")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    # (iii) tiny_trained, f32, pp = 2 × tp = 2: every stage's graphs in
    # segments between the collectives of its stage's group, against every
    # stage eager.
    fixture = os.path.join(REPO, "tests", "fixtures", "tiny_trained")
    prompts = [f"prompt number {i} " * (1 + i % 4) for i in range(8)]

    def tiny(pp, tp):
        return EngineConfig(
            model=ModelConfig(model_name=fixture, dtype="float32", tensor_parallel_size=tp,
                              pipeline_parallel_size=pp),
            cache=CacheConfig(block_size=16, num_device_blocks_override=256,
                              num_host_blocks_override=64),
            scheduler=SchedulerConfig(max_num_batched_tokens=256, max_num_sequences=8,
                                      max_model_len=256),
            validation=ValidationConfig(max_input_tokens=128, max_total_tokens=256),
        )

    both = f"cuda pp={PP_STAGES} tp={TP_RANKS}"
    eager_factory = ModelFactory(config=load_hf_config(fixture), build=build_tiny_trained,
                                 step_graphs=EagerStepGraphs)
    runs = {}
    for name, pp, tp, device, factory in (
            ("cpu", 1, 1, "cpu", None), ("cuda", 1, 1, None, None),
            (f"{both} eager", PP_STAGES, TP_RANKS, None, eager_factory),
            (both, PP_STAGES, TP_RANKS, None, None)):
        service = LlmService.start(tiny(pp, tp), device=device, model_factory=factory)
        group = service.group
        stages = [st.graphs for st in service.engine.worker.stages] if pp > 1 else []
        if name == both and any(g is None or g.group is not st.model.group for g, st in
                                zip(stages, service.engine.worker.stages)):
            raise AssertionError(f"tiny_trained {name}: a stage without segmented graphs")
        c0 = group.collectives if group else 0
        runs[name], _, fig = drive(torch, f"tiny_trained {name}", service, prompts, 24,
                                   waves=False)
        if group:
            log(f"tiny_trained f32 {name}: {group.collectives - c0} collectives over "
                f"{fig['steps']} engine steps on rank 0 ({TP_LABEL})")
        if name == both:
            log(f"tiny_trained f32 {name}: rank 0's stage graphs {[g.replays for g in stages]} "
                f"replays, {[len(g.graphs) for g in stages]} graphs, segments a graph "
                f"{[sorted({len(e.segments) for e in g.graphs.values()}) for g in stages]}")
            if not all(g.replays for g in stages):
                raise AssertionError(f"tiny_trained {name}: a stage replayed nothing")
        del service, stages
        gc.collect()
    greedy = [i for i in range(len(prompts)) if i != SEEDED_REQUEST]
    if runs[both] != runs[f"{both} eager"] or runs[both] != runs["cuda"] or any(
            runs["cuda"][i] != runs["cpu"][i] for i in greedy):
        raise AssertionError(f"tiny_trained pp={PP_STAGES} tp={TP_RANKS}: tokens with stage "
                             "graphs differ from every stage eager, pp=1 tp=1 on the card or, "
                             "greedy, the CPU")
    log(f"tiny_trained f32 pp={PP_STAGES} tp={TP_RANKS} with segmented stage graphs: "
        f"{sum(len(t) for t in runs[both])} tokens identical to every stage eager, to pp=1 "
        "tp=1 on the card (the seeded request's too) and, greedy, to the CPU")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- phase 4: float16 services
# The fp16 services' kernels by path: every launch of an fp16 service is an
# fp16 instantiation's (``check_fp16_route``).
FP16_PATH = ("reshape_and_cache_f16", "ragged_paged_attention_mma_f16",
             "fused_decode_attention_split_f16", "paged_attention_split_combine_f16")
# The 1B fp16 model's logits (16 layers) through the kernels against the same
# model attending through the plain versions on the card: max |Δ| over the
# largest logit. fp16 rounds each attention output 8× finer than bf16
# (2^-11 against 2^-8), over 16 layers where the families' bf16 check has 2.
FP16_MODEL_TOL = 2e-2
# Layers of the 8B-width fp16 services (of 32; the widths are the model's;
# 4, as the families run, for the smoke's wall).
FP16_8B_LAYERS = 4
FP16_TOKENS = 64


def llama_8b_layers(torch, dtype, num_layers, seed=8):
    """Llama-3.1-8B's widths at ``num_layers`` layers on the card, random
    ``dtype`` weights drawn as run_quant_services draws them, quantized to
    INT8 and INT4 on the card. Returns (model, {"int8": ..., "int4": ...})."""
    from atoma_infer_tpu_torch.models.llama import Llama
    from atoma_infer_tpu_torch.models.weights import quantize_params

    model = Llama(llama_8b_config(num_layers), dtype=dtype, device="cuda")
    dense = model.init_params(torch.Generator(device=model.device).manual_seed(seed))
    params = {q: quantize_params(dense, q) for q in ("int8", "int4")}
    del dense
    torch.cuda.empty_cache()
    return model, params


def check_fp16_route(label, launches):
    """Every kernel launch of an fp16 service is an fp16 instantiation's: no
    bf16 or f32 kernel took its fp16 tensors."""
    wrong = {k: n for k, n in launches.items() if n and not k.endswith("_f16")}
    if wrong:
        raise AssertionError(f"service {label}: launches off the fp16 kernels: {wrong}")


def check_fp16_logits(torch, model, params):
    """The 1B fp16 model's steps of ``two_sequence_steps`` (a prefill, then
    decode steps) through the kernels against the same model attending
    through the plain versions on the card: logits finite, within
    FP16_MODEL_TOL of the largest."""
    caches = {mode: model.alloc_kv_cache(64, BS) for mode in ("kernels", "plain")}
    worst = 0.0
    for step, decode, batch in two_sequence_steps():
        got = step_logits(torch, model, params, batch, caches["kernels"])
        with plain_attention():
            want = step_logits(torch, model, params, batch, caches["plain"])
        if not torch.isfinite(got).all():
            raise AssertionError(f"1B fp16 step {step}: logits not finite")
        err = (got - want).abs().max().item() / want.abs().max().item()
        worst = max(worst, err)
        if err > FP16_MODEL_TOL:
            raise AssertionError(f"1B fp16 step {step}: logits differ by {err:.3e} of their "
                                 f"largest (tol {FP16_MODEL_TOL})")
    log(f"model 1B fp16 (16 layers): kernels against the plain attention on the card, max "
        f"|Δ logit| {worst:.3e} of the largest (tol {FP16_MODEL_TOL}), the first step a "
        "prefill")
    del caches
    torch.cuda.empty_cache()


def run_fp16_services(torch):
    """float16 services through ``LlmService.start`` (``dtype`` float16):
    Llama-3.2-1B at full width, 16 layers (its first steps' logits against
    the plain attention on the card first), eager then synchronous with
    graphs; Llama-3.1-8B's widths at FP16_8B_LAYERS layers with INT8
    weights over an INT8 KV cache, eager then with graphs; then, eager, the
    same with INT4 weights over an e4m3 cache and with INT8 weights under
    W8A8 (G, E and H on fp16), and Phi-3-mini at ``FP16_8B_LAYERS`` layers
    over an INT8 and an e4m3 cache (D and E's wide fp16 kernels); then the
    width 512's fp16 kernels (:func:`serve_fp16_w512`). Tokens identical
    eager and with graphs, every launch an fp16 kernel's. Returns each fp16
    kernel's launches from its path's run (the wide ones keyed
    ``kernel@D``)."""
    from atoma_infer_tpu_torch.ops import quant_kernels

    launches = {}
    model, params = llama_1b_model(torch, torch.float16)
    check_fp16_logits(torch, model, params)
    counts = serve_both(
        torch, "1B fp16", model, params,
        lambda a: bf16_config("llama-3.2-1b-random", BS, async_scheduling=a, dtype="float16"),
        FP16_PATH, "graphs", FP16_TOKENS)
    check_fp16_route("1B fp16", counts)
    launches.update({k: counts[k] for k in FP16_PATH})
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    model, params = llama_8b_layers(torch, torch.float16, FP16_8B_LAYERS)

    def config(q, kv, a=False):
        return llama_8b_service_config(q, kv, async_scheduling=a, dtype="float16")

    label = f"8B INT8 + INT8 KV fp16 ({FP16_8B_LAYERS} of 32 layers)"
    path = ("reshape_and_cache_int8_f16", "ragged_paged_attention_int8_mma_f16",
            "fused_decode_attention_int8_split_f16", "quantized_matmul_int8_mma_f16",
            "paged_attention_split_combine_f16")
    counts = serve_both(torch, label, model, params["int8"], lambda a: config("int8", "int8", a),
                        path, "graphs", FP16_TOKENS)
    check_fp16_route(label, counts)
    launches.update({k: counts[k] for k in path[:4]})
    gc.collect()
    torch.cuda.empty_cache()
    # Eager, the paths of G and E, and of H, on fp16.
    for label, q, kv, w8a8, path in (
            ("8B INT4 + FP8 KV fp16", "int4", "fp8", False,
             ("reshape_and_cache_fp8_f16", "ragged_paged_attention_fp8_mma_f16",
              "fused_decode_attention_fp8_split_f16", "quantized_matmul_int4_mma_f16")),
            ("8B INT8 W8A8 fp16", "int8", None, True, ("quantized_matmul_w8a8_mma_f16",))):
        saved = quant_kernels._W8A8
        quant_kernels._W8A8 = w8a8
        try:
            counts, _ = serve(torch, f"{label} ({FP16_8B_LAYERS} of 32 layers)", model,
                              params[q], config(q, kv), path, new_tokens=FP16_TOKENS)
        finally:
            quant_kernels._W8A8 = saved
        check_fp16_route(label, counts)
        launches.update({k: counts[k] for k in path})
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # Eager, the fp16 instantiations of D and E at a wide head dim: Phi-3-mini
    # over an INT8 and an e4m3 cache, on the same weights.
    name = FP16_WIDE_FAMILY
    model, params = family_model(torch, name, FP16_8B_LAYERS, torch.float16)
    for kv in KV8_DTYPES:
        path = tuple(f"{k}_f16" for k in wide_kv8_path(name, kv))
        label = (f"{name} {kv.upper()} KV fp16 ({FP16_8B_LAYERS} of "
                 f"{FAMILIES[name][0]['num_hidden_layers']} layers)")
        counts, _ = serve(torch, label, model, params, family_config(name, kv, "float16")(False),
                          path, new_tokens=FP16_TOKENS, prompt_lengths=PHI3_PROMPT_LENGTHS)
        check_fp16_route(label, counts)
        launches.update({f"{k}@{FP16_WIDE_DIM}": counts[k] for k in path[1:3]})
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(serve_fp16_w512(torch))
    return launches


def serve_fp16_w512(torch):
    """The fp16 instantiations at the width 512, eager then with graphs:
    the test-size Gemma-2 at head dim 512 (``WIDE_F32_MODELS``, 2 q heads
    over one kv head, a 16-key window on alternate layers, soft caps) in
    fp16 over an fp16, an INT8 and an e4m3 cache, tokens identical, every
    launch an fp16 kernel's. Returns the ragged and fused kernels' launches
    with graphs, keyed ``kernel@512``."""
    from atoma_infer_tpu_torch.models.registry import get_model_cls
    from atoma_infer_tpu_torch.models.weights import config_from_hf_dict
    from atoma_infer_tpu_torch.ops import paged_attention as pa

    # The traffic's widest keys take token ids up to 1,002 (widest_metas).
    cfg = config_from_hf_dict(dict(WIDE_F32_MODELS[W512], vocab_size=2048,
                                   max_position_embeddings=2048))
    model = get_model_cls(cfg.architecture)(cfg, dtype=torch.float16, device="cuda")
    params = model.init_params(torch.Generator(device=model.device).manual_seed(W512))
    q16 = torch.empty((1, 1, W512), dtype=torch.float16)
    launches = {}
    for kv in (None,) + KV8_DTYPES:
        kind = _KINDS[kv] and getattr(torch, _KINDS[kv])
        path = (pa.ragged_route(q16, kind).name, pa.fused_route(q16, kind).name)
        label = f"test-size Gemma-2 D=512 fp16 + {kv or 'fp16'} KV"
        counts = serve_both(
            torch, label, model, params,
            lambda a, kv=kv: bf16_config("tiny-gemma2-d512", BS, async_scheduling=a,
                                         dtype="float16", kv_cache_dtype=kv),
            path, "graphs", FP16_TOKENS)
        check_fp16_route(label, counts)
        launches.update({f"{k}@{W512}": counts[k] for k in path})
        gc.collect()
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------- phase 4: prefix caching
# 16 requests sharing a 1,536-byte prefix (96 blocks of 16), each with 32-128
# bytes of its own, 64 new tokens; the second 8 admitted once the first 8 have
# finished their prefill; and in the second wave the prefix alone, whose
# whole prompt is cached: its last token is recomputed and written again
# into the prefix's last block, which the other sequences share.
PREFIX_BYTES, PREFIX_WAVE, PREFIX_TOKENS = 1536, 8, 64
PREFIX_LAYERS_8B = 4


def prefix_prompts():
    import numpy as np

    rng = np.random.default_rng(15)

    def text(n):
        return bytes(rng.integers(32, 127, size=n, dtype=np.uint8)).decode("latin-1")

    prefix = text(PREFIX_BYTES)
    prompts = [prefix + text(int(rng.integers(32, 129))) for _ in range(2 * PREFIX_WAVE)]
    return prompts[:PREFIX_WAVE], prompts[PREFIX_WAVE:] + [prefix]


def prefix_config(name, caching, quantization=None, kv=None, pp=1):
    from atoma_infer_tpu_torch.config import (
        CacheConfig, EngineConfig, ModelConfig, SchedulerConfig, ValidationConfig,
    )

    return EngineConfig(
        model=ModelConfig(model_name=name, dtype="bfloat16", quantization=quantization,
                          kv_cache_dtype=kv, pipeline_parallel_size=pp),
        cache=CacheConfig(block_size=BS, hbm_memory_utilization=0.5, num_host_blocks_override=64,
                          enable_prefix_caching=caching),
        scheduler=SchedulerConfig(max_num_batched_tokens=256, max_num_sequences=64,
                                  max_model_len=2048, enable_chunked_prefill=True),
        validation=ValidationConfig(max_input_tokens=1800, max_total_tokens=2048),
    )


def drive_prefix(torch, label, service, waves, new_tokens):
    """Serve two waves of greedy requests (top 2 logprobs asked) on a
    started synchronous service: the second admitted once every request of
    the first has its first token. Returns (tokens, top logprobs, figures:
    prefill tokens computed, tokens computed at each request's admission,
    the second wave's times to first token, the mixed steps' walls, the
    prefix's last block before and after the second wave's whole-prefix
    request rewrote its last token, the launches)."""
    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.types import GenerateParameters, GenerateRequest

    engine, worker = service.engine, service.engine.worker
    # One cache engine, or (pipeline stages) none to snapshot.
    ce = getattr(worker, "cache_engine", None)
    figures = dict(prefill=0, admitted={}, ttft=[], mixed_ms=[])
    inner_execute, inner_step = worker.execute_model, engine.step

    def spy(inner):
        def schedule():
            metadata, outputs = inner()
            for m in metadata:
                if m.is_prompt:
                    figures["prefill"] += m.token_chunk_size
                    figures["admitted"].setdefault(
                        m.request_id, next(iter(m.seq_data.values())).get_num_computed_tokens())
            return metadata, outputs
        return schedule

    def execute(request):
        metas = request.sequence_groups_metadata
        t0 = time.monotonic()
        out = inner_execute(request)
        if any(m.is_prompt for m in metas) and not all(m.is_prompt for m in metas):
            figures["mixed_ms"].append((time.monotonic() - t0) * 1e3)
        return out

    held, state = [], dict(released=None, first={})

    def snapshot(block):
        return ([c[block].clone() for c in ce.kv_cache],
                [s[block].clone() for s in ce.kv_scales] if ce.kv_scales is not None else None)

    def step():
        wave1, wave2 = held[:len(waves[0])], held[len(waves[0]):]
        groups = wave1 + (wave2 if state["released"] is not None else [])
        now = time.monotonic()
        for g, *_ in groups:
            if g.request_id not in state["first"] and g.get_first_seq().get_output_len() >= 1:
                state["first"][g.request_id] = now
        if state["released"] is None and all(g.request_id in state["first"] for g, *_ in wave1):
            if ce is not None:
                seq = wave1[0][0].get_first_seq()
                block = service.block_manager.get_block_table_ids(seq.seq_id)[
                    PREFIX_BYTES // BS - 1]
                figures["block"], figures["before"] = block, snapshot(block)
            state["released"] = time.monotonic()
            for args in wave2:
                engine.add_request(*args)
        probe = wave2[-1][0].request_id if wave2 else None
        if ce is not None and probe in state["first"] and "after" not in figures:
            torch.cuda.synchronize()
            figures["after"] = snapshot(figures["block"])
        return inner_step()

    def request(i, prompt):
        return GenerateRequest(request_id=f"{label}-{i}", inputs=prompt,
                               parameters=GenerateParameters(max_new_tokens=new_tokens,
                                                             do_sample=False, top_n_tokens=2))

    async def run():
        task = asyncio.create_task(engine.run())
        engine.add_request = lambda *args: held.append(args)
        futs = [await service.handle_request(request(i, p))
                for i, p in enumerate(waves[0] + waves[1])]
        del engine.add_request
        for scheduler in engine.schedulers:
            scheduler.schedule = spy(scheduler.schedule)
        worker.execute_model, engine.step = execute, step
        for k in cuda_lib.KERNELS.values():
            k.launches = 0
        t0 = time.monotonic()
        for args in held[:len(waves[0])]:
            engine.add_request(*args)
        results = await asyncio.wait_for(asyncio.gather(*futs), timeout=600)
        torch.cuda.synchronize()
        figures["seconds"] = time.monotonic() - t0
        figures["launches"] = {n: k.launches for n, k in cuda_lib.KERNELS.items()}
        service.stop()
        task.cancel()
        return results

    results = asyncio.run(run())
    wave2 = {args[0].request_id for args in held[len(waves[0]):]}
    figures["ttft"] = [(state["first"][r] - state["released"]) * 1e3 for r in wave2
                       if r in state["first"]]
    for r in results:
        if len(r.outputs[0].token_ids) != new_tokens:
            raise AssertionError(f"{label} {r.request_id}: {len(r.outputs[0].token_ids)} tokens")
    pool = service.config.cache.num_device_blocks
    if service.block_manager.get_num_free_device_blocks() != pool:
        raise AssertionError(f"service {label}: KV blocks leaked")
    return ([tuple(r.outputs[0].token_ids) for r in results],
            [r.outputs[0].top_logprobs for r in results], figures)


def near_tie_compare(label, got, want, top):
    """Greedy tokens of one run against a reference's: identical up to a
    first difference where the reference's top two logprobs are closer than
    SPEC_TIE_TOL. Returns each request's common prefix."""
    prefixes = []
    for i, (g, w) in enumerate(zip(got, want)):
        n = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        if n < min(len(g), len(w)):
            alts = top[i][n]
            gap = alts[0][1] - alts[1][1]
            if not gap < SPEC_TIE_TOL:
                raise AssertionError(f"{label}: request {i} differs at token {n} ({g[n]} against "
                                     f"{w[n]}), top two logprobs {gap:.4f} apart (near-tie tol "
                                     f"{SPEC_TIE_TOL})")
        prefixes.append(n)
    return prefixes


def prefix_service(torch, label, model, params, make_config, path, pp=False):
    """One model served with prefix caching and without (the reference):
    tokens within the near-tie rule, fewer prefill tokens with caching;
    prints the prefill tokens computed, the second wave's time to first
    token (p50), the mixed-step wall (p50) of each run, and the rewrite of
    the shared block's last slot. With ``pp``, caching again at
    PP_STAGES stages (both on this card, each with its stream; one pool
    for the cohorts): the same rule against the reference."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService
    from atoma_infer_tpu_torch.entrypoints.offline import ByteTokenizer

    waves = prefix_prompts()
    runs = {}
    for caching in (False, True, "eager") + (("pp",) if pp else ()):
        config = make_config(caching is not False) if caching != "pp" \
            else make_config(True, PP_STAGES)
        service = LlmService.start(config, model=model, params=params,
                                   tokenizer=ByteTokenizer(model.config.vocab_size),
                                   device=model.device)
        if not service.native_core:
            raise AssertionError(f"service {label}: not on the native block manager")
        worker = service.engine.worker
        if caching == "eager":
            worker.graphs = None  # the same service with every step eager
        elif caching is True:
            replays = worker.graphs.replays
        runs[caching] = drive_prefix(torch, f"{label} caching={caching}", service, waves,
                                     PREFIX_TOKENS)
        if caching is True:
            runs[caching][2]["replays"] = worker.graphs.replays - replays
            runs[caching][2]["graphs"] = len(worker.graphs.graphs)
        for name in path:
            if not runs[caching][2]["launches"][name]:
                raise AssertionError(f"{label}: {name} was not launched")
        del service
        gc.collect()
        torch.cuda.empty_cache()
    (got, _, fig), (want, top, ref) = runs[True], runs[False]
    prefixes = near_tie_compare(f"service {label} with prefix caching", got, want, top)
    if runs["eager"][0] != got:
        raise AssertionError(f"service {label}: with prefix caching, tokens differ between the "
                             "eager run and the run with graphs")
    log(f"service {label} with prefix caching: tokens identical eager and with graphs (every "
        f"request, both waves); {fig['replays']} replays of {fig['graphs']} graphs")
    names = {False: "off", True: "on", "eager": "on, eager", "pp": f"on, pp={PP_STAGES}"}
    for caching, (_, _, f) in runs.items():
        mixed = (f"mixed-step wall p50 {percentile(f['mixed_ms'], 0.5):.2f} ms, p99 "
                 f"{percentile(f['mixed_ms'], 0.99):.2f} ms over {len(f['mixed_ms'])} steps"
                 if f["mixed_ms"] else "mixed-step wall not measured")
        log(f"service {label} prefix caching {names[caching]}: prefill tokens "
            f"computed {f['prefill']}, second wave's time to first token p50 "
            f"{percentile(f['ttft'], 0.5):.1f} ms, {mixed}, {f['seconds']:.3f} s in all")
    if pp:
        staged = near_tie_compare(f"service {label} with prefix caching at pp={PP_STAGES}",
                                  runs["pp"][0], want, top)
        log(f"service {label} with prefix caching at pp={PP_STAGES}: common prefix with the "
            f"run without caching at pp=1, by request: {staged} of {PREFIX_TOKENS}; tokens "
            f"computed at admission {sorted(runs['pp'][2]['admitted'].values())}")
    cached = {r.split("-")[-1]: n for r, n in fig["admitted"].items()}
    log(f"service {label}: tokens computed at admission with caching, by request: {cached}; "
        f"common prefix with the run without caching, by request: {prefixes} of "
        f"{PREFIX_TOKENS} (a difference only where the reference's top two logprobs are "
        f"within {SPEC_TIE_TOL})")
    if not fig["prefill"] < ref["prefill"] - PREFIX_BYTES:
        raise AssertionError(f"{label}: caching computed {fig['prefill']} prefill tokens against "
                             f"{ref['prefill']}")
    (k0, s0), (k1, s1) = fig["before"], fig["after"]
    dk = max((a.float() - b.float()).abs().max().item() for a, b in zip(k0, k1))
    ds = (max((a.float() - b.float()).abs().max().item() for a, b in zip(s0, s1))
          if s0 is not None else None)
    changed = sum(int(not torch.equal(a.view(torch.uint8), b.view(torch.uint8)))
                  for a, b in zip(k0, k1))
    log(f"service {label}: the whole-prefix request's rewrite of the shared block {fig['block']}'s "
        f"last slot: K/V max |Δ| {dk:.3e} over {len(k0)} layers ({changed} layers' bytes "
        f"changed)" + ("" if ds is None else f", INT8 scales max |Δ| {ds:.3e}"))


def run_prefix_cache(torch):
    """Prefix caching on the card: the 1B bf16 service (16 layers; also at
    PP_STAGES stages with caching), then the 8B INT8 + INT8 KV one
    (PREFIX_LAYERS_8B of 32 layers), each with caching and without, on the
    native block manager (``prefix_service``)."""
    model, params = llama_1b_model(torch)
    prefix_service(torch, "1B bf16", model, params,
                   lambda c, pp=1: prefix_config("llama-3.2-1b-random", c, pp=pp), SERVICE_PATH,
                   pp=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    model, params = llama_8b_layers(torch, torch.bfloat16, PREFIX_LAYERS_8B)
    prefix_service(torch, f"8B INT8 + INT8 KV ({PREFIX_LAYERS_8B} of 32 layers)", model,
                   params["int8"], lambda c: prefix_config("llama-3.1-8b-random", c, "int8",
                                                           "int8"),
                   kv8_path("int8") + ("quantized_matmul_int8_mma",))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------- the block managers' host time
SCHEDULE_SEQS = (64, 256)


def schedule_host_ms(native, num_seqs, iters=50):
    """Host ms of one ``Scheduler.schedule()`` in steady decode over
    ``num_seqs`` sequences (64-token prompts prefilled first, a token
    appended to each after every pass), on the native or the Python block
    manager."""
    from atoma_infer_tpu_torch.config import CacheConfig, SchedulerConfig
    from atoma_infer_tpu_torch.core.scheduler import Scheduler
    from atoma_infer_tpu_torch.native.block_manager import NativeBlockSpaceManager
    from atoma_infer_tpu_torch.sampling_params import (
        NextTokenChooserParameters, StoppingCriteriaParameters,
    )
    from atoma_infer_tpu_torch.sequence import Sequence, SequenceGroup

    blocks = num_seqs * 16
    cache = CacheConfig.new_from_blocks(BS, blocks, 0)
    sched = Scheduler(
        SchedulerConfig(max_num_batched_tokens=4096, max_num_sequences=num_seqs,
                        max_model_len=2048, enable_chunked_prefill=True),
        cache, block_manager=NativeBlockSpaceManager(BS, blocks, 0) if native else None)
    groups = {}
    for i in range(num_seqs):
        g = SequenceGroup(request_id=f"r{i}", sequences=[Sequence(i, "", [5] * 64, BS)],
                          next_token_chooser_params=NextTokenChooserParameters(),
                          stopping_criteria=StoppingCriteriaParameters(max_new_tokens=10**6))
        groups[g.request_id] = g
        sched.add_sequence_group(g)
    times = []
    for it in range(iters + 8):
        t0 = time.perf_counter()
        metadata, _ = sched.schedule()
        dt = time.perf_counter() - t0
        decode = all(not m.is_prompt for m in metadata) and len(metadata) == num_seqs
        for m in metadata:
            g = groups[m.request_id]
            g.update_num_computed_tokens(m.token_chunk_size)
            if m.do_sample:
                g.get_first_seq().append_token_id(7, 0.0)
        if decode:
            times.append(dt * 1e3)
    times = times[-iters:]
    return percentile(times, 0.5), len(times)


def time_schedulers(torch):
    """The host ms of ``schedule()`` per block manager at SCHEDULE_SEQS
    sequences, on this machine's host."""
    for n in SCHEDULE_SEQS:
        figures = {kind: schedule_host_ms(kind == "native", n) for kind in ("native", "python")}
        log(f"scheduler host time at {n} sequences in steady decode: " + ", ".join(
            f"{kind} block manager {ms:.3f} ms p50 over {k} passes"
            for kind, (ms, k) in figures.items()))


def track_block_managers():
    """Wrap ``LlmService.start`` so that every service the smoke starts (in
    this process) reports its block manager: the run fails when a service
    that did not ask for the Python one (``use_native_core`` off, or
    speculative decoding, which needs it) runs without the native core.
    Returns the list the services are recorded in."""
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    start = LlmService.start.__func__
    seen = []

    def checked(cls, config, **kw):
        service = start(cls, config, **kw)
        s = config.scheduler
        wants_native = s.use_native_core and not s.num_speculative_tokens
        kind = "native" if service.native_core else "python"
        seen.append((config.model.model_name, config.model.dtype, kind, wants_native))
        if wants_native and not service.native_core:
            raise AssertionError(f"service {config.model.model_name} ({config.model.dtype}) runs "
                                 "without the native block manager")
        return service

    LlmService.start = classmethod(checked)
    return seen


def report_block_managers(seen):
    native = sum(kind == "native" for _, _, kind, _ in seen)
    asked = sorted({f"{name} {dtype}" for name, dtype, kind, _ in seen if kind == "python"})
    log(f"block managers: {len(seen)} services started in this process, {native} on the native "
        f"core, {len(seen) - native} on the Python one, each of those asking for it "
        f"(speculative decoding): {asked}")

CP_RANKS = 2
# Llama-3.1-8B's attention layer: 32 q heads over 8 kv heads of 128, bf16,
# blocks of 32; 4 decode rows of 4,096-8,192 keys, their pages shuffled over
# the ranks.
CP_SHAPES = dict(hq=32, hk=8, d=128, bs=32)
CP_KEYS = (4096, 5461, 6827, 8192)
CP_ITERS = 10


def cp_batch(torch, device):
    """The CP phase's decode batch, drawn from a seed on the CPU then moved
    to ``device``: (q, k_new, v_new, the whole cache, metadata with global
    page ids)."""
    from atoma_infer_tpu_torch.ops.attention import AttentionMetadata

    hq, hk, d, bs = (CP_SHAPES[k] for k in ("hq", "hk", "d", "bs"))
    gen = torch.Generator().manual_seed(14)
    pages = [-(-n // bs) for n in CP_KEYS]
    total = -(-sum(pages) // CP_RANKS) * CP_RANKS
    order = torch.randperm(total, generator=gen).tolist()
    tables = torch.zeros((len(CP_KEYS), max(pages)), dtype=torch.int32)
    slots, used = [], 0
    for i, (n, p) in enumerate(zip(CP_KEYS, pages)):
        tables[i, :p] = torch.tensor(order[used:used + p], dtype=torch.int32)
        used += p
        slots.append(int(tables[i, (n - 1) // bs]) * bs + (n - 1) % bs)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)

    S = len(CP_KEYS)
    meta = AttentionMetadata(
        slot_mapping=torch.tensor(slots, dtype=torch.int32, device=device),
        block_tables=tables.to(device),
        seq_lens=torch.tensor(CP_KEYS, dtype=torch.int32, device=device),
        query_start_loc=torch.arange(S + 1, dtype=torch.int32, device=device),
        num_seqs=torch.tensor([S], dtype=torch.int32, device=device),
        block_size=bs, decode_only=True, max_q_len=1)
    return (randn(S, hq, d), randn(S, hk, d), randn(S, hk, d),
            randn(total, bs, 2 * hk * d), meta)


def cp_rank_main(rank, init, out_path):
    """One CP rank on this card (spawned): its page range of the batch, the
    layer once (output and cache kept), then CP_ITERS timed runs of the
    layer and of the combine alone; the launches of the first run."""
    import torch

    from atoma_infer_tpu_torch.ops import cuda_lib
    from atoma_infer_tpu_torch.ops.reference import ragged_paged_attention_plain_partial
    from atoma_infer_tpu_torch.parallel.context_parallel import (
        combine_partials, cp_decode_attention_layer,
    )
    from atoma_infer_tpu_torch.parallel.distributed import init_distributed
    from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    group = init_distributed(init, CP_RANKS, rank, device=dev, local_ranks=CP_RANKS,
                             local_devices=1)
    q, k, v, cache, meta = cp_batch(torch, dev)
    pages = cache.shape[0] // CP_RANKS
    local = cache[rank * pages:(rank + 1) * pages].clone()
    del cache
    scale = CP_SHAPES["d"] ** -0.5
    for kernel in cuda_lib.KERNELS.values():
        kernel.launches = 0
    out = cp_decode_attention_layer(q, local, k, v, meta, group, scale=scale)
    launches = {n: kr.launches for n, kr in cuda_lib.KERNELS.items() if kr.launches}
    result = dict(out=out.float().cpu(), cache=local.cpu(), launches=launches)

    def timed(fn):
        times = []
        for _ in range(CP_ITERS):
            group.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    result["layer_ms"] = timed(lambda: cp_decode_attention_layer(q, local, k, v, meta, group,
                                                                  scale=scale))
    lo = rank * pages
    mine = (meta.block_tables >= lo) & (meta.block_tables < lo + pages)
    local_bt = torch.where(mine, meta.block_tables - lo, torch.zeros_like(meta.block_tables))
    partial = ragged_paged_attention_plain_partial(
        q, *kv_cache_view(local, CP_SHAPES["hk"], CP_SHAPES["d"]), local_bt, meta.seq_lens,
        meta.query_start_loc, scale=scale, block_size=meta.block_size, page_valid=mine)
    result["partial_ms"] = timed(lambda: ragged_paged_attention_plain_partial(
        q, *kv_cache_view(local, CP_SHAPES["hk"], CP_SHAPES["d"]), local_bt, meta.seq_lens,
        meta.query_start_loc, scale=scale, block_size=meta.block_size, page_valid=mine))
    result["combine_ms"] = timed(lambda: combine_partials(*partial, group))
    torch.save(result, out_path)


CP_TOL = ATTN_TOL["bfloat16"]


def run_cp_layer(torch):
    """Context-parallel decode attention (``parallel/context_parallel.py``)
    over CP_RANKS ranks spawned on this card (gloo through host memory), at
    the 8B layer's shapes: every rank's output against the plain full
    attention on the card within CP_TOL (bf16 outputs of f32 sums taken in
    another order), every rank's cache pages bit for bit against the
    one-rank write (kernel C), the layer's and the combine's times."""
    import tempfile

    from atoma_infer_tpu_torch.ops.kv_cache import kv_cache_view, write_kv_cache
    from atoma_infer_tpu_torch.ops.reference import ragged_paged_attention_plain

    q, k, v, cache, meta = cp_batch(torch, torch.device("cuda", 0))
    write_kv_cache(cache, k, v, meta.slot_mapping)
    want = ragged_paged_attention_plain(
        q, *kv_cache_view(cache, CP_SHAPES["hk"], CP_SHAPES["d"]), meta.block_tables,
        meta.seq_lens, meta.query_start_loc, scale=CP_SHAPES["d"] ** -0.5,
        block_size=meta.block_size).float().cpu()
    cache = cache.cpu()
    tmp = tempfile.mkdtemp(prefix="atoma-cp-")
    init = f"file://{tmp}/rdzv"
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(CP_RANKS)]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=cp_rank_main, args=(r, init, outs[r])) for r in range(CP_RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    failed = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if failed:
        raise AssertionError(f"context-parallel ranks failed: {failed}")
    pages = cache.shape[0] // CP_RANKS
    for r, path in enumerate(outs):
        got = torch.load(path)
        err = (got["out"] - want).abs().max().item()
        if not torch.allclose(got["out"], want, atol=CP_TOL, rtol=CP_TOL):
            raise AssertionError(f"context-parallel rank {r}: max |Δ| {err:.3e} against the "
                                 f"plain full attention (tol {CP_TOL})")
        if not torch.equal(got["cache"].view(torch.int16),
                           cache[r * pages:(r + 1) * pages].view(torch.int16)):
            raise AssertionError(f"context-parallel rank {r}: its pages differ from the "
                                 "one-rank write")
        if not got["launches"].get("reshape_and_cache"):
            raise AssertionError(f"context-parallel rank {r}: kernel C was not launched")
        log(f"context parallel, rank {r} of {CP_RANKS} ({TP_LABEL}): rows of {CP_KEYS} keys "
            f"(Hq 32, Hk 8, D 128, bf16, blocks of 32), {pages} of {cache.shape[0]} pages; "
            f"max |Δ| {err:.3e} against the plain full attention (tol {CP_TOL}); cache pages "
            f"bit-exact; launches {got['launches']}; layer {got['layer_ms']:.3f} ms p50, its "
            f"plain partial {got['partial_ms']:.3f} ms, the combine (max, then 2 sums) "
            f"{got['combine_ms']:.3f} ms, over {CP_ITERS} runs")


def dataclass_replace(config, **model_fields):
    """``config`` with its ``model`` section's fields replaced."""
    import dataclasses

    return dataclasses.replace(config, model=dataclasses.replace(config.model, **model_fields))


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "atoma_infer_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.monotonic()
    log(card_line())
    managers = track_block_managers()
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on "
        f"{torch.cuda.get_device_name(0)}")
    # Every kernel module registers its kernels on import.
    from atoma_infer_tpu_torch.ops import cuda_lib, kv_write, paged_attention, quant_kernels  # noqa: F401
    from atoma_infer_tpu_torch.tools import w8a8_probe  # noqa: F401

    t0 = time.monotonic()

    def phase(fn):
        out = fn(torch)
        log(f"[{time.monotonic() - t0:.0f} s] {fn.__name__} done")
        return out

    build_kernels()
    phase(check_kernel_variants)
    rows = phase(check_kernels)
    phase(check_quant_variants)
    rows.update(phase(check_quant_kernels))
    phase(check_kv8_variants)
    rows.update(phase(check_kv8_kernels))
    phase(check_fp16_variants)
    rows.update(phase(check_fp16_kernels))
    phase(check_prefill_chunk)
    phase(check_gqa_block_kernels)
    phase(check_group_variants)
    group_rows = phase(check_group_kernels)
    wide_rows = phase(check_wide_head_kernels)
    phase(check_head_dim_variants)
    head_dim_rows = phase(check_head_dim_kernels)
    verify_rows = phase(check_verify_kernels)
    tp_rows = phase(check_tp_kernels)
    phase(check_nccl_group)
    rows.update(phase(check_probe_kernels))
    phase(check_model)
    phase(check_quant_model)
    phase(check_kv8_model)
    phase(check_family_models)
    phase(check_verify_step)
    # The f32 services are the CUDA-core kernels' path: F and G's CUDA-core
    # route and the CUDA-core ragged kernels (A, D, E on f32 queries).
    launches_cuda_cores = phase(check_service_parity)
    launches_cuda_cores.update(phase(check_quant_service_parity))
    launches_cuda_cores.update(phase(check_kv8_service_parity))
    launches_cuda_cores.update(phase(check_wide_f32_service_parity))
    phase(check_ladder_parity)
    phase(check_spec_service_parity)
    # The profiler's first start sets up device tracing, which takes
    # seconds: do it here, outside the services' runs.
    profile_device(torch, lambda: torch.ones(1, device="cuda") + 1)
    launches = phase(run_service)
    gc.collect()  # the finished service's KV pool
    torch.cuda.empty_cache()
    phase(run_http_server)
    gc.collect()
    torch.cuda.empty_cache()
    spec_launches = phase(run_spec_service)
    gc.collect()
    torch.cuda.empty_cache()
    phase(run_shape_services)
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase(run_quant_services))
    gc.collect()
    torch.cuda.empty_cache()
    launches.update(phase(run_family_services))
    gc.collect()
    torch.cuda.empty_cache()
    # The group rows' launches: Mistral-Large-2's and Llama-3.1-405B's
    # services with graphs.
    launches.update(phase(run_group_services))
    for key in group_rows:
        if not launches.get(key):
            raise AssertionError(f"{key.split('@')[0]} was not launched on its group's service")
    gc.collect()
    torch.cuda.empty_cache()
    # The head-dim rows' launches: the services at h2o-danube-1.8b's,
    # OpenLLaMA-3B's and h2o-danube3-4b's head dims with graphs (the merge
    # where their plans split), the G = 256 service, the ALiBi service at
    # head dim 63, and the width 512's (Gemma-2-9B's and Llama-3.1-8B's
    # widths), whose launches are its wide rows'.
    launches.update(phase(run_head_dim_services))
    for key in head_dim_rows:
        if not launches.get(key) and not key.startswith("paged_attention_split_combine"):
            raise AssertionError(f"{key.split('@')[0]} was not launched on the "
                                 f"{key.split('@hd ')[1]} service")
    gc.collect()
    torch.cuda.empty_cache()
    # The TP rows' launches: the 8B INT8 + INT8 KV service at tp = 2.
    tp_launches = phase(run_tp_services)
    for key in tp_rows:
        launches[key] = tp_launches[key.split("@")[0]]
        if not launches[key]:
            raise AssertionError(f"{key.split('@')[0]} was not launched on the TP service")
    gc.collect()
    torch.cuda.empty_cache()
    # The PP rows' launches: the 8B INT8 + INT8 KV service at pp = 2.
    pp_launches = phase(run_pp_services)
    for name in PP_PATH:
        launches[f"{name}@pp"] = pp_launches[name]
    gc.collect()
    torch.cuda.empty_cache()
    phase(run_cp_layer)
    launches.update(phase(run_fp16_services))
    gc.collect()
    torch.cuda.empty_cache()
    phase(run_prefix_cache)
    phase(time_schedulers)
    report_block_managers(managers)
    launches.update(phase(run_probe))
    launches.update(launches_cuda_cores)
    # The verify rows' launches: the 1B and the 8B spec services' runs with
    # graphs (the merge runs in both).
    for key, n in spec_launches.items():
        launches[key] = launches.get(key, 0) + n
    for key in verify_rows:
        if not launches.get(key):
            raise AssertionError(f"{key.split('@')[0]} was not launched on a spec service")
    phase(run_tools)
    phase(run_real_model_check)

    line = []
    # Every kernel at its main path's shapes; then A, B, C, D, E and the
    # merge at Phi-3-mini's and Gemma-2-9B's head dims, and at Gemma-2-9B's
    # widths with head dim 512, their launches from those families' services
    # (the f32 kernels' from the f32 test-size services, the fp16 ones at
    # 512 from the test-size fp16 service); the 1-byte caches' wide kernels
    # and every width-512 kernel have only these rows.
    named = [(name, name, rows[name]) for name in cuda_lib.KERNELS if name in rows]
    # The rows at 2,048 have no service (logged by check_wide_head_kernels).
    wide_rows = {key: r for key, r in wide_rows.items()
                 if int(key.split("@")[1]) in WIDE_HEAD_DIMS + (W512, PAST_512_LINE_DIM)}
    named += [(key, f"{key.split('@')[0]} (D={key.split('@')[1]})", r)
              for key, r in wide_rows.items()]
    rowless = [k for k in cuda_lib.KERNELS if k not in rows
               and not any(key.split("@")[0] == k for key in wide_rows)]
    if rowless:
        raise AssertionError(f"kernels without a row in the kernels line: {rowless}")
    # Every wide row's kernel ran on its head dim's service; Phi-3-mini's
    # plans never split, so its merge has no launch there (WIDE_HEAD_SHAPES).
    for key in wide_rows:
        if not launches.get(key) and key != "paged_attention_split_combine@96":
            raise AssertionError(f"{key.split('@')[0]} was not launched on a D="
                                 f"{key.split('@')[1]} service")
    named += [(key, f"{key.split('@')[0]} (verify rows)", r) for key, r in verify_rows.items()]
    named += [(key, f"{key.split('@group ')[0]} ({key.split('@group ')[1]} shapes)", r)
              for key, r in group_rows.items()]
    named += [(key, f"{key.split('@hd ')[0]} ({key.split('@hd ')[1]} shapes, D="
               f"{next(s[3] for s in HEAD_DIM_SHAPES if s[0] == key.split('@hd ')[1])})", r)
              for key, r in head_dim_rows.items()]
    named += [(key, f"{key.split('@')[0]} ({key.split('@tp ')[1]} per-rank shapes"
               + (", scales_new)" if "int8" in key and "matmul" not in key else ")"), r)
              for key, r in tp_rows.items()]
    # The PP path's launches beside the times of each kernel's own row.
    named += [(f"{name}@pp", f"{name} (8B INT8 + INT8 KV, {PP_LAYERS} layers pp={PP_STAGES} "
               "path; timed as its row)", rows[name]) for name in PP_PATH]
    for key, name, r in named:
        kernel = cuda_lib.KERNELS[key.split("@")[0]]
        line.append(dict(
            name=name, route="cuda", source=f"atoma_infer_tpu_torch/csrc/{kernel.source}",
            replaces=kernel.replaces, launches=launches[key], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    log(f"smoke wall {time.monotonic() - t_start:.0f} s, the kernels' build included")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
