"""Attention-kernel microbenchmark: effective KV-cache read bandwidth.

Counterpart of ``tools/attn_bench.py``. Times one layer's pure-decode
attention step alone, the write of each sequence's new K/V row and the
attention over its pages, through ``ops/attention.py``
``paged_attention_layer``: on the card the split fused kernels B, D and E
(``fused_decode_attention{,_int8,_fp8}_split``, then the merge of split rows
where the plan splits), or past 16 q heads per kv head the write and the
ragged kernel (``ops/paged_attention.py`` ``decode_route``). Llama-3.2-1B
attention shapes (32 q heads over 8 kv heads of 64), 64 sequences, blocks of
32, a pool of ``seqs·P + 8`` pages (``P = max_ctx // block_size + 1`` a
sequence), at contexts of 512 to 32,640 keys. Each line gives the effective
KV bandwidth (the cache bytes a step must stream, over its time) against
the H100's 3.35 TB/s, the least time for the step's work
(``tools/roofline.py``), the route and the KV splits its plan took.

Bytes are counted in the port's cache layout: ``2·Hk·D`` elements a token,
and over an INT8 cache 4 more bytes a token for its bf16 (K, V) scales.

Timing on the card: the ``--inner-steps`` steps of one round are captured
as one CUDA graph over static metadata; before each of ``--outer-steps``
replays the round's slots and lengths are copied in, as the engine replays
decode steps, and CUDA events time each replay alone. A step's pages must
come from device memory, as a layer of a real step finds them, so the steps
of a round rotate among R disjoint page sets of the pool: step i reads the
tables with their columns rotated by ``(i mod R)`` times the pages a step
touches, R = min(inner steps, P ÷ those pages) (``page_sets`` on each line).
At 512 keys a bf16 step reads 67.1 MB and R is 8, so 537 MB pass between
two reads of a page; at 32,640 keys R is 1 and a step reads 4.28 GB. On the
CPU (``--cpu``) the plain versions run the same steps at a tiny size,
eagerly, timed on the host's clock (no device rates).

After the last context two more steps are held against the plain version
(``fused_decode_attention_plain``) on the same pages: one over all the
sequences on the timed rows' tables, so that it takes their plan
(``plain_check``), and one over the first 8, whose plan splits and so runs
the merge (``merge_check``). Each holds the output within ``PLAIN_TOL`` of
the largest output (a limit on the scale of what is compared: at 32,640
keys an output is about 0.01), the K/V rows it wrote byte for byte (INT8
rows within one step), and shows that the limit rejects two planted faults
of the same step: the output scaled by 1.5 (a wrong normaliser) and the
plain version over the first three quarters of each row's keys.

Usage:
    python -m atoma_infer_tpu_torch.tools.attn_bench             # the card
    python -m atoma_infer_tpu_torch.tools.attn_bench --int8      # INT8 KV (D)
    python -m atoma_infer_tpu_torch.tools.attn_bench --fp8       # e4m3 KV (E)
    python -m atoma_infer_tpu_torch.tools.attn_bench --cpu       # tiny, plain versions
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops import paged_attention as pa
from ..ops.attention import AttentionMetadata, paged_attention_layer
from ..ops.kv_cache import alloc_kv_scales
from ..utils.device import resolve_device
from . import decode_harness as dh
from . import roofline

CARD_HEADS = (32, 8, 64)  # Llama-3.2-1B: (q heads, kv heads, head dim)
CPU_HEADS = (8, 4, 32)
# The JAX tool's --cpu sizes: (seqs, max_ctx, ctxs, inner = outer steps).
CPU_SIZES = (4, 256, (64, 192), 2)
CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "e4m3": torch.float8_e4m3fn}
# An INT8 cache's two bf16 scales a token ([pages, block_size, 2]).
SCALE_BYTES = 4
# The INT8 pool's scales, as the JAX tool fills them.
INT8_SCALE = 0.01
# The steps held against the plain version: bf16 queries, one rounding of
# the output to bf16 and f32 sums in another order. |got - want| at most
# PLAIN_TOL times the largest |want|, about 2.5 bf16 units of the largest
# output: the outputs shrink as rows grow (a softmax over N keys averages
# about N/e of them), so an absolute limit set at 2,047 keys would pass a
# wrong kernel at 32,640.
PLAIN_TOL = 2e-2
CHECK_SEQS = 8
# Planted faults the limit must reject: the output scaled (a wrong
# normaliser), and attention over only the first part of each row's keys.
FAULT_SCALE = 1.5
FAULT_KEPT = 0.75
_ML_DTYPES = {"bfloat16": (np.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def to_tensor(a, device) -> torch.Tensor:
    """A tensor, or a numpy array (bf16 and e4m3 as ``ml_dtypes`` hands them
    over, as JAX's draws come), on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name in _ML_DTYPES:
        view, dtype = _ML_DTYPES[a.dtype.name]
        return torch.from_numpy(a.view(view).copy()).view(dtype).to(device)
    return torch.from_numpy(a.copy()).to(device)


def kv_bytes(seqs: int, ctx: int, row: int, kind: str) -> int:
    """The cache bytes a step over ``ctx`` keys must read: ``row`` elements
    a token in the cache's dtype, plus an INT8 cache's scales."""
    itemsize = 2 if kind == "bf16" else 1
    return seqs * ctx * (row * itemsize + (SCALE_BYTES if kind == "int8" else 0))


def step_bound(seqs: int, kv_lens: Sequence[int], heads: Tuple[int, int, int],
               kind: str) -> Tuple[float, str]:
    """The least time (ms, what bounds it) of a step, averaged over steps
    whose new token sits at each of ``kv_lens``: ``roofline.attention_work``
    of the fused step (bf16 queries and new rows, the cache's bytes and
    scales) over the card's peaks."""
    hq, hk, d = heads
    nbytes = flops = 0
    for kv_len in kv_lens:
        b, f = roofline.attention_work(
            [(1, kv_len + 1)] * seqs, None, 2, fused=True, hq=hq, hk=hk, d=d,
            kv_elt=2 if kind == "bf16" else 1, slot_extra=SCALE_BYTES if kind == "int8" else 0)
        nbytes, flops = nbytes + b, flops + f
    n = len(kv_lens)
    return roofline.bound(nbytes / n, flops / n, "bfloat16")


def page_tables(seqs: int, pages: int, contiguous: bool,
                rng: np.random.Generator) -> Tuple[int, np.ndarray]:
    """(pages in the pool, [seqs, pages] int32 tables): distinct random
    pages from 1 (``decode_harness.page_tables``), or each sequence's pages
    in order (the JAX tool's two layouts), 8 pages to spare."""
    if contiguous:
        return seqs * pages + 8, np.arange(1, seqs * pages + 1, dtype=np.int32).reshape(
            seqs, pages)
    return dh.page_tables(rng, seqs, pages)


def draw_pool(kind: str, num_blocks: int, block_size: int, row: int,
              generator: torch.Generator) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The pool (and an INT8 pool's scales) drawn on the generator's device:
    random int8 rows with scales of ``INT8_SCALE``, or standard normal rows
    in bf16 or e4m3."""
    shape, dev = (num_blocks, block_size, row), generator.device
    if kind == "int8":
        kv = torch.randint(-127, 128, shape, generator=generator, device=dev, dtype=torch.int8)
        return kv, alloc_kv_scales(num_blocks, block_size, dev).fill_(INT8_SCALE)
    kv = torch.randn(shape, generator=generator, device=dev, dtype=torch.bfloat16)
    return kv.to(CACHE_DTYPES[kind]), None


class AttnBench:
    """One pool and its tables; :meth:`run` times the steps at a context."""

    def __init__(self, kv_cache, kv_scales, tables, *, device, block_size: int,
                 heads: Tuple[int, int, int], inner: int, outer: int):
        self.device = torch.device(device)
        self.kv_cache = to_tensor(kv_cache, self.device)
        self.kv_scales = None if kv_scales is None else to_tensor(kv_scales, self.device)
        self.tables = np.asarray(tables, dtype=np.int32)
        self.block_size, self.heads = block_size, heads
        self.inner, self.outer = inner, outer
        self.scale = heads[2] ** -0.5
        self.kind = next(k for k, v in CACHE_DTYPES.items() if v == self.kv_cache.dtype)

    def page_sets(self, ctx: int) -> Tuple[int, int]:
        """(R, pages a step touches): the disjoint page sets a round's steps
        rotate among at ``ctx`` (the pages up to the checks' last position,
        ``ctx + outer + 2``)."""
        pages = self.tables.shape[1]
        touched = (ctx + self.outer + 2) // self.block_size + 1
        if touched > pages:
            raise ValueError(f"attn_bench: ctx {ctx} + {self.outer} steps pass the tables' "
                             f"{pages * self.block_size} keys")
        return max(1, min(self.inner, pages // touched)), touched

    def _round_inputs(self, tables: np.ndarray, ctx: int) -> np.ndarray:
        """[outer + 1, inner + 1, S] int32: each round's slots a step, then
        its sequence lengths (round o: the new token at position ctx + o)."""
        S, bs = self.tables.shape[0], self.block_size
        rounds = np.empty((self.outer + 1, self.inner + 1, S), dtype=np.int32)
        for o in range(self.outer + 1):
            kv_len = ctx + o
            for i in range(self.inner):
                page = tables[i % len(tables)][np.arange(S), kv_len // bs]
                rounds[o, i] = page * bs + kv_len % bs
            rounds[o, self.inner] = kv_len + 1
        return rounds

    @torch.inference_mode()
    def run(self, ctx: int, q: torch.Tensor, kn: torch.Tensor) -> Dict[str, Any]:
        """Round 0 eagerly, then ``outer`` timed rounds of ``inner`` steps
        (on the card one graph replay a round); ``q`` [S, Hq, D] and ``kn``
        [S, Hk, D] (the new K and V rows) in bf16. Returns the last step's
        output ``out``, each round's ms (``replay_ms``, the card) or the
        rounds' host seconds (``host_s``, the CPU), the page sets and the
        plan's KV splits."""
        dev, S, bs = self.device, self.tables.shape[0], self.block_size
        q, kn = to_tensor(q, dev), to_tensor(kn, dev)
        R, touched = self.page_sets(ctx)
        rotated = np.stack([np.roll(self.tables, -r * touched, axis=1) for r in range(R)])
        rounds = torch.from_numpy(self._round_inputs(rotated, ctx))
        if dev.type == "cuda":
            rounds = rounds.pin_memory()
        static = rounds[0].to(dev, copy=True)
        tables = dh.ints(rotated, dev)
        qsl, num_seqs = dh.ints(np.arange(S + 1), dev), dh.ints([S], dev)
        metas = [AttentionMetadata(slot_mapping=static[i], block_tables=tables[i % R],
                                   seq_lens=static[self.inner], query_start_loc=qsl,
                                   num_seqs=num_seqs, block_size=bs, decode_only=True,
                                   max_q_len=1)
                 for i in range(self.inner)]

        def steps():
            for meta in metas:
                out = paged_attention_layer(q, self.kv_cache, kn, kn, meta, scale=self.scale,
                                            kv_scales=self.kv_scales)
            return out

        out = steps()
        result: Dict[str, Any] = dict(page_sets=R, splits=self.splits(q, metas[0]))
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for o in range(1, self.outer + 1):
                static.copy_(rounds[o])
                out = steps()
            result.update(out=out, host_s=time.perf_counter() - t0)
            return result
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        # The capture launches nothing; each replay counts its kernels.
        with cuda_lib.recording_launches() as launches, torch.cuda.graph(graph):
            out = steps()
        events = []
        for o in range(1, self.outer + 1):
            static.copy_(rounds[o], non_blocking=True)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            cuda_lib.count_replay(launches)
            events.append((start, end))
        torch.cuda.synchronize(dev)
        result.update(out=out.clone(), replay_ms=[s.elapsed_time(e) for s, e in events])
        del graph
        return result

    def splits(self, q: torch.Tensor, meta: AttentionMetadata) -> Optional[int]:
        """The KV splits the card's plan takes for a step (None on the CPU,
        whose plain version does not split)."""
        if not q.is_cuda:
            return None
        hq, hk, _ = self.heads
        kind = None if self.kind == "bf16" else CACHE_DTYPES[self.kind]
        if pa.decode_route(hq, hk) == "fused":
            return pa.fused_splits_for(q, meta, hk, kind)
        return pa.rpa_plan_for(q, meta, hk, kind).splits

    @torch.inference_mode()
    def plain_check(self, kv_len: int, q: torch.Tensor, kn: torch.Tensor,
                    seqs: int) -> Dict[str, Any]:
        """One step on the first ``seqs`` sequences, their new token at
        position ``kv_len``, against the plain version on the same pages:
        the route's step writes and attends, its rows are kept, then the
        plain version writes the same slots and attends. The output within
        ``PLAIN_TOL`` of the largest |want| (:func:`compare`, also on the
        planted faults, which it must reject); the rows and an INT8 cache's
        scales compared byte for byte (INT8 rows by their largest step);
        the plan's ``splits``."""
        _, meta = dh.decode_step_inputs(self.tables[:seqs], kv_len, self.block_size, self.device)
        q, kn = q[:seqs], kn[:seqs]
        slots = meta.slot_mapping.long()
        rows = self.kv_cache.view(-1, self.kv_cache.shape[2])
        scales = None if self.kv_scales is None else self.kv_scales.view(-1, 2)
        got = paged_attention_layer(q, self.kv_cache, kn, kn, meta, scale=self.scale,
                                    kv_scales=self.kv_scales)
        got_rows = rows[slots].clone()
        got_scales = None if scales is None else scales[slots].clone()
        want = pa.fused_decode_attention_plain(q, self.kv_cache, kn, kn, meta, scale=self.scale,
                                               kv_scales=self.kv_scales)
        want_rows = rows[slots]
        short = dataclasses.replace(meta, seq_lens=(meta.seq_lens * FAULT_KEPT).int())
        dropped = pa.ragged_paged_attention_paged_plain(q, self.kv_cache, short, scale=self.scale,
                                                        kv_scales=self.kv_scales)
        report = dict(seqs=seqs, ctx=kv_len, splits=self.splits(q, meta), **compare(got, want))
        planted = {"scaled": compare(got.float() * FAULT_SCALE, want),
                   "keys_dropped": compare(got, dropped)}
        report["planted_errs"] = {k: v["max_abs_err"] for k, v in planted.items()}
        report["faults_caught"] = not any(v["within_tol"] for v in planted.values())
        if self.kind == "int8":
            report["rows_max_step"] = int((got_rows.int() - want_rows.int()).abs().max())
            report["scales_equal"] = bool(torch.equal(got_scales, scales[slots]))
        else:
            report["rows_equal"] = bool(torch.equal(got_rows.view(torch.uint8),
                                                    want_rows.view(torch.uint8)))
        return report


def compare(got: torch.Tensor, want: torch.Tensor) -> Dict[str, Any]:
    """``max_abs_err`` of ``got`` against ``want``, the limit ``tol`` (``PLAIN_TOL``
    times the largest |want|) and whether the error is within it."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    tol = PLAIN_TOL * float(want.abs().max())
    return dict(max_abs_err=err, tol=tol, within_tol=err <= tol)


def parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cpu", action="store_true",
                        help="the plain versions on the CPU at the JAX tool's --cpu sizes")
    parser.add_argument("--seqs", type=int, default=64)
    parser.add_argument("--block-size", type=int, default=32)
    parser.add_argument("--max-ctx", type=int, default=32768)
    parser.add_argument("--ctxs", type=int, nargs="*", default=[512, 2048, 8192, 32640])
    parser.add_argument("--inner-steps", type=int, default=8)
    parser.add_argument("--outer-steps", type=int, default=8)
    parser.add_argument("--heads", type=int, nargs=3, metavar=("HQ", "HK", "D"), default=None,
                        help="override (num_q_heads, num_kv_heads, head_dim); a group past "
                             "16 takes the write and the ragged kernel")
    parser.add_argument("--fp8", action="store_true", help="an e4m3 KV cache (kernel E)")
    parser.add_argument("--int8", action="store_true",
                        help="an INT8 KV cache with per-(slot, K/V) scales (kernel D)")
    parser.add_argument("--contiguous", action="store_true",
                        help="each sequence's pages in order; default a random permutation")
    args = parser.parse_args(argv)
    if args.fp8 and args.int8:
        parser.error("--fp8 and --int8 exclude each other")
    if args.cpu:
        args.seqs, args.max_ctx, ctxs, steps = CPU_SIZES
        args.ctxs = list(ctxs)
        args.inner_steps = args.outer_steps = steps
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    on_card = dev.type == "cuda"
    card = roofline.card_line() if on_card else "cpu"
    print(card, flush=True)
    kind = "int8" if args.int8 else "e4m3" if args.fp8 else "bf16"
    heads = tuple(args.heads) if args.heads else CARD_HEADS if on_card else CPU_HEADS
    hq, hk, d = heads
    S, bs = args.seqs, args.block_size
    row = 2 * hk * d
    num_blocks, tables = page_tables(S, args.max_ctx // bs + 1, args.contiguous,
                                     np.random.default_rng(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    kv0, sc0 = draw_pool(kind, num_blocks, bs, row, gen)
    bench = AttnBench(kv0, sc0, tables, device=dev, block_size=bs, heads=heads,
                      inner=args.inner_steps, outer=args.outer_steps)
    route = pa.decode_route(hq, hk) if on_card else "plain"
    results: List[Dict[str, Any]] = []
    for ctx in args.ctxs:
        q = torch.randn((S, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kn = torch.randn((S, hk, d), generator=gen, device=dev).to(torch.bfloat16)
        run = bench.run(ctx, q, kn)
        n = args.inner_steps * args.outer_steps
        step_ms = (sum(run["replay_ms"]) if on_card else run["host_s"] * 1e3) / n
        nbytes = kv_bytes(S, ctx, row, kind)
        bound_ms, bound_by = step_bound(
            S, [ctx + o for o in range(1, args.outer_steps + 1)], heads, kind)
        gbps = nbytes / step_ms / 1e6 if on_card else None
        results.append({
            "ctx": ctx,
            "step_ms": round(step_ms, 5),
            "kv_gb_per_s": None if gbps is None else round(gbps, 1),
            "pct_hbm_peak": None if gbps is None else round(100 * gbps * 1e9
                                                            / roofline.PEAK_BYTES_PER_S, 1),
            "kv_bytes": nbytes,
            "bound_ms": round(bound_ms, 5),
            "bound_by": bound_by,
            "pct_of_bound": round(100 * bound_ms / step_ms, 1) if on_card else None,
            "route": route,
            "splits": run["splits"],
            "page_sets": run["page_sets"],
            "cache": kind,
            "tables": "contiguous" if args.contiguous else "permuted",
            "device": dh.device_name(dev),
        })
        print(json.dumps(results[-1]), flush=True)
    last = args.ctxs[-1] + args.outer_steps
    report = {"metric": "attn_kernel_bandwidth", "results": results,
              "plain_check": bench.plain_check(last + 1, q, kn, S),
              "merge_check": bench.plain_check(last + 2, q, kn, min(CHECK_SEQS, S)),
              "card": card}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
