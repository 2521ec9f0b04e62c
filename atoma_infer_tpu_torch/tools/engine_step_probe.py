"""The decode step's device cost, set against the engine's host overhead.

Counterpart of ``tools/engine_step_probe.py``. Builds the program the serving
engine runs for a 256-sequence decode step (``engine/worker.py``
``ModelWorker._invoke``: the packed metadata's one host→device copy, the
forward, the sampler and async scheduling's device-token feed, each step
reading the previous step's tokens) at Llama-3.2-1B's widths with random
bf16 weights, and times it:

  (a) chained dispatch: ``--steps`` steps, each fed the last one's tokens,
      and one synchronisation at the end;
  (b) fetch every step: each step's tokens and logprobs packed into one
      int32 buffer (``_pack_outputs``, inside the step) copied to pinned
      host memory without blocking and waited for, as ``PendingStep``
      does;
  (c) on the card, the decode step's CUDA graph replayed alone at each of
      (b)'s inputs (the same steps dispatched again, their tokens equal),
      timed with CUDA events behind a spin on the device long enough that
      the graph is launched before the first event: the device's cost of a
      step at (b)'s context lengths. The device's idle share is
      1 − (c) ÷ (b); the eager run, whose (b) steps are the same, is set
      against the same (c). Each replay inside (b) is also timed with CUDA
      events (``replay_in_b_ms``): there the device is idle when the step is
      dispatched, so this time also holds the graph's launch.

On the card (a) and (b) run twice: with the worker's CUDA graphs, its
default there (the first step eager, then the capture: its seconds are the
``first_step_s``, where the JAX tool reports its compile), and eagerly with
graphs off; the two runs' tokens must be equal. ``--cpu`` runs the JAX
tool's tiny configuration eagerly through the plain versions (at most 32
sequences and 8 steps), on the host's clock.

Usage:
    python -m atoma_infer_tpu_torch.tools.engine_step_probe          # the card
    python -m atoma_infer_tpu_torch.tools.engine_step_probe --cpu    # tiny, plain versions
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import CacheConfig, SchedulerConfig
from ..engine.cache_engine import CacheEngine
from ..engine.input_prep import ModelInput
from ..engine.sampler import SamplingTensors
from ..engine.worker import ModelWorker, _to_host
from ..models.llama import Llama, LlamaConfig
from ..sampling_params import NextTokenChooserParameters
from ..utils.device import resolve_device
from . import decode_harness as dh
from . import roofline

BLOCK_SIZE = 32
CTX = 64
CPU_LIMITS = (32, 8)  # (seqs, steps) at most on the CPU, as the JAX tool's
# (c)'s spin before each replay: about 2 ms at the H100's 1.98 GHz, longer
# than a decode graph's launch on the host.
LEAD_CYCLES = 4_000_000


def llama_config(on_card: bool) -> LlamaConfig:
    """Llama-3.2-1B's widths on the card, the JAX tool's tiny model on the
    CPU."""
    if on_card:
        return LlamaConfig(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192,
            num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8, head_dim=64,
            max_position_embeddings=4096, tie_word_embeddings=True,
        )
    return LlamaConfig(
        vocab_size=2048, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
        num_attention_heads=8, num_key_value_heads=4, head_dim=32,
        max_position_embeddings=2048, tie_word_embeddings=True,
    )


def sizes(seqs: int, steps: int):
    """(total positions, pages a sequence, pages in the pool): the first
    step, then (a)'s and (b)'s steps after ``CTX`` positions."""
    total = CTX + 2 * steps + 2
    pages_per_seq = -(-total // BLOCK_SIZE)
    return total, pages_per_seq, seqs * pages_per_seq + 16


def build_worker(model, params, *, seqs: int, steps: int, cuda_graphs: bool) -> ModelWorker:
    """The JAX tool's ``CacheConfig``, ``SchedulerConfig`` and pool, sized
    here rather than by ``LlmService``'s profile: the worker and its own
    ``CacheEngine`` on the model's device."""
    cfg = model.config
    total, _, num_blocks = sizes(seqs, steps)
    cache_cfg = CacheConfig(block_size=BLOCK_SIZE, num_device_blocks_override=num_blocks,
                            num_host_blocks_override=8)
    sched_cfg = SchedulerConfig(max_num_batched_tokens=max(seqs * CTX, total + 1),
                                max_num_sequences=seqs, max_model_len=total + 1)
    cache_engine = CacheEngine(
        num_layers=cfg.num_hidden_layers, num_kv_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, block_size=BLOCK_SIZE, num_device_blocks=num_blocks,
        num_host_blocks=8, dtype=model.dtype, device=model.device,
    )
    return ModelWorker(model, params, cache_engine, sched_cfg, cache_cfg,
                       cuda_graphs=cuda_graphs)


def page_tables(worker: ModelWorker, seqs: int, steps: int) -> np.ndarray:
    """[seqs, P] tables of random distinct pages (the JAX tool's draw)."""
    _, pages_per_seq, num_blocks = sizes(seqs, steps)
    rng = np.random.default_rng(0)
    P = worker.max_pages_per_seq
    tables = np.zeros((seqs, P), dtype=np.int32)
    perm = (rng.permutation(num_blocks - 1)[: seqs * pages_per_seq] + 1).reshape(
        seqs, pages_per_seq)
    tables[:, : min(P, pages_per_seq)] = perm[:, :P]
    return tables


def probe(worker: ModelWorker, *, seqs: int, steps: int) -> Dict[str, Any]:
    """The first step, then (a), (b) and on a worker with graphs (c).
    Returns the figures and ``tokens`` [1 + 2·steps, seqs], every step's
    sampled tokens (each one's device copy taken as it is dispatched, since
    a replay's outputs are its graph's static tensors)."""
    S, dev = seqs, worker.device
    tables = page_tables(worker, seqs, steps)
    P = tables.shape[1]
    sampling = SamplingTensors.build([NextTokenChooserParameters()] * S, [[0]] * S, S, [0] * S)
    sample_mask = np.ones(S, bool)
    sampling_arrays = sampling.to_device(dev, sample_mask)
    zero_steps = np.zeros(S, dtype=np.int32)
    prev_map = np.arange(S, dtype=np.int32)

    def model_input_for(i: int) -> ModelInput:
        kv_len = CTX + i
        page = tables[np.arange(S), (kv_len // BLOCK_SIZE) % P]
        return ModelInput(
            token_ids=np.zeros(S, np.int32),  # the feed overrides them
            positions=np.full(S, kv_len, np.int32),
            slot_mapping=(page * BLOCK_SIZE + kv_len % BLOCK_SIZE).astype(np.int32),
            block_tables=tables,
            seq_lens=np.full(S, kv_len + 1, np.int32),
            query_start_loc=np.arange(S + 1, dtype=np.int32),
            num_seqs=np.asarray(S, dtype=np.int32),
            selected_token_indices=np.arange(S, dtype=np.int32),
            sample_mask=sample_mask,
            seq_ids=list(range(S)),
            num_prefills=0,
            max_q_len=1,
        )

    trail = []

    def dispatch(i, prev_tokens):
        toks, _, packed, _ = worker._invoke(model_input_for(i), sampling_arrays, zero_steps,
                                            sampling, (prev_tokens, prev_map))
        trail.append(toks.clone())
        return toks, packed

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        t0 = time.perf_counter()
        toks, _ = dispatch(0, torch.zeros(S, dtype=torch.int32, device=dev))
        toks.cpu()
        first_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for i in range(1, 1 + steps):
            toks, _ = dispatch(i, toks)
        toks.cpu()
        chained_ms = (time.perf_counter() - t0) / steps * 1e3

        with timing_replays(worker.graphs) as in_b:
            t0 = time.perf_counter()
            for i in range(1, 1 + steps):
                toks, packed = dispatch(steps + i, toks)
                host, event = _to_host(packed)
                if event is not None:
                    event.synchronize()
            fetch_ms = (time.perf_counter() - t0) / steps * 1e3
        tokens = torch.stack(trail).cpu().numpy()

        alone, replay_tokens_equal = [], None
        if worker.graphs is not None:
            with timing_replays(worker.graphs, LEAD_CYCLES) as alone:
                again = [worker._invoke(model_input_for(steps + i), sampling_arrays, zero_steps,
                                        sampling, (trail[steps + i - 1], prev_map))[0].clone()
                         for i in range(1, 1 + steps)]
            replay_tokens_equal = bool(torch.equal(torch.stack(again),
                                                   torch.stack(trail[steps + 1:])))
        sync()
    return {
        "first_step_s": round(first_s, 3),
        "chained_ms": round(chained_ms, 3),
        "fetch_every_step_ms": round(fetch_ms, 3),
        "replay_ms": mean_ms(alone),
        "replays_timed": len(alone),
        "replay_tokens_equal": replay_tokens_equal,
        "replay_in_b_ms": mean_ms(in_b),
        "graphs": worker.graphs is not None,
        "tokens": tokens,
    }


@contextlib.contextmanager
def timing_replays(graphs, lead_cycles: int = 0):
    """While open, each replay of ``graphs`` (a worker's ``StepGraphs``, or
    None) between two CUDA events, after a spin of ``lead_cycles`` on the
    device where given; yields the [(start, end)] pairs."""
    events = []
    if graphs is None:
        yield events
        return
    replay = graphs._replay

    def timed(entry):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        start.record()
        replay(entry)
        end.record()
        events.append((start, end))

    graphs._replay = timed
    try:
        yield events
    finally:
        del graphs._replay


def mean_ms(events) -> Optional[float]:
    """The mean ms between each (start, end) pair, None for none."""
    if not events:
        return None
    return round(sum(s.elapsed_time(e) for s, e in events) / len(events), 3)


def idle_share(replay_ms: Optional[float], step_ms: float) -> Optional[float]:
    """1 − the device's cost of a step ÷ the step's period."""
    return None if replay_ms is None else round(1 - replay_ms / step_ms, 4)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cpu", action="store_true",
                        help="the JAX tool's tiny model on the CPU, plain versions")
    parser.add_argument("--seqs", type=int, default=256)
    parser.add_argument("--steps", type=int, default=64)
    args = parser.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    on_card = dev.type == "cuda"
    card = roofline.card_line() if on_card else "cpu"
    print(card, flush=True)
    if not on_card:
        args.seqs, args.steps = min(args.seqs, CPU_LIMITS[0]), min(args.steps, CPU_LIMITS[1])
    model = Llama(llama_config(on_card), dtype=torch.bfloat16 if on_card else torch.float32,
                  device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    runs = {}
    # Eager first on the card, then with graphs (the worker's default there);
    # each run on a pool of its own, zeroed, so both compute the same steps.
    for mode, graphs in (("eager", False), ("graphs", True))[: 2 if on_card else 1]:
        worker = build_worker(model, params, seqs=args.seqs, steps=args.steps,
                              cuda_graphs=graphs)
        run = probe(worker, seqs=args.seqs, steps=args.steps)
        del worker
        runs[mode] = run
        print(f"{mode}: first step {run['first_step_s']:.3f} s; (a) chained dispatch, final "
              f"fetch {run['chained_ms']:.3f} ms/step; (b) packed fetch every step "
              f"{run['fetch_every_step_ms']:.3f} ms/step", flush=True)
    replay_ms = runs["graphs"]["replay_ms"] if on_card else None
    if replay_ms is not None:
        graphs = runs["graphs"]
        print(f"(c) decode graph replayed alone at (b)'s inputs: {replay_ms:.3f} ms over "
              f"{graphs['replays_timed']} (tokens equal: {graphs['replay_tokens_equal']}); "
              f"inside (b), its launch included: {graphs['replay_in_b_ms']:.3f} ms", flush=True)
    tokens = {mode: run.pop("tokens") for mode, run in runs.items()}
    for run in runs.values():
        run["idle_share"] = idle_share(replay_ms, run["fetch_every_step_ms"])
    report = {
        "metric": "engine_step_probe",
        "seqs": args.seqs,
        "steps": args.steps,
        "runs": runs,
        "tokens_equal": (bool(np.array_equal(tokens["eager"], tokens["graphs"]))
                         if on_card else None),
        "device": dh.device_name(dev),
        "card": card,
    }
    print(json.dumps(report), flush=True)
    report["tokens"] = tokens
    return report


if __name__ == "__main__":
    main()
